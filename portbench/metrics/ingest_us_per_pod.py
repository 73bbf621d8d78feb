"""ingest_us_per_pod (us): the host seconds of the window's store
mutations (each iteration's completions through `Cluster.remove_pod` and
its arrivals built and added through `Cluster.add_pod`, one clock span an
iteration), over the pods that arrived in the window."""


def read(record):
    if record.ingest_pods == 0:
        return None
    return record.ingest_s / record.ingest_pods * 1e6
