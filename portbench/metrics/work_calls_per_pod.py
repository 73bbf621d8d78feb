"""work_calls_per_pod (calls/pod): the host calls that put work on the
card (the CUDA runtime's and driver's launch, copy and fill calls, as
`torch.profiler` records them) in the traced iteration, over the pods its
cycle bound."""


def read(record):
    prof = record.profile
    if not prof or not prof["pods"]:
        return None
    return prof["work_calls"] / prof["pods"]
