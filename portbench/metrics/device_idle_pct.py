"""device_idle_pct (%): the share of the traced iteration's wall span
(its ingest through the end of its cycle) in which no kernel, copy or fill
ran on the card, from the union of the profiler's device records."""


def read(record):
    prof = record.profile
    if not prof or prof["window_s"] <= 0 or not prof["device_records"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
