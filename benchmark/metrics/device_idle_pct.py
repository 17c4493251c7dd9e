"""1 − (union of device activity) / traced span, in %."""


def read(rec):
    trace = rec["trace"]
    if not trace or not trace["window_s"] or not trace["kernels"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
