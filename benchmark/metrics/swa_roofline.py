"""The least time of the traced sliding-window calls (``hybrid_work.py``:
the products over each query's last W keys at the true widths, the kv
heads of the window layers, inputs read and outputs written once), the
forwards and backwards, over the device time of what ``workload.swa_core``
and its backward half launched, in %."""

from benchmark import hybrid_work


def read(rec):
    return hybrid_work.swa_share(rec)
