"""Device ms a step in the casts of the float32 master weights to the
products' type (``workload.cast``), self time with the backward halves,
from the port's span table of the traced capture (``progspans.py``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 progspans.METRICS["cast_ms_per_step"])
