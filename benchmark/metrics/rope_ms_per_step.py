"""Device ms a step in the rotary embedding of q and k
(``workload.rope``), self time with the backward halves, from the port's
span table of the traced capture (``progspans.py``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 progspans.METRICS["rope_ms_per_step"])
