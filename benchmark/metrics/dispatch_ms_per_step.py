"""Device ms a step in the MoE dispatch of tokens to the expert slots
and the combine of their outputs (``workload.dispatch``,
``workload.combine``), self time with the backward halves, from the
port's span table of the traced capture (``progspans.py``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 progspans.METRICS["dispatch_ms_per_step"])
