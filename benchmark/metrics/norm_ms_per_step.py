"""Device ms a step in every RMSNorm (``workload.norm``: the attention,
MLP and final norms, remat's recomputes among them), self time with the
backward halves, from the port's span table of the traced capture
(``progspans.py``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 progspans.METRICS["norm_ms_per_step"])
