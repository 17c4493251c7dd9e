"""Device ms a step in the loss: the unembedding and the cross-entropy
(``workload.loss``), self time with the backward halves, from the port's
span table of the traced capture (``progspans.py``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 progspans.METRICS["loss_ms_per_step"])
