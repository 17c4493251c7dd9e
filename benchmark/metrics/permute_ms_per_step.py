"""Device ms a step in the dropless dispatch around the grouped expert
products: the sort by expert, the index computation and the gather of
the rows (``workload.permute``), and the gate scaling and scatter-add
back to the tokens (``workload.unpermute``), self time with the backward
halves, from the port's span table of the traced capture
(``progspans.py``)."""

from benchmark import progspans

SPANS = ("permute", "unpermute")


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"), SPANS)
