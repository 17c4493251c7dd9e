"""Device ms a step in the sliding-window layers' attention calls
(``workload.swa_core``: the flash kernels under the window and their
sinks, the padding and the Δ pre-pass), self time with the backward
halves, from the port's span table of the traced capture
(``progspans.py``)."""

from benchmark import progspans

SPANS = ("swa_core",)


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"), SPANS)
