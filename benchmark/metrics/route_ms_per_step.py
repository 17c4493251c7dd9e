"""Device ms a step in the MoE router: its product, softmax, capacity
routing and the load-balancing statistics (``workload.router``), self
time with the backward halves, from the port's span table of the traced
capture (``progspans.py``)."""

from benchmark import progspans


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"),
                                 progspans.METRICS["route_ms_per_step"])
