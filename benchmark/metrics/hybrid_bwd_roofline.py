"""The least time of every traced attention backward of a hybrid model
(``hybrid_work.py``: five products a call, each kind at its own pairs and
kv heads) over the device time of every kernel the ``bench.attn_bwd``
spans launched (Δ pre-pass, the padding, the sinks' gradient, dQ,
dK/dV), in %."""

from benchmark import hybrid_work


def read(rec):
    return hybrid_work.share(rec, "bwd")
