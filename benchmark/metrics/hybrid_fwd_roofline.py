"""The least time of every traced attention forward of a hybrid model
(``hybrid_work.py``: the full layers' calls over the causal pairs, the
window layers' over their windowed pairs, each at its kv heads and the
true widths) over the device time of what the ``bench.attn_fwd`` spans
launched, in %. Remat's recomputed forwards are calls too."""

from benchmark import hybrid_work


def read(rec):
    return hybrid_work.share(rec, "fwd")
