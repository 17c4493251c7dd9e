"""The least time of the traced latent-attention forwards (``mla_work.py``:
scores at the q·k width and probs·V at the v width over the causal pairs,
inputs read and outputs written once, at the true widths) over the device
time of what the ``bench.attn_fwd`` spans launched, in %. Remat's
recomputed forwards are calls too."""

from benchmark import mla_work


def read(rec):
    return mla_work.share(rec, "fwd")
