"""The least time of the traced latent-attention backwards (``mla_work.py``:
the five products at their true widths over the causal pairs, inputs read
and outputs written once) over the device time of every kernel the
``bench.attn_bwd`` spans launched (Δ pre-pass, the padding, dQ, dK/dV),
in %."""

from benchmark import mla_work


def read(rec):
    return mla_work.share(rec, "bwd")
