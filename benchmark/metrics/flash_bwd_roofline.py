"""The least time of the traced attention backwards (``roofline.py``: the
five products over the causal pairs, inputs read and outputs written
once) over the device time of every kernel the backward spans launch
(Δ pre-pass, dQ, dK/dV), in %."""

from benchmark import roofline


def read(rec):
    return roofline.share(rec, "bwd", roofline.attn_bwd_work)
