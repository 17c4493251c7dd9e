"""The least time of the traced attention forwards (``roofline.py``: two
products over the causal pairs, inputs read and outputs written once)
over their device time, in %. Remat's recomputed forwards are calls too."""

from benchmark import roofline


def read(rec):
    return roofline.share(rec, "fwd", roofline.attn_fwd_work)
