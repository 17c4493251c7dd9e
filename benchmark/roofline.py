"""Peaks of the card and the least time of an attention call.

Peaks are NVIDIA's H100 data sheet's dense bf16 rates and HBM bandwidths
(SXM 989 TFLOP/s and 3.35 TB/s, PCIe 756 TFLOP/s and 2.0 TB/s), keyed on
``torch.cuda.get_device_name()``; any other device has none.

An attention call's work is what its inputs need: the causal query-key
pairs S(S+1)/2, each input byte read once and each output byte written
once, whatever the kernels read again or recompute. The forward is two
products (scores, probs·V); the backward five (scores again, dP, dV, dQ,
dK), however many kernels compute them.
"""

from __future__ import annotations

from benchmark.flops import causal_pairs

#: Device-name substring → peak dense bf16 FLOP/s; first match wins.
PEAK_BF16_FLOPS: dict[str, float] = {
    "H100 PCIe": 756e12,
    "H100 SXM": 989e12,
    "H100 80GB HBM3": 989e12,
}

#: The same keys → HBM bytes/s.
PEAK_HBM_BYTES: dict[str, float] = {
    "H100 PCIe": 2.0e12,
    "H100 SXM": 3.35e12,
    "H100 80GB HBM3": 3.35e12,
}


def peak(table: dict[str, float], device_name: str) -> float | None:
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def _tensors(B, H, KV, S, D):
    q = B * S * H * D
    kv = B * S * KV * D
    return q, kv


def attn_fwd_work(B, H, KV, S, D, elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal forward: q, k, v read; out and the
    float32 log-sum-exp written."""
    q, kv = _tensors(B, H, KV, S, D)
    flops = 2 * 2 * B * H * D * causal_pairs(S)
    nbytes = elem * (q + 2 * kv + q) + 4 * B * H * S
    return float(flops), float(nbytes)


def attn_bwd_work(B, H, KV, S, D, elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal backward: q, k, v, out, dout and the
    log-sum-exp read; dq, dk, dv written."""
    q, kv = _tensors(B, H, KV, S, D)
    flops = 5 * 2 * B * H * D * causal_pairs(S)
    nbytes = elem * (q + 2 * kv + q + q) + 4 * B * H * S + elem * (q + 2 * kv)
    return float(flops), float(nbytes)


def least_seconds(work: tuple[float, float], peak_flops: float,
                  peak_bytes: float) -> float:
    """The roofline: the larger of operations over peak FLOP/s and bytes
    over peak bytes/s."""
    flops, nbytes = work
    return max(flops / peak_flops, nbytes / peak_bytes)


def share(rec: dict, direction: str, work_of) -> float | None:
    """A traced run's roofline share of attention in ``direction``
    ("fwd" or "bwd"), in %: the calls' least time over the device time of
    what they launched. None when nothing was traced, no peak is known or
    the family has no such attention shape."""
    trace, shape = rec["trace"], rec["attn_shape"]
    if not trace or not rec["peak_flops"] or shape is None:
        return None
    attn = trace["attention"][direction]
    if not attn["calls"] or not attn["seconds"]:
        return None
    work = work_of(shape["B"], shape["H"], shape["KV"], shape["S"], shape["D"])
    least = attn["calls"] * least_seconds(work, rec["peak_flops"], rec["peak_bytes"])
    return 100.0 * least / attn["seconds"]
