"""The work of a latent-attention call (DeepSeek-V2's MLA) at its true
widths, which the MLA rooflines read.

A call attends q and k of the q·k width (nope + rope columns) and v of
the narrower v width over the causal query-key pairs S(S+1)/2; the port
pads v and dO to the q·k width for its kernels, and that padding counts
here as time, not as work. The forward is two products (scores at the
q·k width, probs·V at the v width); the backward five (scores again and
dQ, dK at the q·k width; dP = dO·Vᵀ and dV at the v width). Each input
is read once and each output written once: q, k, dQ, dK at the q·k
width; v, O, dO, dV at the v width; the float32 log-sum-exp and Δ a row.
"""

from __future__ import annotations

from benchmark import roofline
from benchmark.flops import causal_pairs


def shape(rec: dict) -> dict | None:
    """(B, H, S, Dqk, Dv) of one attention call of a traced record of a
    DeepSeek-V2 configuration, from its ``config``, ``micro_batch`` and
    ``seq``; None for any other record."""
    config = rec.get("config") or {}
    if config.get("family") != "deepseek_v2":
        return None
    return {"B": rec["micro_batch"], "H": config["num_attention_heads"],
            "S": rec["seq"],
            "Dqk": config["qk_nope_head_dim"] + config["qk_rope_head_dim"],
            "Dv": config["v_head_dim"]}


def fwd_work(B, H, S, Dqk, Dv, elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal forward: q, k, v read; O and the
    log-sum-exp written."""
    flops = 2 * B * H * causal_pairs(S) * (Dqk + Dv)
    nbytes = elem * B * S * H * (2 * Dqk + 2 * Dv) + 4 * B * H * S
    return float(flops), float(nbytes)


def bwd_work(B, H, S, Dqk, Dv, elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal backward: q, k, v, O, dO, the
    log-sum-exp and Δ read; dQ, dK, dV written."""
    flops = 2 * B * H * causal_pairs(S) * (3 * Dqk + 2 * Dv)
    nbytes = elem * B * S * H * (4 * Dqk + 4 * Dv) + 2 * 4 * B * H * S
    return float(flops), float(nbytes)


def share(rec: dict, direction: str) -> float | None:
    """The traced attention calls' least time (at the card's peaks) over
    the device time of what the benchmark's ``bench.attn_<direction>``
    spans launched, in %; None without a trace, a peak, the calls or a
    DeepSeek-V2 configuration."""
    trace, dims = rec.get("trace"), shape(rec)
    if not trace or not rec.get("peak_flops") or dims is None:
        return None
    attn = trace["attention"][direction]
    if not attn["calls"] or not attn["seconds"]:
        return None
    work = (fwd_work if direction == "fwd" else bwd_work)(**dims)
    least = attn["calls"] * roofline.least_seconds(work, rec["peak_flops"],
                                                   rec["peak_bytes"])
    return 100.0 * least / attn["seconds"]
