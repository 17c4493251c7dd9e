"""The work of a hybrid model's attention calls (MiMo-V2-Flash: full
grouped-query layers beside sliding-window layers), each kind at its own
query-key pairs and kv heads, at the true widths, which the hybrid
rooflines and ``swa_roofline`` read.

A full call attends the causal pairs S(S+1)/2, a window call the pairs
of each query's last W keys (:func:`window_pairs`); counted at the
causal pairs, a window call's least time would be S/(2W) times its own,
and its share far over 100 %. The forward is two products (scores at
the q·k width, probs·V at the v width), the backward five (scores again,
dQ and dK at the q·k width; dP and dV at the v width). Each input is
read once and each output written once: q, O, dO and dQ at H heads, k,
v, dK and dV at the kind's kv heads; the float32 log-sum-exp and Δ a row.
The kernels' padding of v and dO to the q·k width counts as time, not
as work; the sinks' [H] logits count as nothing.

The calls of each kind and their device time come from the port's span
table (``progspans.py``): ``attn_core`` around the full layers' calls and
``swa_core`` around the window layers', each with its ``.bwd`` half.
"""

from __future__ import annotations

from benchmark import roofline
from benchmark.flops import causal_pairs

#: The port's span of each kind of call.
SPANS = {"full": "attn_core", "swa": "swa_core"}


def window_pairs(seq: int, window: int) -> int:
    """Query-key pairs of causal attention over ``seq`` positions where
    each query sees its last ``window`` keys: Σ_i min(i + 1, W)."""
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def kinds(rec: dict) -> dict | None:
    """kind → (B, H, KV, S, Dqk, Dv, pairs) of one call of each kind of a
    traced record of a MiMo-V2 configuration, from its ``config``,
    ``micro_batch`` and ``seq``; None for any other record."""
    config = rec.get("config") or {}
    if config.get("family") != "mimo_v2":
        return None
    B, S = rec["micro_batch"], rec["seq"]
    H, Dqk, Dv = (config["num_attention_heads"], config["head_dim"],
                  config["v_head_dim"])
    return {
        "full": (B, H, config["num_key_value_heads"], S, Dqk, Dv,
                 causal_pairs(S)),
        "swa": (B, H, config["swa_num_key_value_heads"], S, Dqk, Dv,
                window_pairs(S, config["sliding_window"])),
    }


def fwd_work(B, H, KV, S, Dqk, Dv, pairs, elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward over ``pairs`` query-key pairs: q, k,
    v read; O and the log-sum-exp written."""
    flops = 2 * B * H * pairs * (Dqk + Dv)
    nbytes = elem * B * S * (H * (Dqk + Dv) + KV * (Dqk + Dv)) + 4 * B * H * S
    return float(flops), float(nbytes)


def bwd_work(B, H, KV, S, Dqk, Dv, pairs, elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward over ``pairs`` pairs: q, k, v, O, dO,
    the log-sum-exp and Δ read; dQ, dK, dV written."""
    flops = 2 * B * H * pairs * (3 * Dqk + 2 * Dv)
    nbytes = elem * B * S * (H * (2 * Dqk + 2 * Dv) + 2 * KV * (Dqk + Dv))
    return float(flops), float(nbytes + 2 * 4 * B * H * S)


def _least(rec: dict, kind: str, direction: str) -> float:
    work = (fwd_work if direction == "fwd" else bwd_work)(*kinds(rec)[kind])
    return roofline.least_seconds(work, rec["peak_flops"], rec["peak_bytes"])


def _table(rec: dict) -> dict | None:
    trace = rec.get("trace")
    if not trace or not rec.get("peak_flops") or kinds(rec) is None:
        return None
    program = trace.get("program")
    return program["spans"] if program else None


def _calls(table: dict, kind: str, direction: str) -> int:
    name = SPANS[kind] + ("" if direction == "fwd" else ".bwd")
    return table.get(name, {}).get("calls", 0)


def share(rec: dict, direction: str) -> float | None:
    """Every traced attention call's least time, each kind at its own
    pairs and kv heads, over the device time of what the benchmark's
    ``bench.attn_<direction>`` spans launched, in %; None without a
    trace, a peak, the span table or a MiMo-V2 configuration, or when the
    span table's calls of the two kinds do not add up to the benchmark's
    own count."""
    table = _table(rec)
    if table is None:
        return None
    attn = rec["trace"]["attention"][direction]
    calls = {kind: _calls(table, kind, direction) for kind in SPANS}
    if not attn["seconds"] or sum(calls.values()) != attn["calls"]:
        return None
    least = sum(n * _least(rec, kind, direction) for kind, n in calls.items())
    return 100.0 * least / attn["seconds"]


def swa_share(rec: dict) -> float | None:
    """The window calls' least time, forwards and backwards, over the
    device time of what ``swa_core`` and ``swa_core.bwd`` launched, in %;
    None where they did not run."""
    table = _table(rec)
    if table is None:
        return None
    least, seconds = 0.0, 0.0
    for direction, name in (("fwd", "swa_core"), ("bwd", "swa_core.bwd")):
        least += _calls(table, "swa", direction) * _least(rec, "swa", direction)
        seconds += table.get(name, {}).get("device_s", 0.0)
    if not seconds:
        return None
    return 100.0 * least / seconds
