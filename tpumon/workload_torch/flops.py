"""Model-FLOPs accounting → MFU, for the port.

``forward_flops`` and ``train_flops_per_step`` are the reference's
accounting (``tpumon/workload/flops.py``), copied: they count the matmul
FLOPs one optimizer step of ``models.llama`` or ``models.moe`` executes, attention at the
full S×S the additive-mask implementation computes, backward = 2× forward.
A step of any family is 3× its record's forward count (``models.family``):
``forward_flops`` for those two, ``models.deepseek_v2.forward_flops`` (by
the same rules) for DeepSeek-V2, and ``models.mimo_v2.forward_flops`` for
MiMo-V2, whose sliding-window layers count their windowed pairs
(:func:`window_pairs`), which the reference lacks.

The peak table is keyed on ``torch.cuda.get_device_name()`` and holds only
the H100's published dense (no sparsity) bf16 rates and HBM bandwidths,
from NVIDIA's H100 Tensor Core GPU data sheet: SXM 989 TFLOP/s and
3.35 TB/s, PCIe 756 TFLOP/s and 2.0 TB/s. Any other device (the CPU,
other cards) has no peak, and MFU is then None rather than a number
computed against a made-up peak.
"""

from __future__ import annotations

import math

import torch

from tpumon.workload_torch.models import family

#: Device-name substring → peak dense bf16 FLOP/s. The name of an H100
#: SXM part is "NVIDIA H100 80GB HBM3"; a PCIe part says "PCIe". First
#: match wins, so the PCIe row comes first.
PEAK_BF16_FLOPS: dict[str, float] = {
    "H100 PCIe": 756e12,
    "H100 SXM": 989e12,
    "H100 80GB HBM3": 989e12,
}

#: The same keys → HBM bytes/s (the bandwidth side of a kernel's bound).
PEAK_HBM_BYTES: dict[str, float] = {
    "H100 PCIe": 2.0e12,
    "H100 SXM": 3.35e12,
    "H100 80GB HBM3": 3.35e12,
}


def _lookup(table: dict[str, float], device) -> float | None:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, value in table.items():
        if key in name:
            return value
    return None


def peak_flops_per_device(device) -> float | None:
    """Peak dense bf16 FLOP/s of a device, or None when unknown."""
    return _lookup(PEAK_BF16_FLOPS, device)


def peak_hbm_bytes_per_device(device) -> float | None:
    """Peak HBM bytes/s of a device, or None when unknown."""
    return _lookup(PEAK_HBM_BYTES, device)


def window_pairs(seq: int, window: int) -> int:
    """Query-key pairs of causal attention over ``seq`` positions where
    each query sees its last ``window`` keys: Σ_i min(i + 1, W)."""
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def forward_flops(cfg, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward pass of models.llama / models.moe
    (2·m·n·k per matmul as executed: GQA-narrow K/V projections, full-S²
    attention, SwiGLU FFN scaled by top_k routed experts plus the router
    for MoE, unembed). The MoE count is the reference's: it leaves out the
    dispatch and combine products and the capacity padding, which the
    dense-einsum routing executes but a model does not need."""
    B, S = batch, seq
    D = cfg.dim
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F = cfg.ffn_dim
    L = cfg.n_layers
    qkvo = 2 * B * S * D * (H * HD) * 2 + 2 * B * S * D * (KV * HD) * 2
    attn = 2 * B * S * S * H * HD * 2  # scores + probs·V
    n_experts_active = getattr(cfg, "top_k", None)
    if n_experts_active is not None:  # MoE: routed SwiGLU + router
        ffn = 6 * B * S * D * F * n_experts_active
        ffn += 2 * B * S * D * cfg.n_experts  # router logits
    else:
        ffn = 6 * B * S * D * F
    unembed = 2 * B * S * D * cfg.vocab
    return float(L * (qkvo + attn + ffn) + unembed)


def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """One optimizer step: forward + backward (2× forward) = 3× the
    forward of ``cfg``'s family."""
    return 3.0 * family.of(cfg).forward_flops(cfg, batch, seq)


def peak_flops_total(devices) -> float | None:
    """Summed peak of the distinct cards in ``devices``: one device, or
    the cards of a mesh's ranks as devices or (host, device) pairs
    (``parallel.mesh.rank_cards``). Ranks that share a card share its
    peak; card 0 of two hosts is two cards. None when any peak is
    unknown."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    distinct = set()
    for item in devices:
        host, device = item if isinstance(item, tuple) else (0, item)
        device = torch.device(device)
        if device.type == "cuda":
            device = torch.device("cuda", device.index or 0)
        distinct.add((host, device))
    peaks = [peak_flops_per_device(device) for _, device in distinct]
    if not peaks or any(p is None for p in peaks):
        return None
    return float(sum(peaks))


def mfu(cfg, batch: int, seq: int, steps_per_sec: float, devices) -> float | None:
    """Model FLOPs utilization in [0, 1] over the distinct cards of
    ``devices`` (:func:`peak_flops_total`), or None when a peak is unknown
    (CPU) or throughput wasn't measured."""
    if not steps_per_sec or steps_per_sec <= 0 or not math.isfinite(steps_per_sec):
        return None
    peak = peak_flops_total(devices)
    if peak is None:
        return None
    return train_flops_per_step(cfg, batch, seq) * steps_per_sec / peak


__all__ = [
    "PEAK_BF16_FLOPS",
    "PEAK_HBM_BYTES",
    "forward_flops",
    "mfu",
    "peak_flops_per_device",
    "peak_flops_total",
    "peak_hbm_bytes_per_device",
    "train_flops_per_step",
    "window_pairs",
]
