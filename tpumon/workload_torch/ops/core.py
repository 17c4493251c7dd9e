"""Core ops of the workload model: RMSNorm and rotary embeddings.

Counterparts of ``tpumon/workload/ops/core.py``, computed in the same
dtypes (f32 inside, cast back to the input dtype).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 accumulation, cast back to the input dtype."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * weight).to(x.dtype)


def rope_freqs(
    head_dim: int, max_seq: int, theta: float = 10000.0, device=None
) -> torch.Tensor:
    """Rotary-embedding angles [max_seq, head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (exponent / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate channel halves (split-halves, not interleaved pairs); x is
    [B, S, H, D], freqs [S, D//2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
