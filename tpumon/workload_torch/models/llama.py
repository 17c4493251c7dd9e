"""Compact Llama-style decoder, ported to PyTorch.

The counterpart of ``tpumon/workload/models/llama.py``: the same config
fields and presets, the same parameter names and shapes (weights in the
JAX ``[in, out]`` layout, so each product is ``x @ w.to(cfg.dtype)`` with
no transposes), grouped-query attention, SwiGLU, f32 master weights cast
to ``cfg.dtype`` at each matmul as the reference does (not autocast, whose
per-op dtype policy would differ).

The reference scans one compiled layer body over weights stacked on a
leading layer axis; here the layers are ``Block`` modules in an
``nn.ModuleList`` and :func:`from_jax_params` unstacks that axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpumon.workload_torch.ops.core import apply_rope, rms_norm, rope_freqs


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 512
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    ffn_dim: int = 256
    max_seq: int = 128
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def small(cls) -> "LlamaConfig":
        return cls(
            vocab=8192, dim=512, n_layers=8, n_heads=8, n_kv_heads=4,
            ffn_dim=1408, max_seq=512,
        )

    @classmethod
    def medium(cls) -> "LlamaConfig":
        """~0.67 B params (embed 134 M + 12 layers × 45 M); the main
        path's model at seq 4096 with ``--attn flash``."""
        return cls(
            vocab=32768, dim=2048, n_layers=12, n_heads=16,
            n_kv_heads=4, ffn_dim=5632, max_seq=4096,
        )

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        """Llama-3-8B's published architecture: 32 layers, 4096 dim,
        32 query / 8 KV heads, 14336 SwiGLU hidden, 128k vocab."""
        return cls(
            vocab=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, max_seq=8192,
        )


#: Per-layer parameter names, in the reference's ``params["layers"]`` order.
LAYER_PARAMS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
    "w_down",
)


def _layer_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    D, F = cfg.dim, cfg.ffn_dim
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn_norm": (D,),
        "wq": (D, H * HD),
        "wk": (D, KV * HD),
        "wv": (D, KV * HD),
        "wo": (H * HD, D),
        "mlp_norm": (D,),
        "w_gate": (D, F),
        "w_up": (D, F),
        "w_down": (F, D),
    }


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class Block(nn.Module):
    """One decoder layer: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape, device))

    def attention(self, x, freqs, mask, attn_impl=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (x @ self.wq.to(cfg.dtype)).reshape(B, S, H, HD)
        k = (x @ self.wk.to(cfg.dtype)).reshape(B, S, KV, HD)
        v = (x @ self.wv.to(cfg.dtype)).reshape(B, S, KV, HD)
        q = apply_rope(q, freqs[:S])
        k = apply_rope(k, freqs[:S])
        if attn_impl is not None:
            # Pluggable causal attention q [B,S,H,D], k/v [B,S,KV,D]; the
            # impl resolves the grouped-query sharing itself.
            out = attn_impl(q, k, v).reshape(B, S, H * HD)
        else:
            rep = H // KV
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
            # f32 scores (bf16 products are exact in f32), as the
            # reference's preferred_element_type=float32.
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            scores = scores / math.sqrt(HD) + mask[:S, :S]
            probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H * HD)
        return out @ self.wo.to(cfg.dtype)

    def mlp(self, x):
        dtype = self.cfg.dtype
        gate = x @ self.w_gate.to(dtype)
        up = x @ self.w_up.to(dtype)
        return (nn.functional.silu(gate) * up) @ self.w_down.to(dtype)

    def forward(self, h, freqs, mask, attn_impl=None):
        h = h + self.attention(rms_norm(h, self.attn_norm), freqs, mask, attn_impl)
        return h + self.mlp(rms_norm(h, self.mlp_norm))


class Llama(nn.Module):
    """The decoder. Parameters are allocated uninitialized: build it with
    :func:`init_params` or :func:`from_jax_params`."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.dim), device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers)
        )
        self.final_norm = _param((cfg.dim,), device)
        self.unembed = _param((cfg.dim, cfg.vocab), device)

    def forward(
        self,
        tokens: torch.Tensor,
        attn_impl=None,
        remat: bool = False,
        unembed: bool = True,
    ) -> torch.Tensor:
        """tokens [B, S] → logits [B, S, vocab] float32.

        ``unembed=False`` returns the final-norm hidden states [B, S, dim]
        (cfg.dtype) for losses that fuse the unembed projection with the
        cross-entropy in chunks. ``attn_impl`` swaps the attention core
        (flash attention). ``remat=True`` checkpoints each block, so the
        backward recomputes its activations instead of keeping them.
        """
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.embed.to(cfg.dtype)[tokens]
        freqs = rope_freqs(cfg.head_dim, cfg.max_seq, device=x.device)
        mask = None
        if attn_impl is None:
            mask = torch.triu(
                torch.full((S, S), -1e9, dtype=torch.float32, device=x.device),
                diagonal=1,
            )
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, freqs, mask, attn_impl, use_reentrant=False)
            else:
                x = block(x, freqs, mask, attn_impl)
        x = rms_norm(x, self.final_norm)
        if not unembed:
            return x
        return (x @ self.unembed.to(cfg.dtype)).float()


def init_params(
    cfg: LlamaConfig, generator: torch.Generator, device=None
) -> Llama:
    """A :class:`Llama` with the reference's initialization: normal(0.02)
    f32 weights, ones for the norms. ``device`` defaults to the
    generator's device."""
    device = generator.device if device is None else torch.device(device)
    model = Llama(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return model


def _copy_into(p: nn.Parameter, value, name: str) -> None:
    arr = np.array(value, dtype=np.float32, order="C")  # a writable copy
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(
            f"{name}: shape {arr.shape} does not match {tuple(p.shape)}"
        )
    p.copy_(torch.from_numpy(arr))


def from_jax_params(cfg: LlamaConfig, tree, device=None) -> Llama:
    """Build a :class:`Llama` from the reference's parameter pytree as
    numpy arrays (``embed``, ``layers`` stacked on a leading L axis,
    ``final_norm``, ``unembed``)."""
    model = Llama(cfg, device)
    layers = tree["layers"]
    with torch.no_grad():
        _copy_into(model.embed, tree["embed"], "embed")
        for i, block in enumerate(model.blocks):
            for name in LAYER_PARAMS:
                _copy_into(getattr(block, name), layers[name][i], f"layers.{name}[{i}]")
        _copy_into(model.final_norm, tree["final_norm"], "final_norm")
        _copy_into(model.unembed, tree["unembed"], "unembed")
    return model
