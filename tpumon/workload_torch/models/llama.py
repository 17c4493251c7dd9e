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


def causal_mask(seq: int, device=None) -> torch.Tensor:
    """Additive causal mask [seq, seq] f32: -1e9 above the diagonal."""
    return torch.triu(
        torch.full((seq, seq), -1e9, dtype=torch.float32, device=device),
        diagonal=1,
    )


def plain_attention(q, k, v, mask):
    """The plain attention core: q [B,S,H,D], k/v [B,S,KV,D] → [B,S,H,D]
    in v's dtype. K/V heads are repeated up to H, the scores are f32
    (bf16 products are exact in f32, as the reference's
    preferred_element_type=float32) plus the additive ``mask``, and the
    probabilities are cast to v's dtype before the second product."""
    S, H, HD = q.shape[1], q.shape[2], q.shape[3]
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(HD) + mask[:S, :S]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(layer: nn.Module, x, freqs, mask, attn_impl=None):
    """A layer's attention sublayer on the normed input x [B,S,D]: the
    q/k/v projections, RoPE, the core, the output projection. It reads
    ``layer.cfg`` (heads, kv heads, head_dim, dtype) and the weights
    ``layer.wq``/``wk``/``wv``/``wo``; the dense and the MoE layers both
    hold them under these names."""
    cfg = layer.cfg
    B, S, _ = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ layer.wq.to(cfg.dtype)).reshape(B, S, H, HD)
    k = (x @ layer.wk.to(cfg.dtype)).reshape(B, S, KV, HD)
    v = (x @ layer.wv.to(cfg.dtype)).reshape(B, S, KV, HD)
    q = apply_rope(q, freqs[:S])
    k = apply_rope(k, freqs[:S])
    if attn_impl is not None:
        # Pluggable causal attention q [B,S,H,D], k/v [B,S,KV,D]; the
        # impl resolves the grouped-query sharing itself.
        out = attn_impl(q, k, v)
    else:
        out = plain_attention(q, k, v, mask)
    return out.reshape(B, S, H * HD) @ layer.wo.to(cfg.dtype)


class Block(nn.Module):
    """One decoder layer: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape, device))

    def mlp(self, x):
        dtype = self.cfg.dtype
        gate = x @ self.w_gate.to(dtype)
        up = x @ self.w_up.to(dtype)
        return (nn.functional.silu(gate) * up) @ self.w_down.to(dtype)

    def forward(self, h, freqs, mask, attn_impl=None):
        h = h + attention(self, rms_norm(h, self.attn_norm), freqs, mask, attn_impl)
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
        mask = causal_mask(S, x.device) if attn_impl is None else None
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, freqs, mask, attn_impl, use_reentrant=False)
            else:
                x = block(x, freqs, mask, attn_impl)
        x = rms_norm(x, self.final_norm)
        if not unembed:
            return x
        return (x @ self.unembed.to(cfg.dtype)).float()


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initialization, in place: normal(0.02) f32
    weights, ones for the norms. Returns ``model``."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return model


def init_params(
    cfg: LlamaConfig, generator: torch.Generator, device=None
) -> Llama:
    """A :class:`Llama` with the reference's initialization
    (:func:`init_weights`). ``device`` defaults to the generator's
    device."""
    device = generator.device if device is None else torch.device(device)
    return init_weights(Llama(cfg, device), generator)


def _copy_into(p: nn.Parameter, value, name: str) -> None:
    arr = np.array(value, dtype=np.float32, order="C")  # a writable copy
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(
            f"{name}: shape {arr.shape} does not match {tuple(p.shape)}"
        )
    p.copy_(torch.from_numpy(arr))


def load_jax_tree(model: nn.Module, tree, layer_params) -> nn.Module:
    """Copy the reference's parameter pytree (numpy arrays: ``embed``,
    ``layers`` stacked on a leading L axis with the keys
    ``layer_params``, ``final_norm``, ``unembed``) into ``model``, whose
    layers are ``model.blocks``. Returns ``model``."""
    layers = tree["layers"]
    with torch.no_grad():
        _copy_into(model.embed, tree["embed"], "embed")
        for i, block in enumerate(model.blocks):
            for name in layer_params:
                _copy_into(getattr(block, name), layers[name][i], f"layers.{name}[{i}]")
        _copy_into(model.final_norm, tree["final_norm"], "final_norm")
        _copy_into(model.unembed, tree["unembed"], "unembed")
    return model


def from_jax_params(cfg: LlamaConfig, tree, device=None) -> Llama:
    """Build a :class:`Llama` from the reference's parameter pytree as
    numpy arrays (:func:`load_jax_tree`)."""
    return load_jax_tree(Llama(cfg, device), tree, LAYER_PARAMS)
