"""Compact Llama-style decoder, ported to PyTorch.

The counterpart of ``tpumon/workload/models/llama.py``: the same config
fields and presets, the same parameter names and shapes (weights in the
JAX ``[in, out]`` layout, so each product is ``x @ w.to(cfg.dtype)`` with
no transposes), grouped-query attention, SwiGLU, f32 master weights cast
to ``cfg.dtype`` at each matmul as the reference does (not autocast, whose
per-op dtype policy would differ). Every part of the step runs in a span
of its own (``spans.py``): the layer, its projections, the attention
core, the MLP, the embedding and the loss.

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

from tpumon.workload_torch import flops
from tpumon.workload_torch.models.family import Family, register
from tpumon.workload_torch.ops.core import apply_rope, cast, rms_norm, rope_freqs
from tpumon.workload_torch.parallel import mesh as mesh_mod
from tpumon.workload_torch.spans import traced


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
    ``layer.cfg`` (head_dim, dtype), ``layer.mesh`` and the weights
    ``layer.wq``/``wk``/``wv``/``wo``; the dense and the MoE layers both
    hold them under these names. Under tp the weights hold the rank's
    heads (the heads are read off their widths), the projections' input
    is a column split's and the output projection a row split."""
    cfg = layer.cfg
    S = x.shape[1]
    x = mesh_mod.copy_to_model(x, layer.mesh)
    q, k, v = _qkv(x, layer.wq, layer.wk, layer.wv, cfg.dtype, cfg.head_dim)
    q = apply_rope(q, freqs[:S])
    k = apply_rope(k, freqs[:S])
    out = _attn_core(q, k, v, mask, attn_impl)
    return mesh_mod.reduce_from_model(_attn_out(out, layer.wo, cfg.dtype),
                                      layer.mesh)


@traced("qkv")
def _qkv(x, wq, wk, wv, dtype, head_dim):
    """x [B,S,D] → q [B,S,H,HD], k/v [B,S,KV,HD], the heads read off the
    weights' widths."""
    B, S, _ = x.shape
    H, KV = wq.shape[1] // head_dim, wk.shape[1] // head_dim
    q = (x @ cast(wq, dtype)).reshape(B, S, H, head_dim)
    k = (x @ cast(wk, dtype)).reshape(B, S, KV, head_dim)
    v = (x @ cast(wv, dtype)).reshape(B, S, KV, head_dim)
    return q, k, v


@traced("attn_core")
def _attn_core(q, k, v, mask, attn_impl):
    if attn_impl is not None:
        # Pluggable causal attention q [B,S,H,D], k/v [B,S,KV,D]; the
        # impl resolves the grouped-query sharing itself.
        return attn_impl(q, k, v)
    return plain_attention(q, k, v, mask)


@traced("attn_out")
def _attn_out(out, wo, dtype):
    """The output projection of the heads out [B,S,H,HD] → [B,S,D]."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ cast(wo, dtype)


def swiglu(x, w_gate, w_up, w_down, dtype):
    """The dense SwiGLU, silu(x·W_gate) · (x·W_up), then ·W_down, in
    ``dtype``: a dense layer's MLP (:meth:`Block.mlp`) and DeepSeek-V2's
    dense layers and shared experts."""
    gate = x @ cast(w_gate, dtype)
    up = x @ cast(w_up, dtype)
    return (nn.functional.silu(gate) * up) @ cast(w_down, dtype)


def check_tp(cfg, tp: int) -> None:
    """Raise unless ``tp`` splits the heads, the kv heads, the FFN and the
    vocabulary evenly."""
    for field in ("n_heads", "n_kv_heads", "ffn_dim", "vocab"):
        if getattr(cfg, field) % tp:
            raise ValueError(
                f"{field} ({getattr(cfg, field)}) must divide by tp ({tp})"
            )


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


class Block(nn.Module):
    """One decoder layer: x + attn(norm(x)), then + mlp(norm(x)). Under a
    ``mesh`` with tp > 1 it holds the rank's slices (Megatron splits)."""

    def __init__(self, cfg: LlamaConfig, device=None, mesh=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        for name, shape in _layer_shapes(cfg).items():
            shape = mesh_mod.local_shape(name, shape, mesh_mod.PARAM_SPECS,
                                         _tp(mesh))
            setattr(self, name, _param(shape, device))

    @traced("mlp")
    def mlp(self, x):
        x = mesh_mod.copy_to_model(x, self.mesh)
        out = swiglu(x, self.w_gate, self.w_up, self.w_down, self.cfg.dtype)
        return mesh_mod.reduce_from_model(out, self.mesh)

    @traced("layer")
    def forward(self, h, freqs, mask, attn_impl=None):
        """The layer's output and its aux loss: none (:func:`trunk`)."""
        h = h + attention(self, rms_norm(h, self.attn_norm), freqs, mask, attn_impl)
        return h + self.mlp(rms_norm(h, self.mlp_norm)), None

    #: A pipeline stage's call (``parallel.pipeline``): no aux statistics.
    forward_sums = forward


def embed_tokens(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] → x [B, S, dim] in ``cfg.dtype``. Under tp the rank
    holds a contiguous block of the vocabulary's rows: it looks up the
    ids in its block, zeroes the others, and the rows sum over model."""
    return _embed(model.embed, tokens, model)


@traced("embed")
def _embed(weight, tokens, model):
    # The weight comes in as an argument, so that the span has a backward
    # half (``spans.traced``): the tokens carry no gradient.
    w = cast(weight, model.cfg.dtype)
    if _tp(model.mesh) == 1:
        return w[tokens]
    rows = w.shape[0]
    local = tokens - model.mesh.coords["model"] * rows
    inside = (local >= 0) & (local < rows)
    x = w[local.clamp(0, rows - 1)] * inside[..., None].to(w.dtype)
    return mesh_mod.reduce_from_model(x, model.mesh)


def rank_freqs(model: nn.Module, seq: int, device) -> torch.Tensor:
    """The RoPE table of the ``seq`` positions the model's tokens hold:
    under sp the rank's contiguous window of the sequence, in either ring
    layout (zigzag redistributes inside the attention only)."""
    cfg = model.cfg
    freqs = rope_freqs(cfg.head_dim, cfg.max_seq, device=device)
    if model.mesh is not None and model.mesh.sp > 1:
        start = model.mesh.coords["seq"] * seq
        freqs = freqs[start:start + seq]
    return freqs


@traced("loss")
def unembed_logits(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden x [B, S, dim] → f32 logits [B, S, vocab] (the
    rank's vocabulary columns under tp). It is the loss's first part, and
    runs in its span."""
    x = mesh_mod.copy_to_model(x, model.mesh)
    return (x @ cast(model.unembed, model.cfg.dtype)).float()


def decoder_params(model: nn.Module, cfg, make_block, device=None, mesh=None,
                   layers=None, specs=mesh_mod.PARAM_SPECS) -> None:
    """Give ``model`` its config, mesh and parameters: the embedding and
    unembedding (the rank's vocabulary block under tp, by ``specs``), the
    final norm and the layers ``make_block(i)``, all ``cfg.n_layers`` or a
    pipeline stage's ``layers`` keyed by their global index (the full
    model's state-dict names, ``blocks.<i>.<param>``)."""
    tp = _tp(mesh)
    model.cfg, model.mesh = cfg, mesh
    model.embed = _param(
        mesh_mod.local_shape("embed", (cfg.vocab, cfg.dim), specs, tp), device)
    if layers is None:
        model.blocks = nn.ModuleList(make_block(i) for i in range(cfg.n_layers))
    else:
        model.blocks = nn.ModuleDict({str(i): make_block(i) for i in layers})
    model.final_norm = _param((cfg.dim,), device)
    model.unembed = _param(
        mesh_mod.local_shape("unembed", (cfg.dim, cfg.vocab), specs, tp), device)


def trunk(model: nn.Module, tokens: torch.Tensor, attn_impl=None,
          remat: bool = False, *, freqs=rank_freqs, eps: float = 1e-5,
          aux_layers: int | None = None, unembed: bool = True):
    """The decoder every family runs: the embedding, the RoPE table
    ``freqs(model, S, device)``, the mask (plain attention only), each
    block (h, freqs, mask, attn_impl) → (h, its aux loss or None),
    checkpointed under ``remat``, the final norm at ``eps``, the unembed
    (skipped under ``unembed=False``). Returns the logits, or with
    ``aux_layers`` (logits, the aux losses' sum over ``aux_layers``)."""
    if isinstance(model.blocks, nn.ModuleDict):
        raise RuntimeError("this model holds one pipeline stage's layers; "
                           "it runs through parallel.pipeline")
    S = tokens.shape[1]
    x = embed_tokens(model, tokens)
    table = freqs(model, S, x.device)
    mask = causal_mask(S, x.device) if attn_impl is None else None
    aux = None if aux_layers is None else x.new_zeros((), dtype=torch.float32)
    for block in model.blocks:
        if remat:
            x, layer_aux = checkpoint(block, x, table, mask, attn_impl,
                                      use_reentrant=False)
        else:
            x, layer_aux = block(x, table, mask, attn_impl)
        if aux is not None:
            aux = aux + layer_aux
    x = rms_norm(x, model.final_norm, eps)
    out = unembed_logits(model, x) if unembed else x
    return out if aux is None else (out, aux / aux_layers)


class Llama(nn.Module):
    """The decoder. Parameters are allocated uninitialized: build it with
    :func:`init_params` or :func:`from_jax_params`. ``mesh`` (a
    ``parallel.mesh.Mesh``, None on one device) makes it the rank's
    Megatron slice: local heads ``H/tp`` and ``KV/tp``, FFN ``ffn_dim/tp``
    and vocabulary ``vocab/tp``; fill it with ``parallel.mesh.shard_params``
    of a full model's state. ``layers`` (a pipeline stage's global layer
    indices, ``parallel.pipeline.stage_layers``) makes it hold only those
    (:func:`decoder_params`); such a model runs through
    ``parallel.pipeline.make_pipelined_forward``."""

    def __init__(self, cfg: LlamaConfig, device=None, mesh=None,
                 layers=None) -> None:
        super().__init__()
        check_tp(cfg, _tp(mesh))
        decoder_params(self, cfg, lambda i: Block(cfg, device, mesh), device, mesh,
                       layers)

    def forward(
        self,
        tokens: torch.Tensor,
        attn_impl=None,
        remat: bool = False,
        unembed: bool = True,
    ) -> torch.Tensor:
        """tokens [B, S] → logits [B, S, vocab] float32 (the rank's
        vocabulary columns under tp).

        ``unembed=False`` returns the final-norm hidden states [B, S, dim]
        (cfg.dtype) for losses that fuse the unembed projection with the
        cross-entropy in chunks. ``attn_impl`` swaps the attention core
        (flash attention). ``remat=True`` checkpoints each block, so the
        backward recomputes its activations instead of keeping them.
        """
        return trunk(self, tokens, attn_impl, remat, unembed=unembed)


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


def check(cfg: LlamaConfig, *, ep: int = 1, **_) -> None:
    """The reference's refusal of expert parallelism without experts (its
    message)."""
    if ep > 1:
        raise ValueError("ep > 1 requires a MoeConfig")


FAMILY = register(Family(
    name="llama", config=LlamaConfig,
    presets={"tiny": LlamaConfig.tiny, "small": LlamaConfig.small,
             "medium": LlamaConfig.medium, "llama3-8b": LlamaConfig.llama3_8b},
    model=Llama, init_params=init_params, from_jax_params=from_jax_params,
    forward_flops=flops.forward_flops, check=check,
    param_specs=mesh_mod.PARAM_SPECS,
))
