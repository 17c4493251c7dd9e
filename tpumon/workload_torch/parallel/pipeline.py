"""Pipeline parallelism over the mesh's ``stage`` axis: the GPipe and
circular (interleaved) tick schedules.

The counterpart of ``tpumon/workload/parallel/pipeline.py``, with the
reference's schedule (:func:`_schedule`, its name) and layer storage
(:func:`storage_order`). Each stage holds ``interleave`` chunks of ``lpg
= n_layers / (pp·interleave)`` layers: chunk c of stage s is model block
c·pp + s (:func:`stage_layers`), so checkpoints keep model order.

The reference runs its schedule as one ``lax.scan`` inside a
``shard_map`` and lets autodiff reverse it. Here each stage runs the same
ticks eagerly, with what the reference computes by ``where`` on traced
indices worked out in Python per stage and tick:

- every tick runs the chunk's body, bubble ticks included (on zeros, or
  on whatever the ring carries); the body is one ``torch.utils.checkpoint``
  under ``remat``, as ``jax.checkpoint(run_body)`` is;
- every tick ends with one hop around the full stage ring
  (``parallel.mesh.stage_hop``, a counted ``collective-permute``),
  the ``pp − 1 → 0`` wrap included, which at ``interleave = 1`` carries
  nothing the first stage reads;
- stage 0 takes a fresh microbatch on the ticks of chunk 0 (zeros once
  they run out) and the received tensor otherwise; the other stages
  always take the received tensor.

JAX transposes a ``ppermute`` collectively; torch's autograd runs a
node's backward only if its output reaches the loss on that rank. So
every tensor the reference's ``where`` would select between stays in the
graph (:class:`_Pick`: the one not taken gets a zero gradient), and the
stages that do not hold the finished microbatches pass theirs on as zeros
that keep the graph (:class:`_Pick` again). Then every tick's body and
every hop but the last tick's runs its backward on every stage, in one
order, and the last tick's hop (whose output feeds nothing) on none.

The embedding, final norm and unembed are replicated over stage: the
pipe's input enters through ``copy_to_stage`` (its gradient sums over
stage; only stage 0 adds a non-zero one) and the last stage's output
leaves through ``reduce_from_stage`` (the reference's masked ``psum``),
so their gradients are equal on every stage and need no reduction.

The MoE aux loss needs full-batch means of two per-expert statistics.
The stage bodies return token sums (``MoeBlock.moe_mlp_sums``), added up
over the real ticks of each (chunk, layer) only (bubble ticks route zero
padding to uniform probabilities), then divided by the rank's tokens and
averaged over data (``models.moe.aux_loss``); each stage's part of the
aux loss is summed over stage. Means of per-microbatch means would not
be the reference's loss.

The stage bodies are the port's own layers (``models.llama.Block``,
``models.moe.MoeBlock``), whose Megatron, expert and ring collectives are
already explicit; the reference fuses its sums over expert and model
into one ``psum``, the port sums over model before the experts' combine
and over expert after, as on the unpipelined path.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpumon.workload_torch.models import llama as _llama
from tpumon.workload_torch.ops.core import rms_norm
from tpumon.workload_torch.parallel import mesh as mesh_mod


def _schedule(microbatches: int, pp: int, v: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Static tick schedule: (in_ticks, out_ticks, total_ticks).

    Microbatches flow in rounds of ``pp``; within a round each microbatch
    traverses all ``v`` chunks (one full ring lap per chunk) before the
    next round enters. Microbatch ``m`` enters stage 0 chunk 0 at tick
    ``(m//pp)·pp·v + m%pp`` and leaves stage pp-1 chunk v-1 ``(v-1)·pp +
    (pp-1)`` ticks later. At v=1 this is GPipe: in at ``m``, out at
    ``m + pp - 1``.
    """
    m = np.arange(microbatches)
    in_ticks = (m // pp) * pp * v + (m % pp)
    out_ticks = in_ticks + (v - 1) * pp + (pp - 1)
    return in_ticks, out_ticks, int(out_ticks[-1]) + 1


def storage_order(n_layers: int, pp: int, v: int) -> np.ndarray:
    """The model's layers in storage order: stage-major, then chunk, then
    layer; storage position (s, c) holds model block c·pp + s."""
    lpg = n_layers // (pp * v)
    return np.concatenate([np.arange(lpg) + (c * pp + s) * lpg
                           for s in range(pp) for c in range(v)])


def stage_layers(n_layers: int, pp: int, v: int, stage: int) -> list[list[int]]:
    """The global layers of ``stage``'s ``v`` chunks, chunk by chunk (its
    rows of :func:`storage_order`)."""
    rows = storage_order(n_layers, pp, v).reshape(pp, v, -1)[stage]
    return [[int(i) for i in chunk] for chunk in rows]


def check_schedule(n_layers: int, pp: int, interleave: int,
                   microbatches: int) -> None:
    """The reference's refusals of a schedule (its messages)."""
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if n_layers % (pp * interleave):
        raise ValueError(
            f"n_layers ({n_layers}) must divide by pp*interleave "
            f"({pp}*{interleave})"
        )
    if interleave > 1 and microbatches % pp:
        raise ValueError(
            f"the circular schedule feeds microbatches in rounds of pp: "
            f"microbatches ({microbatches}) must divide by pp ({pp})"
        )


def check_batch(per_shard: int, microbatches: int) -> None:
    if per_shard % microbatches:
        raise ValueError(
            f"per-data-shard batch ({per_shard}) must divide by "
            f"microbatches ({microbatches})"
        )


class _Pick(torch.autograd.Function):
    """``chosen`` forward; the backward gives ``chosen`` the gradient and
    ``dropped`` zeros, so ``dropped`` stays on the rank's gradient path
    (the branch a ``where`` does not select)."""

    @staticmethod
    def forward(ctx, chosen, dropped):
        return chosen

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


def _pick(chosen: torch.Tensor, dropped: torch.Tensor | None) -> torch.Tensor:
    if dropped is None or not dropped.requires_grad:
        return chosen
    return _Pick.apply(chosen, dropped)


def make_attn_impl(mesh, *, sp_layout: str = "contiguous", attn: str = "xla"):
    """The stage bodies' attention core: the ring (``parallel.ring``) when
    the seq axis is split, the flash kernels or the plain path (None)
    otherwise."""
    if mesh is not None and mesh.sp > 1:
        from tpumon.workload_torch.parallel.ring import make_ring_attn

        return make_ring_attn(mesh, zigzag=sp_layout == "zigzag",
                              flash=attn == "flash")
    if attn == "flash":
        from tpumon.workload_torch.ops.flash_attention import make_flash_attn

        return make_flash_attn()
    return None


def make_pipelined_forward(model, *, microbatches: int = 2, interleave: int = 1,
                           remat: bool = False, sp_layout: str = "contiguous",
                           attn: str = "xla"):
    """``forward(tokens) → logits`` (an MoE model: ``(logits, aux)``), the
    reference's ``forward_fn``, over the stage axis of ``model.mesh``.

    ``model`` is the rank's stage of a ``Llama`` or ``Moe`` built with
    ``layers = stage_layers(...)`` of this ``interleave``; ``tokens`` are
    the rank's [b_loc, S/sp] and split into ``microbatches`` of b_loc/M
    rows. Logits and aux are the whole model's, on every stage."""
    from tpumon.workload_torch.models.moe import MoeConfig, aux_loss

    mesh, cfg = model.mesh, model.cfg
    pp, v = mesh.pp, interleave
    is_moe = isinstance(cfg, MoeConfig)
    if sp_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown sp_layout: {sp_layout!r}")
    if attn not in ("xla", "flash"):
        raise ValueError(f"unknown attn impl: {attn!r}")
    if is_moe and mesh.sp > 1:
        raise ValueError(
            "pp×MoE composes with dp/ep/tp, not sp: routing's capacity "
            "cumsum runs over the whole sequence, which a seq-sharded "
            "stage body cannot compute locally"
        )
    if is_moe and cfg.n_experts % mesh.ep:
        raise ValueError(
            f"n_experts ({cfg.n_experts}) must divide by the mesh expert "
            f"axis ({mesh.ep})"
        )
    check_schedule(cfg.n_layers, pp, v, microbatches)
    stage = mesh.coords["stage"]
    chunks = [[model.blocks[str(i)] for i in layers]
              for layers in stage_layers(cfg.n_layers, pp, v, stage)]
    attn_impl = make_attn_impl(mesh, sp_layout=sp_layout, attn=attn)
    in_ticks, out_ticks, total_ticks = _schedule(microbatches, pp, v)
    fresh_at = {int(t): m for m, t in enumerate(in_ticks)}
    finished = {int(t) for t in out_ticks}
    period = pp * v
    last = stage == pp - 1

    def pipe(x, freqs, mask):
        """x [b_loc, S, D] → (the finished microbatches [b_loc, S, D] on
        the last stage, zeros that keep the graph elsewhere; MoE: the
        stage's token sums [v·lpg, 2E] over real ticks)."""
        b_loc, S, D = x.shape
        mb = b_loc // microbatches

        def run_body(c, h):
            sums = []
            for block in chunks[c]:
                if is_moe:
                    h, s = block.forward_sums(h, freqs, mask, attn_impl)
                    sums.append(s)
                else:
                    h = block(h, freqs, mask, attn_impl)
            return (h, torch.stack(sums)) if is_moe else (h,)

        recv = x.new_zeros((mb, S, D))
        ys, stats = [], [None] * v
        for t in range(total_ticks):
            u = t - stage  # this stage's logical time (u < 0: bubble)
            c = (u // pp) % v
            m = fresh_at.get(t)
            inp = None if m is None else x[m * mb:(m + 1) * mb]
            if stage == 0 and u % period < pp:
                x_in = _pick(recv.new_zeros(recv.shape) if inp is None else inp, recv)
            else:
                x_in = _pick(recv, inp)
            if remat:
                out = checkpoint(run_body, c, x_in, use_reentrant=False)
            else:
                out = run_body(c, x_in)
            y = out[0]
            if is_moe and u >= 0 and (u // period) * pp + u % pp < microbatches:
                stats[c] = out[1] if stats[c] is None else stats[c] + out[1]
            if t in finished:
                ys.append(y)
            recv = mesh_mod.stage_hop(y, mesh)
        outs = torch.cat(ys)
        if not last:
            outs = _Pick.apply(torch.zeros_like(outs), outs)
        return outs, (torch.cat(stats) if is_moe else None)

    def forward(tokens):
        b_loc, S = tokens.shape
        check_batch(b_loc, microbatches)
        x = _llama.embed_tokens(model, tokens)
        freqs = _llama.rank_freqs(model, S, x.device)
        mask = _llama.causal_mask(S, x.device) if attn_impl is None else None
        h, sums = pipe(mesh_mod.copy_to_stage(x, mesh), freqs, mask)
        h = rms_norm(mesh_mod.reduce_from_stage(h, mesh), model.final_norm)
        logits = _llama.unembed_logits(model, h)
        if not is_moe:
            return logits
        aux = mesh_mod.reduce_from_stage(aux_loss(sums / (b_loc * S), cfg, mesh), mesh)
        return logits, aux / cfg.n_layers

    return forward


def ticks(microbatches: int, pp: int, interleave: int) -> int:
    """Ticks of one step (:func:`_schedule`'s ``total_ticks``)."""
    return _schedule(microbatches, pp, interleave)[2]


__all__ = [
    "check_batch",
    "check_schedule",
    "make_attn_impl",
    "make_pipelined_forward",
    "stage_layers",
    "storage_order",
    "ticks",
]
