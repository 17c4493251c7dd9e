"""Training harness of the port: the train step of a model family
(``models.family``: the dense Llama and MoE on one card or on a
dp×pp×ep×sp×tp mesh of processes, DeepSeek-V2's latent attention and
DeepSeekMoE over a held share of the experts on one card).

The counterpart of ``tpumon/workload/harness.py`` for the single-device
and dp×pp×ep×sp×tp paths: next-token cross-entropy (plus the weighted GShard aux
loss for MoE), optional strided gradient accumulation, remat and a
chunked loss, AdamW with optax's defaults (or its ZeRO-1 form), the
windowed loop that publishes ``tpu_step_*`` (and, with ``--serve``,
``tpu_serve_*``; on a mesh, the collective counters and the wait
fraction) on ``--metrics-port`` for the monitor to read, and a
checkpointed loop (``--checkpoint-dir``) that resumes from the newest
saved step.

PyTorch runs eagerly, so there is no jit: parameters and optimizer state
are updated in place, and the loop reads the loss on the host once per
stats window. ``--attn flash`` runs attention on the hand-written Hopper
kernels of ``ops/flash_attention.py``. ``--dp``/``--tp``/``--sp``/``--pp``/``--ep``
start one process per mesh position (``parallel/launch.py``); rank 0 owns the page
and the final log line. ``--pp`` runs the layers as a pipeline over the
mesh's stage axis (``parallel/pipeline.py``), GPipe or, with
``--interleave``, the circular schedule, in ``--microbatches`` microbatches.
``--coordinator``/``--num-processes``/``--process-id`` make this process
one host of a multi-host job: it starts its share of the ranks, and all
hosts' ranks meet at the coordinator.

CLI:  python -m tpumon.workload_torch.harness --steps 20
      python -m tpumon.workload_torch.harness --model moe --preset small
      python -m tpumon.workload_torch.harness --checkpoint-dir ckpt --steps 6
      python -m tpumon.workload_torch.harness --dp 2 --tp 2 --zero1
      python -m tpumon.workload_torch.harness --tp 2 --sp 2 --sp-layout zigzag
      python -m tpumon.workload_torch.harness --model moe --dp 2 --ep 2
      python -m tpumon.workload_torch.harness --model deepseek_v2 --preset v2-lite-share \
          --seq 4096 --batch 16 --attn flash --remat
      python -m tpumon.workload_torch.harness --pp 2 --tp 2 --interleave 2 --microbatches 4
      python -m tpumon.workload_torch.harness --dp 2 --tp 2 \
          --coordinator 10.0.0.1:29500 --num-processes 2 --process-id 0
      (``--platform cpu`` runs on the host; the default is the card)
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import sys
import time

import torch
from torch.utils.checkpoint import checkpoint

from tpumon.workload_torch import flops as flops_mod
from tpumon.workload_torch import spans
from tpumon.workload_torch.models import family
from tpumon.workload_torch.ops.core import cast
from tpumon.workload_torch.parallel import mesh as mesh_mod
from tpumon.workload_torch.platform import PLATFORMS, resolve_device

log = logging.getLogger(__name__)



def _vocab_parallel_nll(logits, targets, mesh):
    """Per-token NLL [..., 1] f32 of logits [..., vocab/tp] that hold the
    rank's block of the vocabulary: the row max and the sum of exps
    all-reduce over model, and the target's logit comes from the rank
    that holds it (the others add zero)."""
    rows = logits.shape[-1]
    m = logits.detach().amax(dim=-1, keepdim=True)
    mesh_mod.all_reduce(m, mesh, "model", op="max")
    local = targets[..., None] - mesh.coords["model"] * rows
    inside = ((local >= 0) & (local < rows)).to(logits.dtype)
    picked = logits.gather(-1, local.clamp(0, rows - 1)) * inside
    sums = torch.cat([torch.exp(logits - m).sum(dim=-1, keepdim=True), picked], -1)
    sums = mesh_mod.reduce_from_model(sums, mesh)
    return torch.log(sums[..., :1]) + m - sums[..., 1:]


def _split_vocab(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


@spans.traced("loss")
def _chunk_nll_sum(xc, unembed_w, tc, dtype, mesh=None):
    logits = (xc @ cast(unembed_w, dtype)).float()
    if _split_vocab(mesh):
        return _vocab_parallel_nll(logits, tc, mesh).sum()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tc[..., None]).sum()


def _chunked_nll(x, unembed_w, targets, chunk, dtype, mesh=None):
    """Mean next-token NLL with the unembed fused into the loss, one
    sequence chunk at a time: x [B,S,D] (final-norm hidden), targets
    [B,S] → scalar f32. Each chunk is checkpointed, so the backward
    recomputes its logits and the full [B, S, vocab] f32 logits never
    exist at once. Under tp, x is the unembed column split's input and
    each chunk's loss is the vocab-parallel one."""
    B, S, _ = x.shape
    x = mesh_mod.copy_to_model(x, mesh)
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, x[:, i:i + chunk], unembed_w,
            targets[:, i:i + chunk], dtype, mesh, use_reentrant=False,
        )
    return total / (B * S)


def loss_fn(model, tokens, attn_impl=None, remat=False, loss_chunk=0,
            forward_fn=None):
    """Next-token cross-entropy; inputs [B, S], targets are the shift-by-1.
    A forward that returns (logits, aux) adds its config's ``aux_weight``
    × the aux loss (Mixtral's GShard loss at 0.01, DeepSeek-V2's
    sequence-level balance loss at ``aux_loss_alpha``). ``loss_chunk``
    (dense model only) fuses the unembed projection into the loss in
    sequence chunks of that many tokens (:func:`_chunked_nll`). Under the
    model's mesh the loss is the rank's data shard's, from vocab-sharded
    logits. ``forward_fn`` replaces the model's forward (the pipelined
    forward, ``parallel.pipeline.make_pipelined_forward``)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mesh = model.mesh
    if loss_chunk and forward_fn is None:
        x = model(inputs, attn_impl, remat, unembed=False)
        return _chunked_nll(x, model.unembed, targets, loss_chunk,
                            model.cfg.dtype, mesh)
    out = model(inputs, attn_impl, remat) if forward_fn is None else forward_fn(inputs)
    logits, aux = out if isinstance(out, tuple) else (out, None)
    loss = _mean_nll(logits, targets, mesh)
    return loss if aux is None else loss + model.cfg.aux_weight * aux


@spans.traced("loss")
def _mean_nll(logits, targets, mesh=None):
    if _split_vocab(mesh):
        return _vocab_parallel_nll(logits, targets, mesh).mean()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


#: AdamW's learning rate, optax.adamw(1e-3)'s, unless the model's config
#: sets its own (``DeepseekV2Config.learning_rate``).
LEARNING_RATE = 1e-3


def make_optimizer(params, lr: float = LEARNING_RATE) -> torch.optim.Optimizer:
    """AdamW with optax.adamw(1e-3)'s defaults at learning rate ``lr``.
    weight_decay is optax's 1e-4; torch's own default of 1e-2 would train
    a different model."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )


def _param_specs(model) -> dict[str, tuple]:
    return family.of(model.cfg).param_specs or {}


def build_optimizer(named_params, model, zero1: bool = False):
    """:func:`make_optimizer` over ``named_params`` (``model``'s, or
    copies in the same order), at the learning rate of ``model``'s config
    where it has one, or under ``zero1`` its ZeRO-1 form over ``model``'s
    mesh (:class:`parallel.mesh.Zero1`)."""
    named_params = list(named_params)
    lr = getattr(model.cfg, "learning_rate", LEARNING_RATE)
    if zero1:
        return mesh_mod.Zero1(named_params, model.mesh,
                              functools.partial(make_optimizer, lr=lr),
                              _param_specs(model))
    return make_optimizer([p for _, p in named_params], lr)


def _moment_bytes(model, optimizer) -> dict[str, int]:
    """Bytes of the AdamW moments this process holds, by parameter (under
    ZeRO-1 the state is keyed by the rank's slices)."""
    if isinstance(optimizer, mesh_mod.Zero1):
        held = zip(optimizer.names, optimizer.shards)
    else:
        held = model.named_parameters()
    return {name: sum(v.numel() * v.element_size()
                      for k, v in optimizer.state.get(t, {}).items()
                      if k in ("exp_avg", "exp_avg_sq"))
            for name, t in held}


def _data_mean_grads(params, chunk_losses, mesh):
    """The data×seq all-reduce of one flat bucket per accumulation chunk:
    ``chunk_losses`` yields each chunk's loss after its backward, whose
    gradients (and the loss) go into one all-reduce over ``data_seq``
    (the weights are replicated over both axes); the sums add up across
    chunks. Leaves each ``.grad`` as a view of the bucket, the mean over
    data×seq ranks and chunks, and returns the loss's mean (every rank
    holds as many tokens, so the mean of the ranks' means is the batch
    mean)."""
    total, chunks = None, 0
    for loss in chunk_losses:
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
        for p in params:
            p.grad = None
        mesh_mod.all_reduce(flat, mesh, "data_seq")
        total = flat if total is None else total.add_(flat)
        chunks += 1
    total.div_(mesh.dp * mesh.sp * chunks)
    offset = 0
    for p in params:
        p.grad = total[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return total[-1]


def make_train_step(
    model,
    optimizer,
    attn_impl=None,
    grad_accum: int = 1,
    remat: bool = False,
    with_grad_norm: bool = False,
    loss_chunk: int = 0,
    forward_fn=None,
):
    """One optimizer step ``step(tokens) -> (loss, grad_norm)`` as device
    tensors (no host sync). ``grad_accum > 1`` splits the batch into that
    many strided chunks (chunk a takes rows a, a+A, a+2A, …, as the
    reference does) and averages their gradients before the one update.
    ``grad_norm`` is the global gradient L2 norm when ``with_grad_norm``,
    else NaN (the whole-tree reduction is opt-in).

    On the model's mesh, ``tokens`` are the rank's data and seq shard.
    With dp·sp > 1 each chunk's gradients (and loss) go through one
    all-reduce over data×seq (one burst per chunk, the cadence the
    reference's docstring gives), and the loss is the mean over those
    ranks. Under tp the
    grad norm adds the split leaves' squares over ``model`` (one
    all-reduce), under ep the expert banks' over ``expert`` first (one
    more), under pp the layers' over ``stage`` last (one more); replicated
    leaves count once. ``forward_fn`` is the pipelined forward (under pp,
    where ``grad_accum`` is 1). While a profiler records, the call runs in
    the span ``workload.step``, each chunk's forward and backward in
    ``workload.fwd`` and ``workload.bwd``, and the update in
    ``workload.optimizer`` (``spans.py``). After the update it runs the
    family's ``after_step`` on the model, where the family gives one
    (``models.family``)."""
    params = list(model.parameters())
    mesh = model.mesh
    specs = _param_specs(model)
    names = [name for name, _ in model.named_parameters()]
    by_model = [mesh_mod.split_dim(n, specs) is not None for n in names]
    by_expert = [mesh_mod.split_dim(n, specs, "expert") is not None for n in names]
    by_stage = [mesh_mod.layer_index(n) is not None for n in names]
    after_step = family.of(model.cfg).after_step

    def grad_of(tokens):
        with spans.span("fwd"):
            loss = loss_fn(model, tokens, attn_impl, remat, loss_chunk, forward_fn)
        with spans.span("bwd"):
            loss.backward()
        return loss.detach()

    def chunks_of(tokens):
        B = tokens.shape[0]
        return tokens.reshape(B // grad_accum, grad_accum, -1).transpose(0, 1)

    def grad_norm():
        if mesh is None or mesh.tp * mesh.ep * mesh.pp == 1:
            return torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
            )
        sq = torch.stack([torch.linalg.vector_norm(p.grad) ** 2 for p in params])
        experts = torch.tensor(by_expert, device=sq.device)
        model_only = torch.tensor(by_model, device=sq.device) & ~experts
        whole = ~(experts | model_only)
        # The stage's own leaves (under pp its layers; else every leaf)
        # and, under pp, the leaves replicated over stage, each summed
        # over expert and model; the stage's own then over stage.
        own = torch.tensor(by_stage if mesh.pp > 1 else [True] * len(names),
                           device=sq.device)
        split_sq = mesh_mod.all_reduce(sq[experts].sum().reshape(1), mesh, "expert")
        parts = [split_sq + sq[model_only & own].sum()]
        if mesh.pp > 1:
            parts.append(sq[model_only & ~own].sum().reshape(1))
        split_sq = mesh_mod.all_reduce(torch.cat(parts), mesh, "model")
        own_sq = mesh_mod.all_reduce(
            (split_sq[0] + sq[whole & own].sum()).reshape(1), mesh, "stage")
        return torch.sqrt(own_sq[0] + split_sq[1:].sum() + sq[whole & ~own].sum())

    def step(tokens):
        with spans.span("step"):
            return update(tokens)

    def update(tokens):
        optimizer.zero_grad(set_to_none=True)
        if mesh is not None and mesh.dp * mesh.sp > 1:
            chunks = [tokens] if grad_accum == 1 else chunks_of(tokens)
            loss = _data_mean_grads(params, (grad_of(c) for c in chunks), mesh)
        elif grad_accum == 1:
            loss = grad_of(tokens)
        else:
            loss = sum(grad_of(chunk) for chunk in chunks_of(tokens)) / grad_accum
            for p in params:
                p.grad.div_(grad_accum)
        if with_grad_norm:
            gnorm = grad_norm()
        else:
            gnorm = torch.full((), float("nan"), device=loss.device)
        with spans.span("optimizer"):
            optimizer.step()
        if after_step is not None:
            after_step(model)
        return loss, gnorm

    return step


@dataclasses.dataclass
class RunResult:
    losses: list[float]
    steps_per_sec: float
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    #: First global step this run executed (> 0 after a checkpoint resume).
    start_step: int = 0
    #: Model FLOPs per optimizer step (flops.train_flops_per_step).
    model_flops_per_step: float = 0.0
    #: Model FLOPs utilization vs the published bf16 peak of the run's
    #: distinct cards; None when the peak is unknown (CPU) or throughput
    #: absent.
    mfu: float | None = None
    #: Global gradient L2 norm at the final step (with_grad_norm only).
    grad_norm: float | None = None
    #: The grad norm beside each entry of ``losses`` (with_grad_norm only).
    grad_norms: list[float] = dataclasses.field(default_factory=list)
    #: Bytes of the AdamW moments this process holds, by parameter.
    moment_bytes: dict[str, int] = dataclasses.field(default_factory=dict)


def _clone_optimizer_state(state_dict: dict) -> dict:
    state = {
        idx: {key: (val.clone() if torch.is_tensor(val) else val)
              for key, val in per_param.items()}
        for idx, per_param in state_dict["state"].items()
    }
    return {"state": state, "param_groups": state_dict["param_groups"]}


def _make_phase_probe(model, optimizer, attn_impl, remat, loss_chunk,
                      grad_accum: int = 1, zero1: bool = False, forward_fn=None):
    """One instrumented step split into timed fwd / fwd+bwd / optimizer
    phases (``--phase-stats``), run at most once per stats window. It
    leaves the live parameters, their ``.grad`` and the optimizer state
    untouched: gradients come from ``torch.autograd.grad``, and the timed
    optimizer update runs on clones of the parameters and the state, and
    the model's buffers (MiMo-V2's expert loads) are put back after its
    passes.
    bwd is the grad pass minus the forward pass.

    Under ``grad_accum > 1`` the probe times ONE strided chunk and scales
    fwd/bwd by the chunk count, as the reference does: the real step
    never runs a full-batch backward.

    On a mesh every rank runs it in lockstep: it issues the step's
    collectives (the ring's permutes, the pipeline's hops, the grad
    pass's data×seq all-reduce of its gradients, and a ZeRO-1 update's
    all-gather)."""
    params = list(model.parameters())
    names = [name for name, _ in model.named_parameters()]
    chunks = max(1, int(grad_accum))
    device = params[0].device
    mesh = model.mesh

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def probe(tokens) -> dict[str, float]:
        if chunks > 1:
            tokens = tokens[::chunks]
        held = [b.clone() for b in model.buffers()]
        t0 = clock()
        with torch.no_grad():
            loss_fn(model, tokens, attn_impl, remat, loss_chunk, forward_fn)
        fwd_s = clock() - t0
        t0 = clock()
        loss = loss_fn(model, tokens, attn_impl, remat, loss_chunk, forward_fn)
        grads = torch.autograd.grad(loss, params)
        if mesh is not None and mesh.dp * mesh.sp > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            mesh_mod.all_reduce(flat, mesh, "data_seq").div_(mesh.dp * mesh.sp)
            grads = [g.view_as(p) for g, p in
                     zip(flat.split([p.numel() for p in params]), params)]
        grad_s = clock() - t0
        with torch.no_grad():
            for b, kept in zip(model.buffers(), held):
                b.copy_(kept)
        scratch = [p.detach().clone().requires_grad_(True) for p in params]
        for s, g in zip(scratch, grads):
            s.grad = g
        opt = build_optimizer(zip(names, scratch), model, zero1)
        opt.load_state_dict(_clone_optimizer_state(optimizer.state_dict()))
        t0 = clock()
        opt.step()
        opt_s = clock() - t0
        return {
            "fwd": fwd_s * chunks,
            "bwd": max(0.0, grad_s - fwd_s) * chunks,
            "optimizer": opt_s,
        }

    return probe


def _record_serve_window(serve, batch: int, n_steps: int, window_s: float) -> None:
    """One serving window from the traffic generator's shape: every
    sequence in the batch is one request per step, and the window's
    per-step wall time stands in for TTFT (queue wait + one decode
    step). SLO attainment is all-or-nothing per window."""
    step_s = window_s / max(n_steps, 1)
    requests = n_steps * batch
    thr = serve.snapshot()["slo_threshold_seconds"]
    serve.set_queue_depth(batch)
    serve.record_window(
        requests=requests,
        seconds=window_s,
        batch_mean=float(batch),
        ttft_worst_s=step_s,
        slo_met=(
            None if thr is None else (requests if step_s <= thr else 0)
        ),
    )


def _build_model(cfg, params, generator, device, mesh=None, interleave: int = 1):
    """The seeded model of ``cfg``'s family, or ``params`` (a model, or
    the reference's parameter tree as numpy arrays) on ``device``. On a
    ``mesh`` every rank builds the full model from the same seed (or
    tree) and keeps its slice (``parallel.mesh.shard_params``): under pp,
    the layers of its stage's ``interleave`` chunks
    (``parallel.pipeline.stage_layers``)."""
    fam = family.of(cfg)
    if params is None:
        full = fam.init_params(cfg, generator)
    elif isinstance(params, torch.nn.Module):
        full = params.to(device)
    else:
        full = fam.from_jax_params(cfg, params, device)
    if mesh is None:
        return full
    layers = None
    if mesh.pp > 1:
        from tpumon.workload_torch.parallel.pipeline import stage_layers

        layers = sum(stage_layers(cfg.n_layers, mesh.pp, interleave,
                                  mesh.coords["stage"]), [])
    model = fam.model(cfg, device, mesh, layers)
    with torch.no_grad():
        model.load_state_dict(
            mesh_mod.shard_params(full.state_dict(), mesh, fam.param_specs, layers))
    return model


def run(
    cfg,
    *,
    steps: int = 10,
    batch: int = 8,
    seq: int | None = None,
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    microbatches: int = 2,
    interleave: int = 1,
    sp_layout: str = "contiguous",
    grad_accum: int = 1,
    remat: bool = False,
    with_grad_norm: bool = False,
    loss_chunk: int = 0,
    zero1: bool = False,
    seed: int = 0,
    mesh=None,
    attn: str = "xla",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    stats=None,
    stats_every: int = 20,
    phase_stats: bool = False,
    serve=None,
    device=None,
    params=None,
    tokens=None,
) -> RunResult:
    """Build and run the train step; returns losses + throughput.

    ``cfg`` is the config of a model family (``models.family``), and
    picks the model. ``device=None`` means the card (``cuda``); pass ``"cpu"``
    for the host. ``attn="flash"`` runs attention on the flash kernels.
    ``params`` (a model, or the reference's parameter tree as numpy
    arrays) and ``tokens`` ([batch, seq + 1] integers) replace the seeded
    ones, so a test can give this run and the reference the same weights
    and data.

    ``dp``/``tp``/``sp``/``ep`` > 1 run this process as one rank of a mesh
    (``mesh``: this rank's ``parallel.mesh.Mesh``, made from the started
    process group when not given; it also sets the device): every rank
    draws the full weights and tokens and keeps its Megatron slice and its
    contiguous block of ``batch // dp`` rows. The losses, the grad norm,
    the FLOPs and the tokens a step are global. ``zero1`` shards the AdamW
    moments over ``data`` (ZeRO-1; needs dp > 1).

    ``sp > 1`` splits the sequence over the mesh's ``seq`` axis too (ring
    attention, ``parallel/ring.py``, in ``sp_layout`` "contiguous" or
    "zigzag", on the flash kernels under ``attn="flash"``): the rank at
    seq coordinate c takes the columns c·S/sp … (c+1)·S/sp of the tokens
    and one more for the shifted targets, RoPE takes those global
    positions, and the loss and the gradient bucket are means over
    data×seq. An MoE model routes on the whole sequence (its router
    probabilities gathered over seq).

    ``ep > 1`` (MoE only) splits the expert banks over the mesh's
    ``expert`` axis; expert peers hold the same rows, each runs its own
    experts, and one all-reduce over expert combines them
    (``models/moe.py``).

    ``pp > 1`` splits the layers over the mesh's ``stage`` axis and runs
    them as a pipeline (``parallel/pipeline.py``): the rank's rows go
    through in ``microbatches`` microbatches, on the GPipe schedule or,
    with ``interleave`` > 1, the circular one (each stage holds that many
    chunks of layers). It composes with dp, tp, sp and, for MoE, ep (not
    sp); the reference refuses ``grad_accum`` and ``loss_chunk`` with it
    (:func:`check_layout`). ``remat`` then recomputes each tick's chunk of
    layers as one.

    The token batch is fixed and reused every step. A warm-up step runs
    outside the timing. ``stats`` (a :class:`stats.WorkloadStats`) turns
    on the windowed telemetry: every ``stats_every`` steps the loop reads
    the loss (one host sync per window) and records the window's steps/s
    and, on a mesh, the collective-wait fraction; ``phase_stats`` adds one
    instrumented step per window, and ``serve`` (a
    :class:`serve.ServeStats`) the request-level view of each window. On
    a mesh every rank passes the same ``stats_every`` and ``phase_stats``
    (the windows and probes issue collectives in lockstep).

    ``checkpoint_dir`` runs the checkpointed loop instead
    (:func:`_run_checkpointed`): it resumes from the newest step saved
    there and runs on to global step ``steps``, saving every
    ``checkpoint_every`` steps and at the end.
    """
    if mesh is not None:
        dp, tp, sp, pp, ep = mesh.dp, mesh.tp, mesh.sp, mesh.pp, mesh.ep
        device = mesh.device
    requested = torch.device(device or "cuda")
    device = resolve_device(requested.type, requested.index or 0)
    # f32 products must be f32, as on the reference, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    seq = seq or cfg.max_seq
    if seq > cfg.max_seq:
        # Extend the RoPE table to the requested length (exact, not
        # extrapolation: positions are computed from max_seq).
        cfg = dataclasses.replace(cfg, max_seq=seq)
    if attn not in ("xla", "flash"):
        raise ValueError(f"unknown attn impl: {attn!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if batch % dp:
        raise ValueError(f"batch ({batch}) must divide by dp ({dp})")
    if dp > 1 and (batch // dp) % grad_accum:
        raise ValueError(
            f"per-data-shard batch ({batch // dp}) must divide by "
            f"grad_accum ({grad_accum})"
        )
    if batch % grad_accum:
        raise ValueError(
            f"batch ({batch}) must divide by grad_accum ({grad_accum})"
        )
    if zero1 and dp < 2:
        raise ValueError("zero1 shards optimizer state over dp; it needs a "
                         "mesh with dp > 1")
    check_layout(cfg, seq=seq, dp=dp, tp=tp, sp=sp, pp=pp, ep=ep,
                 sp_layout=sp_layout, loss_chunk=loss_chunk, grad_accum=grad_accum,
                 microbatches=microbatches, interleave=interleave,
                 per_shard=batch // dp)
    if pp == 1:
        microbatches = interleave = 1  # no pipeline: not used
    if serve is not None and checkpoint_dir is not None:
        # The checkpointed loop records per step; the serving window
        # shape assumes the windowed loop.
        raise ValueError("serve telemetry composes with the windowed "
                         "loop, not checkpoint_dir")

    if mesh is None and dp * tp * sp * pp * ep > 1:
        mesh = mesh_mod.make_mesh(dp, tp, sp, pp, ep, device=device)

    generator = torch.Generator(device=device).manual_seed(seed)
    model = _build_model(cfg, params, generator, device, mesh, interleave)
    if tokens is None:
        tokens = torch.randint(
            0, cfg.vocab, (batch, seq + 1), generator=generator, device=device
        )
    else:
        tokens = torch.tensor(tokens, dtype=torch.long, device=device)
        if tuple(tokens.shape) != (batch, seq + 1):
            raise ValueError(
                f"tokens must be [batch, seq + 1] = {(batch, seq + 1)}, got "
                f"{tuple(tokens.shape)}"
            )
    if mesh is not None:
        rows, cols = batch // dp, seq // sp
        start = mesh.coords["seq"] * cols
        tokens = tokens[mesh.coords["data"] * rows:][:rows, start:start + cols + 1]
    optimizer = build_optimizer(model.named_parameters(), model, zero1)

    from tpumon.workload_torch.parallel import pipeline

    attn_impl = forward_fn = None
    if pp > 1:
        forward_fn = pipeline.make_pipelined_forward(
            model, microbatches=microbatches, interleave=interleave,
            remat=remat, sp_layout=sp_layout, attn=attn)
    else:
        attn_impl = pipeline.make_attn_impl(mesh, sp_layout=sp_layout, attn=attn)
    step = make_train_step(
        model, optimizer, attn_impl, grad_accum=grad_accum, remat=remat,
        with_grad_norm=with_grad_norm, loss_chunk=loss_chunk,
        forward_fn=forward_fn,
    )

    run_devices = [device] if mesh is None else mesh_mod.rank_cards(mesh)
    flops_per_step = flops_mod.train_flops_per_step(cfg, batch, seq)
    if stats is not None:
        stats.configure(
            flops_per_step=flops_per_step,
            tokens_per_step=batch * seq,
            peak_flops_total=flops_mod.peak_flops_total(run_devices),
            axes={"dp": dp, "tp": tp, "sp": sp, "pp": pp, "ep": ep},
        )
    phase_probe = None
    if stats is not None and phase_stats:
        phase_probe = _make_phase_probe(
            model, optimizer, attn_impl, remat, loss_chunk, grad_accum, zero1,
            forward_fn,
        )
    result = RunResult(losses=[], steps_per_sec=0.0, dp=dp, tp=tp, sp=sp, pp=pp,
                       ep=ep, model_flops_per_step=flops_per_step)
    if checkpoint_dir is not None:
        _run_checkpointed(
            step, model, optimizer, tokens, steps, checkpoint_dir,
            checkpoint_every, result, stats=stats, phase_probe=phase_probe,
            with_grad_norm=with_grad_norm, zero1=zero1,
            schedule=dict(interleave=interleave, microbatches=microbatches),
        )
    else:
        _run_windowed(step, model, tokens, steps, result, stats=stats,
                      stats_every=stats_every, phase_probe=phase_probe,
                      serve=serve, batch=batch, with_grad_norm=with_grad_norm)
    result.mfu = flops_mod.mfu(cfg, batch, seq, result.steps_per_sec, run_devices)
    result.moment_bytes = _moment_bytes(model, optimizer)
    return result


def check_layout(cfg, *, seq: int, dp: int = 1, tp: int = 1, sp: int = 1,
                 pp: int = 1, ep: int = 1, sp_layout: str = "contiguous",
                 loss_chunk: int = 0, grad_accum: int = 1, microbatches: int = 1,
                 interleave: int = 1, per_shard: int | None = None) -> None:
    """A run's refusals, before anything is built (the reference's words
    where it has them): ``cfg``'s family's, the fused loss's, sp's and pp's
    (``per_shard``: the rows of a data rank)."""
    family.of(cfg).check(cfg, dp=dp, tp=tp, sp=sp, pp=pp, ep=ep, seq=seq,
                         sp_layout=sp_layout, loss_chunk=loss_chunk,
                         grad_accum=grad_accum)
    if loss_chunk < 0:
        raise ValueError(f"loss_chunk must be >= 1, got {loss_chunk}")
    if loss_chunk and seq % loss_chunk:
        raise ValueError(f"seq ({seq}) must divide by loss_chunk ({loss_chunk})")
    if sp > 1:
        if seq % sp:
            raise ValueError(f"seq ({seq}) must divide by sp ({sp})")
        if sp_layout not in ("contiguous", "zigzag"):
            raise ValueError(f"unknown sp_layout: {sp_layout!r}")
        if sp_layout == "zigzag" and seq % (2 * sp):
            raise ValueError(
                f"zigzag needs an even local shard: seq ({seq}) must "
                f"divide by 2*sp ({2 * sp})"
            )
    if pp > 1 and grad_accum > 1:
        raise ValueError("grad_accum composes with dp/tp/sp/ep, not pp")
    if loss_chunk and (sp > 1 or pp > 1):
        raise ValueError(
            "loss_chunk fuses the dense model's unembed into the "
            "loss; it composes with dp/tp (not MoE, pp, or sp — the "
            "seq-chunk reshape would fight the seq sharding)"
        )
    if pp > 1:
        from tpumon.workload_torch.parallel import pipeline

        pipeline.check_schedule(cfg.n_layers, pp, interleave, microbatches)
        if per_shard is not None:
            pipeline.check_batch(per_shard, microbatches)


def _run_windowed(step, model, tokens, steps, result, *, stats, stats_every,
                  phase_probe, serve, batch, with_grad_norm) -> None:
    """The traffic generator's loop: a warm-up step, then ``steps`` timed
    steps that sync once per stats window. Fills ``result``'s losses,
    grad norms and steps/s.

    On a mesh each window also records the collective-wait fraction: the
    latency the rank's counters read over the window, over the window's
    wall time (the reference's formula over the one rank whose calls the
    counters time). The phase probe's own collectives are kept out of the
    next window's numerator, as the reference does."""
    mesh = model.mesh
    counters = None if mesh is None else mesh.counters
    wait_base: list[float] = []

    def record_wait(window_s: float) -> None:
        if counters is None:
            return
        counters.flush()
        cur = counters.total_latency_us()
        if wait_base and window_s > 0:
            stats.record_collective_wait(
                max(0.0, cur - wait_base[0]) / 1e6 / window_s
            )
        wait_base[:] = [cur]  # window_s <= 0 seeds the baseline only

    # Warm-up outside the timed window.
    loss, gnorm = step(tokens)
    result.losses.append(loss.item())
    if with_grad_norm:
        result.grad_norms.append(gnorm.item())

    t0 = time.perf_counter()
    if stats is None:
        for _ in range(steps):
            loss, gnorm = step(tokens)
    else:
        window_t0, done = t0, 0
        record_wait(0.0)
        for i in range(1, steps + 1):
            loss, gnorm = step(tokens)
            if i % max(stats_every, 1) == 0 or i == steps:
                lv = loss.item()  # one host-read sync per window
                now = time.perf_counter()
                stats.record(lv, i - done, now - window_t0)
                if serve is not None:
                    _record_serve_window(serve, batch, i - done, now - window_t0)
                record_wait(now - window_t0)
                if phase_probe is not None:
                    try:
                        stats.record_phases(phase_probe(tokens))
                    except Exception:
                        if mesh is not None:
                            raise  # the other ranks are inside its collectives
                        # Telemetry must never kill the traffic generator.
                        log.exception("phase probe failed")
                        phase_probe = None
                    record_wait(0.0)
                window_t0, done = time.perf_counter(), i
    # The barrier is a host read of the last loss.
    final_loss = loss.item()
    elapsed = time.perf_counter() - t0
    if counters is not None:
        counters.flush()
    result.losses.append(final_loss)
    result.steps_per_sec = steps / elapsed if elapsed > 0 else float("inf")
    if with_grad_norm:
        result.grad_norms.append(gnorm.item())
        result.grad_norm = result.grad_norms[-1]


def _run_checkpointed(
    step, model, optimizer, tokens, steps, checkpoint_dir, checkpoint_every,
    result, *, stats=None, phase_probe=None, with_grad_norm=False,
    zero1=False, schedule=None,
) -> None:
    """Checkpoint/resume loop around the train step; fills ``result``.

    Separate from the windowed loop on purpose: it reads the loss every
    step (one host sync each) and touches disk, so the traffic
    generator's loop keeps its sync-free timing. It restores the newest
    saved step (a failed restore raises), runs global steps
    ``start_step .. steps - 1`` with one loss each, saves every
    ``checkpoint_every`` steps and at the end (never a step already
    saved), keeps the 2 newest, and runs one phase probe at the end. On a
    mesh every rank saves and restores its own shard
    (:class:`checkpoint.CheckpointStore`); a resume needs the same
    dp×tp×sp×pp×ep×zero1 and pipeline ``schedule`` (its interleave and
    microbatches).
    """
    from tpumon.workload_torch.checkpoint import CheckpointStore

    mesh = model.mesh
    store = CheckpointStore(checkpoint_dir, mesh=mesh, zero1=zero1,
                            **(schedule or {}))
    device = next(model.parameters()).device
    start_step = 0
    latest = store.latest_step()
    if latest is not None:
        restore_t0 = time.perf_counter()
        store.restore(latest, model, optimizer, device)
        start_step = latest
        if stats is not None:
            # The restore span and the training-global step offset the
            # lifecycle plane reads (tpu_step_checkpoint_seconds{op=
            # "restore"} is the restore-storm signature).
            stats.record_checkpoint("restore", time.perf_counter() - restore_t0)
            stats.set_start_step(start_step)
        log.info("resumed from %s at step %d", checkpoint_dir, latest)

    losses = result.losses
    timed, timed_steps = 0.0, 0
    saved_at = start_step if latest is not None else -1
    for i in range(start_step, steps):
        t0 = time.perf_counter()
        loss, gnorm = step(tokens)
        losses.append(loss.item())  # one host sync per step
        dt = time.perf_counter() - t0
        if with_grad_norm:
            result.grad_norms.append(gnorm.item())
        if mesh is not None:
            mesh.counters.flush()
        if i > start_step:  # the first iteration is the warm-up
            timed += dt
            timed_steps += 1
            if stats is not None:
                stats.record(losses[-1], 1, dt)
        elif stats is not None:
            # The warm-up step still happened: it advances the global step
            # counter (seconds=0 publishes no rate).
            stats.record(losses[-1], 1, 0.0)
        done = i + 1
        if (checkpoint_every and done % checkpoint_every == 0) or done == steps:
            if done != saved_at:
                save_t0 = time.perf_counter()
                store.save(done, model, optimizer)
                saved_at = done
                if stats is not None:
                    stats.record_checkpoint("save", time.perf_counter() - save_t0)
        if phase_probe is not None and done == steps:
            # One instrumented step at the end of the run: this loop
            # already syncs every step, so once is the honest budget.
            try:
                stats.record_phases(phase_probe(tokens))
            except Exception:
                if mesh is not None:
                    raise  # the other ranks are inside its collectives
                # Telemetry must never kill the traffic generator.
                log.exception("phase probe failed")
    if not losses:
        log.info("checkpoint at %s already covers %d steps; nothing to run",
                 checkpoint_dir, steps)
    # 0.0, not inf, when no step ran outside the warm-up: no throughput.
    result.steps_per_sec = timed_steps / timed if timed > 0 else 0.0
    result.start_step = start_step
    if result.grad_norms:
        result.grad_norm = result.grad_norms[-1]


def _log_launches() -> None:
    """One log line with this process's flash launches, by kernel and by
    the tiles they ran (``ops.flash_attention`` counters)."""
    from tpumon.workload_torch.ops import flash_attention as fa

    log.info("flash launches %s by tiles %s", json.dumps(fa.launches),
             json.dumps(fa.tile_launches))


def _install_sigterm_marker(stats, grace_s: float | None = None) -> None:
    """Flag a SIGTERM on the metrics page for the preemption grace
    window, then exit with the conventional 143.

    The lifecycle plane probes the workload page and needs to SEE
    ``tpu_step_terminating 1`` inside the Kubernetes grace period to
    classify the event as a clean preemption. The handler marks the page
    immediately and defers the exit by TPUMON_STEP_TERM_GRACE_S (default
    5 s, clamped ≥0). A second SIGTERM exits immediately.
    """
    import signal
    import threading

    if grace_s is None:
        raw = os.environ.get("TPUMON_STEP_TERM_GRACE_S", "5")
        try:
            grace_s = max(0.0, float(raw))
        except ValueError:
            grace_s = 5.0

    state = {"seen": False}

    def _exit_after_grace():
        _log_launches()
        os._exit(143)

    def _on_term(signum, frame):
        if state["seen"]:
            os._exit(143)
        state["seen"] = True
        stats.mark_terminating()
        timer = threading.Timer(grace_s, _exit_after_grace)
        timer.daemon = True  # a finished run must not wait on the timer
        timer.start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        # Not the main thread (embedders driving main() from a worker).
        log.debug("SIGTERM marker not installed (not main thread)")


def build_parser() -> argparse.ArgumentParser:
    families = family.families()
    presets = dict.fromkeys(p for fam in families.values() for p in fam.presets)
    parser = argparse.ArgumentParser(prog="tpumon-workload-torch")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=None)
    parser.add_argument(
        "--preset", choices=tuple(presets), default="tiny",
        help="model size: tiny/small for quick runs; medium (~0.67B) is the "
        "main path's model at seq 4096 (pair with --attn flash, --remat "
        "and --grad-accum); llama3-8b is Llama-3-8B's shape; moe small is "
        "0.153B, 8 experts top-2; v2-lite-share (--model deepseek_v2) is one "
        "EP8 card's share of DeepSeek-V2-Lite (2.744B: all 27 layers, routed "
        "experts 0-7 of 64, an eighth of the vocabulary)",
    )
    parser.add_argument(
        "--model", choices=tuple(families), default="llama",
        help="the model family (models/family.py) and its presets: " + "; ".join(
            f"{name}: {'/'.join(fam.presets)}" for name, fam in families.items())
        + " (moe small, deepseek_v2 v2-lite-share: pair with --seq 4096 "
        "--attn flash --remat)",
    )
    for axis in ("dp", "tp", "sp", "pp", "ep"):
        parser.add_argument(f"--{axis}", type=int, default=1)
    parser.add_argument("--sp-layout", choices=("contiguous", "zigzag"),
                        default="contiguous")
    parser.add_argument(
        "--microbatches", type=int, default=2,
        help="pipeline microbatches a data rank's rows split into (--pp > 1)")
    parser.add_argument(
        "--interleave", type=int, default=1,
        help="layer chunks a pipeline stage holds: 1 is GPipe, more the "
        "circular schedule (--pp > 1; n_layers is rounded up to a multiple "
        "of pp·interleave)")
    parser.add_argument(
        "--capacity-factor", type=float, default=None,
        help="MoE expert capacity factor (default: the preset's 2.0)",
    )
    parser.add_argument(
        "--zero1", action="store_true",
        help="ZeRO-1: each data rank keeps and steps the AdamW moments of "
        "1/dp of every parameter and all-gathers the updated slices; needs "
        "--dp > 1",
    )
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="save to and resume from this directory (one subdirectory "
        "per step, the 2 newest kept); --steps counts global steps",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="save every this many steps as well as at the end (0 = end only)",
    )
    parser.add_argument(
        "--hlo-raw-dump", default=None,
        help="write one JSON line per collective rank 0 issues (op, bytes, "
        "µs, rank) to this file, up to 4096 lines",
    )
    parser.add_argument(
        "--coordinator", default=None,
        help="host:port where the hosts of a multi-host job meet (global "
        "rank 0, on process 0, hosts the group's store there); this "
        "process is then one host and starts its share of the mesh's ranks; "
        "pair with --num-processes and --process-id",
    )
    parser.add_argument("--num-processes", type=int, default=1,
                        help="hosts in the job (with --coordinator)")
    parser.add_argument(
        "--process-id", type=int, default=None,
        help="this host's index; defaults to $TPU_WORKER_ID or 0",
    )
    parser.add_argument(
        "--grad-accum",
        type=int,
        default=1,
        help="gradient-accumulation chunks per optimizer step (strided rows)",
    )
    parser.add_argument(
        "--remat",
        action="store_true",
        help="recompute each layer's activations in the backward pass "
        "(torch.utils.checkpoint per block)",
    )
    parser.add_argument(
        "--loss-chunk",
        type=int,
        default=0,
        help="fuse the unembed projection into the loss in sequence "
        "chunks of this many tokens (0 = off): the [B,S,vocab] f32 "
        "logits never materialize",
    )
    parser.add_argument(
        "--grad-norm",
        action="store_true",
        help="compute the global gradient L2 norm every step (under --tp, "
        "one more all-reduce over model) and report it",
    )
    parser.add_argument(
        "--attn",
        choices=("xla", "flash"),
        default="xla",
        help="attention core: 'xla' is the plain einsum path, 'flash' the "
        "hand-written Hopper kernels (ops.flash_attention)",
    )
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=0,
        help="serve the tpu_step_* / workload_* page on this port (0 = off)",
    )
    parser.add_argument(
        "--stats-every",
        type=int,
        default=20,
        help="steps per live-telemetry window (one host sync per window)",
    )
    parser.add_argument(
        "--phase-stats",
        action="store_true",
        help="run ONE instrumented step per stats window (fwd / fwd+bwd "
        "/ optimizer timed separately) and publish tpu_step_phase_seconds; "
        "needs --metrics-port",
    )
    parser.add_argument(
        "--serve",
        action="store_true",
        help="publish request-level serving telemetry (tpu_serve_*): each "
        "sequence in the batch counts as one request per step and "
        "per-step latency is the TTFT proxy; needs --metrics-port",
    )
    parser.add_argument(
        "--serve-slo-ms",
        type=float,
        default=500.0,
        help="TTFT SLO threshold for --serve goodput accounting, in "
        "milliseconds (0 disables the attainment ratio)",
    )
    parser.add_argument(
        "--platform",
        choices=PLATFORMS,
        default="cuda",
        help="where to run: the card (default; raises when there is no "
        "Hopper card) or the host cpu. --dp/--tp/--sp/--pp/--ep start one process "
        "per mesh position: over nccl when each has a card of its own, over "
        "gloo when they share one or run on the host",
    )
    return parser


def model_config(args: argparse.Namespace):
    """The config that ``--model``, ``--preset`` and ``--capacity-factor``
    of parsed :func:`build_parser` arguments name: a preset the family
    lacks is ignored, with a warning, for the family's first."""
    presets = family.families()[args.model].presets
    if args.preset not in presets:
        log.warning("--model %s has %s presets; ignoring --preset %s",
                    args.model, "/".join(presets), args.preset)
    cfg = presets.get(args.preset, next(iter(presets.values())))()
    if args.capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=args.capacity_factor)
    return cfg


def round_layers(cfg, pp: int, interleave: int):
    """``cfg`` with ``n_layers`` rounded up to a multiple of pp·interleave
    under pp: a stage needs a whole number of layers per chunk, and the
    CLI works as a traffic generator at any --pp/--interleave."""
    groups = pp * interleave
    if pp < 2 or groups < 1 or cfg.n_layers % groups == 0:
        return cfg
    return dataclasses.replace(cfg, n_layers=-(-cfg.n_layers // groups) * groups)


def main(argv: list[str] | None = None) -> int:
    """The CLI. With ``--dp``/``--tp``/``--sp``/``--pp``/``--ep`` > 1 and no ``RANK`` in the
    environment it starts one process per mesh position
    (``parallel.launch``), each of which re-enters it as its rank, and
    returns the worst of their exit codes; with ``RANK`` set (by that
    launcher or an ``env://`` one) it runs as that rank."""
    return _main(sys.argv[1:] if argv is None else list(argv))


def _rank_process(argv: list[str], env: dict, results) -> None:
    """A spawned rank: :func:`main` with the launcher's environment; its
    report goes back on ``results``."""
    os.environ.update(env)
    sys.exit(_main(argv, results))


def _launch_mesh(argv: list[str], args, world: int, num_processes: int,
                 process_id: int) -> int:
    """The launching process of a mesh, or of this host's share of it:
    it checks the platform, builds the kernels once (the ranks must not
    race one ``nvcc`` each; two hosts on one machine each build, and the
    build's rename into place keeps that safe), starts the ranks and logs
    each rank's report."""
    from tpumon.workload_torch.parallel import launch

    device = resolve_device(args.platform)
    if device.type == "cuda" and args.attn == "flash":
        from tpumon.workload_torch.ops import _build

        _build.build()
    if args.coordinator:
        log.info("distributed: process %d/%d, %d local / %d global ranks",
                 process_id, num_processes, world // num_processes, world)
    rc, reports = launch.launch(_rank_process, argv, world,
                                coordinator=args.coordinator,
                                num_processes=num_processes,
                                process_id=process_id)
    for rank in sorted(reports):
        log.info("rank %d report %s", rank, json.dumps(reports[rank]))
    return rc


def _main(argv: list[str], results=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # The reference's multi-host refusals, in its order, before any rank
    # starts.
    num_processes = args.num_processes if args.coordinator else 1
    total = max(args.dp * args.tp * args.sp * args.pp * args.ep, 1)
    if total % max(num_processes, 1):
        parser.error(
            f"--dp*--tp*--sp*--pp*--ep ({total}) must be divisible by "
            f"--num-processes ({num_processes})"
        )
    if args.num_processes > 1 and not args.coordinator:
        parser.error("--num-processes > 1 requires --coordinator")
    process_id = args.process_id
    if process_id is None:
        # $TPU_WORKER_ID names this host only in a job of several, as the
        # reference reads it (under --coordinator): one host is host 0,
        # whatever a process that loaded libtpu left in the variable.
        raw = os.environ.get("TPU_WORKER_ID", "0") if args.coordinator else "0"
        try:
            process_id = int(raw or 0)
        except ValueError:
            parser.error(f"$TPU_WORKER_ID ({raw!r}) is not a host index; "
                         "pass --process-id")
    if args.coordinator and not 0 <= process_id < num_processes:
        parser.error(f"--process-id ({process_id}) must be in [0, "
                     f"--num-processes ({num_processes}))")
    if args.serve and not args.metrics_port:
        parser.error("--serve publishes tpu_serve_* on the metrics "
                     "port; it needs --metrics-port")
    if args.serve and args.checkpoint_dir:
        parser.error("--serve composes with the windowed loop, not "
                     "--checkpoint-dir")
    for name, fam in family.families().items():
        if args.preset in fam.own_presets and args.model != name:
            parser.error(f"--preset {args.preset} requires --model {name}")
    capacity = [name for name, fam in family.families().items()
                if "capacity_factor" in {f.name for f in dataclasses.fields(fam.config)}]
    if args.capacity_factor is not None and args.model not in capacity:
        parser.error(f"--capacity-factor requires --model {' or '.join(capacity)}")
    if min(args.dp, args.tp, args.sp, args.pp, args.ep) < 1:
        parser.error("--dp, --tp, --sp, --pp and --ep must be >= 1")
    if args.zero1 and args.dp < 2:
        parser.error("--zero1 shards the optimizer state over dp; it needs "
                     "--dp > 1")
    world = args.dp * args.tp * args.sp * args.pp * args.ep
    as_rank = world > 1 and "RANK" in os.environ
    rank = int(os.environ["RANK"]) if as_rank else 0
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s " + (f"rank{rank} " if as_rank else "") + "%(message)s",
    )
    cfg = round_layers(model_config(args), args.pp, args.interleave)
    if not as_rank and cfg.n_layers != model_config(args).n_layers:
        log.info("rounding n_layers %d → %d for pp=%d interleave=%d",
                 model_config(args).n_layers, cfg.n_layers, args.pp,
                 args.interleave)
    try:  # before any rank starts
        check_layout(cfg, seq=args.seq or cfg.max_seq, dp=args.dp, tp=args.tp,
                     sp=args.sp, pp=args.pp, ep=args.ep, sp_layout=args.sp_layout,
                     loss_chunk=args.loss_chunk, grad_accum=args.grad_accum,
                     microbatches=args.microbatches, interleave=args.interleave,
                     per_shard=args.batch // args.dp)
    except ValueError as exc:
        parser.error(str(exc))
    if world > 1 and not as_rank:
        return _launch_mesh(argv, args, world, num_processes, process_id)

    mesh = None
    counters = None
    if world > 1:
        import torch.distributed as dist

        from tpumon.workload_torch.collective_counters import CollectiveCounters

        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but "
                             f"--dp*--tp*--sp*--pp*--ep is {world}")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        # This host's cores over this host's ranks, unless the caller
        # pinned the threads (OMP_NUM_THREADS, which torch reads itself).
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
        device = mesh_mod.rank_device(args.platform, local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh_mod.init_group(mesh_mod.env_store(rank, world), rank, world,
                            device, local_world)
        counters = CollectiveCounters(
            raw_path=args.hlo_raw_dump if rank == 0 else None, rank=rank)
        mesh = mesh_mod.make_mesh(args.dp, args.tp, args.sp, args.pp, args.ep,
                                  device=device, counters=counters,
                                  local_world=local_world)
    else:
        device = resolve_device(args.platform)

    server = None
    stats = None
    serve_stats = None
    if args.metrics_port and rank != 0:
        # The windows and phase probes issue collectives, so every rank
        # runs them; only rank 0 publishes. Every rank defers its exit on
        # SIGTERM by the same grace, so its peers keep stepping (and rank
        # 0's page shows the flag) through the window.
        from tpumon.workload_torch.stats import WorkloadStats

        stats = WorkloadStats()
        _install_sigterm_marker(stats)
    elif args.metrics_port:
        from prometheus_client.registry import CollectorRegistry

        from tpumon.exporter.server import (
            ExporterServer,
            _make_app,
            registry_renderer,
        )
        from tpumon.exporter.telemetry import SelfTelemetry
        from tpumon.workload_torch.stats import StatsCollector, WorkloadStats

        registry = CollectorRegistry()
        if counters is not None:
            from tpumon.workload_torch.collective_counters import CountersCollector

            registry.register(CountersCollector(counters))
        stats = WorkloadStats()
        registry.register(StatsCollector(stats))
        if args.serve:
            from tpumon.workload_torch.serve import ServeCollector, ServeStats

            serve_stats = ServeStats()
            serve_stats.configure(
                slo_threshold_s=(
                    args.serve_slo_ms / 1000.0 if args.serve_slo_ms > 0 else None
                )
            )
            registry.register(ServeCollector(serve_stats))
        telemetry = SelfTelemetry(registry)
        telemetry.last_poll.set(time.time())
        # No device poll loop here; the serving process is the liveness
        # (without this the shared tpumon_up gauge reads 0 forever).
        telemetry.up.set(1)
        server = ExporterServer(
            _make_app(registry_renderer(registry), telemetry, lambda: (True, "ok\n")),
            "0.0.0.0",
            args.metrics_port,
        )
        server.start()
        log.info("workload counters at %s/metrics", server.url)
        _install_sigterm_marker(stats)

    from tpumon.workload_torch.ops import flash_attention as fa

    try:
        fa.reset_launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        result = run(
            cfg,
            steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            grad_accum=args.grad_accum,
            remat=args.remat,
            with_grad_norm=args.grad_norm,
            loss_chunk=args.loss_chunk,
            zero1=args.zero1,
            sp_layout=args.sp_layout,
            microbatches=args.microbatches,
            interleave=args.interleave,
            mesh=mesh,
            attn=args.attn,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            stats=stats,
            stats_every=args.stats_every,
            phase_stats=args.phase_stats,
            serve=serve_stats,
            device=device,
        )
        if rank == 0:
            log.info(
                "loss %.4f → %.4f | %.2f steps/s | %.1f GFLOP/step | MFU %s | "
                "mesh dp=%d tp=%d sp=%d pp=%d ep=%d | device=%s",
                result.losses[0] if result.losses else float("nan"),
                result.losses[-1] if result.losses else float("nan"),
                result.steps_per_sec,
                result.model_flops_per_step / 1e9,
                f"{result.mfu:.2%}" if result.mfu is not None else "n/a (no peak)",
                result.dp,
                result.tp,
                result.sp,
                result.pp,
                result.ep,
                torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            )
            _log_launches()
        if mesh is not None:
            report = {
                "rank": rank, "coords": mesh.coords, "backend": mesh.backend,
                "device": str(device), "losses": result.losses,
                "grad_norms": result.grad_norms,
                "steps_per_sec": result.steps_per_sec, "mfu": result.mfu,
                "start_step": result.start_step,
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else None),
                "launches": dict(fa.launches),
                "tile_launches": dict(fa.tile_launches),
                "collectives": counters.detailed_snapshot(),
                "moment_bytes": sum(result.moment_bytes.values()),
            }
            log.info("collectives %s", report["collectives"]["counts"])
            if results is not None:
                results.put((rank, report))
    finally:
        if server is not None:
            server.close()
        if counters is not None:
            counters.close()
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
