"""Training harness of the port: the dense Llama and MoE train steps on one card.

The counterpart of ``tpumon/workload/harness.py`` for the single-device
paths: next-token cross-entropy (plus the weighted GShard aux loss for
MoE), optional strided gradient accumulation, remat and a chunked loss,
AdamW with optax's defaults, the windowed loop that publishes
``tpu_step_*`` (and, with ``--serve``, ``tpu_serve_*``) on
``--metrics-port`` for the monitor to read, and a checkpointed loop
(``--checkpoint-dir``) that resumes from the newest saved step.

PyTorch runs eagerly, so there is no jit: parameters and optimizer state
are updated in place, and the loop reads the loss on the host once per
stats window. ``--attn flash`` runs attention on the hand-written Hopper
kernels of ``ops/flash_attention.py``.

CLI:  python -m tpumon.workload_torch.harness --steps 20
      python -m tpumon.workload_torch.harness --model moe --preset small
      python -m tpumon.workload_torch.harness --checkpoint-dir ckpt --steps 6
      (``--platform cpu`` runs on the host; the default is the card)
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import torch
from torch.utils.checkpoint import checkpoint

from tpumon.workload_torch import flops as flops_mod
from tpumon.workload_torch.models import moe as moe_mod
from tpumon.workload_torch.models.llama import LlamaConfig, from_jax_params, init_params
from tpumon.workload_torch.models.moe import Moe, MoeConfig
from tpumon.workload_torch.platform import PLATFORMS, resolve_device

log = logging.getLogger(__name__)

AUX_LOSS_WEIGHT = 0.01  # GShard load-balancing loss weight (MoE only)


def _chunk_nll_sum(xc, unembed_w, tc, dtype):
    logits = (xc @ unembed_w.to(dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tc[..., None]).sum()


def _chunked_nll(x, unembed_w, targets, chunk, dtype):
    """Mean next-token NLL with the unembed fused into the loss, one
    sequence chunk at a time: x [B,S,D] (final-norm hidden), targets
    [B,S] → scalar f32. Each chunk is checkpointed, so the backward
    recomputes its logits and the full [B, S, vocab] f32 logits never
    exist at once."""
    B, S, _ = x.shape
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_nll_sum, x[:, i:i + chunk], unembed_w,
            targets[:, i:i + chunk], dtype, use_reentrant=False,
        )
    return total / (B * S)


def loss_fn(model, tokens, attn_impl=None, remat=False, loss_chunk=0):
    """Next-token cross-entropy; inputs [B, S], targets are the shift-by-1.
    A :class:`Moe` adds ``AUX_LOSS_WEIGHT`` × its aux loss. ``loss_chunk``
    (dense model only) fuses the unembed projection into the loss in
    sequence chunks of that many tokens (:func:`_chunked_nll`)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if isinstance(model, Moe):
        logits, aux = model(inputs, attn_impl, remat)
        return _mean_nll(logits, targets) + AUX_LOSS_WEIGHT * aux
    if loss_chunk:
        x = model(inputs, attn_impl, remat, unembed=False)
        return _chunked_nll(x, model.unembed, targets, loss_chunk, model.cfg.dtype)
    return _mean_nll(model(inputs, attn_impl, remat), targets)


def _mean_nll(logits, targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def make_optimizer(params) -> torch.optim.Optimizer:
    """AdamW with optax.adamw(1e-3)'s defaults. weight_decay is optax's
    1e-4; torch's own default of 1e-2 would train a different model."""
    return torch.optim.AdamW(
        params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )


def make_train_step(
    model,
    optimizer,
    attn_impl=None,
    grad_accum: int = 1,
    remat: bool = False,
    with_grad_norm: bool = False,
    loss_chunk: int = 0,
):
    """One optimizer step ``step(tokens) -> (loss, grad_norm)`` as device
    tensors (no host sync). ``grad_accum > 1`` splits the batch into that
    many strided chunks (chunk a takes rows a, a+A, a+2A, …, as the
    reference does) and averages their gradients before the one update.
    ``grad_norm`` is the global gradient L2 norm when ``with_grad_norm``,
    else NaN (the whole-tree reduction is opt-in)."""
    params = list(model.parameters())

    def grad_of(tokens):
        loss = loss_fn(model, tokens, attn_impl, remat, loss_chunk)
        loss.backward()
        return loss.detach()

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = grad_of(tokens)
        else:
            B = tokens.shape[0]
            chunks = tokens.reshape(B // grad_accum, grad_accum, -1).transpose(0, 1)
            loss = sum(grad_of(chunk) for chunk in chunks) / grad_accum
            for p in params:
                p.grad.div_(grad_accum)
        if with_grad_norm:
            gnorm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(p.grad) for p in params])
            )
        else:
            gnorm = torch.full((), float("nan"), device=loss.device)
        optimizer.step()
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
    #: Model FLOPs utilization vs the device's published bf16 peak; None
    #: when the peak is unknown (CPU) or throughput absent.
    mfu: float | None = None
    #: Global gradient L2 norm at the final step (with_grad_norm only).
    grad_norm: float | None = None


def _clone_optimizer_state(state_dict: dict) -> dict:
    state = {
        idx: {key: (val.clone() if torch.is_tensor(val) else val)
              for key, val in per_param.items()}
        for idx, per_param in state_dict["state"].items()
    }
    return {"state": state, "param_groups": state_dict["param_groups"]}


def _make_phase_probe(model, optimizer, attn_impl, remat, loss_chunk,
                      grad_accum: int = 1):
    """One instrumented step split into timed fwd / fwd+bwd / optimizer
    phases (``--phase-stats``), run at most once per stats window. It
    leaves the live parameters, their ``.grad`` and the optimizer state
    untouched: gradients come from ``torch.autograd.grad``, and the timed
    optimizer update runs on clones of the parameters and the state.
    bwd is the grad pass minus the forward pass.

    Under ``grad_accum > 1`` the probe times ONE strided chunk and scales
    fwd/bwd by the chunk count, as the reference does: the real step
    never runs a full-batch backward."""
    params = list(model.parameters())
    chunks = max(1, int(grad_accum))
    device = params[0].device

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def probe(tokens) -> dict[str, float]:
        if chunks > 1:
            tokens = tokens[::chunks]
        t0 = clock()
        with torch.no_grad():
            loss_fn(model, tokens, attn_impl, remat, loss_chunk)
        fwd_s = clock() - t0
        t0 = clock()
        loss = loss_fn(model, tokens, attn_impl, remat, loss_chunk)
        grads = torch.autograd.grad(loss, params)
        grad_s = clock() - t0
        scratch = [p.detach().clone().requires_grad_(True) for p in params]
        for s, g in zip(scratch, grads):
            s.grad = g
        opt = make_optimizer(scratch)
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


def _build_model(cfg, params, generator, device):
    """The seeded model for ``cfg``'s family, or ``params`` (a model, or
    the reference's parameter tree as numpy arrays) on ``device``."""
    is_moe = isinstance(cfg, MoeConfig)
    if params is None:
        return (moe_mod.init_params if is_moe else init_params)(cfg, generator)
    if isinstance(params, torch.nn.Module):
        return params.to(device)
    return (moe_mod.from_jax_params if is_moe else from_jax_params)(
        cfg, params, device
    )


def run(
    cfg: LlamaConfig | MoeConfig,
    *,
    steps: int = 10,
    batch: int = 8,
    seq: int | None = None,
    grad_accum: int = 1,
    remat: bool = False,
    with_grad_norm: bool = False,
    loss_chunk: int = 0,
    seed: int = 0,
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

    ``cfg`` is a :class:`LlamaConfig` or a :class:`MoeConfig`, and picks
    the model. ``device=None`` means the card (``cuda``); pass ``"cpu"``
    for the host. ``attn="flash"`` runs attention on the flash kernels.
    ``params`` (a model, or the reference's parameter tree as numpy
    arrays) and ``tokens`` ([batch, seq + 1] integers) replace the seeded
    ones, so a test can give this run and the reference the same weights
    and data.

    The token batch is fixed and reused every step. A warm-up step runs
    outside the timing. ``stats`` (a :class:`stats.WorkloadStats`) turns
    on the windowed telemetry: every ``stats_every`` steps the loop reads
    the loss (one host sync per window) and records the window's steps/s;
    ``phase_stats`` adds one instrumented step per window, and ``serve``
    (a :class:`serve.ServeStats`) the request-level view of each window.

    ``checkpoint_dir`` runs the checkpointed loop instead
    (:func:`_run_checkpointed`): it resumes from the newest step saved
    there and runs on to global step ``steps``, saving every
    ``checkpoint_every`` steps and at the end.
    """
    device = resolve_device(torch.device(device or "cuda").type)
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
    if batch % grad_accum:
        raise ValueError(
            f"batch ({batch}) must divide by grad_accum ({grad_accum})"
        )
    if loss_chunk:
        if loss_chunk < 1:
            raise ValueError(f"loss_chunk must be >= 1, got {loss_chunk}")
        if isinstance(cfg, MoeConfig):
            raise ValueError(
                "loss_chunk fuses the dense model's unembed into the loss; "
                "it does not compose with MoE"
            )
        if seq % loss_chunk:
            raise ValueError(
                f"seq ({seq}) must divide by loss_chunk ({loss_chunk})"
            )
    if serve is not None and checkpoint_dir is not None:
        # The checkpointed loop records per step; the serving window
        # shape assumes the windowed loop.
        raise ValueError("serve telemetry composes with the windowed "
                         "loop, not checkpoint_dir")

    generator = torch.Generator(device=device).manual_seed(seed)
    model = _build_model(cfg, params, generator, device)
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
    optimizer = make_optimizer(model.parameters())

    attn_impl = None
    if attn == "flash":
        from tpumon.workload_torch.ops.flash_attention import make_flash_attn

        attn_impl = make_flash_attn()
    step = make_train_step(
        model, optimizer, attn_impl, grad_accum=grad_accum, remat=remat,
        with_grad_norm=with_grad_norm, loss_chunk=loss_chunk,
    )

    flops_per_step = flops_mod.train_flops_per_step(cfg, batch, seq)
    if stats is not None:
        stats.configure(
            flops_per_step=flops_per_step,
            tokens_per_step=batch * seq,
            peak_flops_total=flops_mod.peak_flops_per_device(device),
            axes={"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1},
        )
    phase_probe = None
    if stats is not None and phase_stats:
        phase_probe = _make_phase_probe(
            model, optimizer, attn_impl, remat, loss_chunk, grad_accum
        )
    if checkpoint_dir is not None:
        return _run_checkpointed(
            step, model, optimizer, tokens, steps, checkpoint_dir,
            checkpoint_every, cfg=cfg, batch=batch, seq=seq, device=device,
            stats=stats, phase_probe=phase_probe, with_grad_norm=with_grad_norm,
        )

    # Warm-up outside the timed window.
    loss, gnorm = step(tokens)
    losses = [loss.item()]

    t0 = time.perf_counter()
    if stats is None:
        for _ in range(steps):
            loss, gnorm = step(tokens)
    else:
        window_t0, done = t0, 0
        for i in range(1, steps + 1):
            loss, gnorm = step(tokens)
            if i % max(stats_every, 1) == 0 or i == steps:
                lv = loss.item()  # one host-read sync per window
                now = time.perf_counter()
                stats.record(lv, i - done, now - window_t0)
                if serve is not None:
                    _record_serve_window(serve, batch, i - done, now - window_t0)
                if phase_probe is not None:
                    try:
                        stats.record_phases(phase_probe(tokens))
                    except Exception:
                        # Telemetry must never kill the traffic generator.
                        log.exception("phase probe failed")
                        phase_probe = None
                window_t0, done = time.perf_counter(), i
    # The barrier is a host read of the last loss.
    final_loss = loss.item()
    elapsed = time.perf_counter() - t0
    losses.append(final_loss)
    steps_per_sec = steps / elapsed if elapsed > 0 else float("inf")
    return RunResult(
        losses=losses,
        steps_per_sec=steps_per_sec,
        model_flops_per_step=flops_per_step,
        mfu=flops_mod.mfu(cfg, batch, seq, steps_per_sec, device),
        grad_norm=(gnorm.item() if with_grad_norm else None),
    )


def _run_checkpointed(
    step, model, optimizer, tokens, steps, checkpoint_dir, checkpoint_every,
    *, cfg, batch, seq, device, stats=None, phase_probe=None,
    with_grad_norm=False,
) -> RunResult:
    """Checkpoint/resume loop around the train step.

    Separate from the windowed loop on purpose: it reads the loss every
    step (one host sync each) and touches disk, so the traffic
    generator's loop keeps its sync-free timing. It restores the newest
    saved step (a failed restore raises), runs global steps
    ``start_step .. steps - 1`` with one loss each, saves every
    ``checkpoint_every`` steps and at the end (never a step already
    saved), keeps the 2 newest, and runs one phase probe at the end.
    """
    from tpumon.workload_torch.checkpoint import CheckpointStore

    store = CheckpointStore(checkpoint_dir)
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

    losses: list[float] = []
    timed, timed_steps = 0.0, 0
    saved_at = start_step if latest is not None else -1
    gnorm = None
    for i in range(start_step, steps):
        t0 = time.perf_counter()
        loss, gnorm = step(tokens)
        losses.append(loss.item())  # one host sync per step
        dt = time.perf_counter() - t0
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
                # Telemetry must never kill the traffic generator.
                log.exception("phase probe failed")
    if not losses:
        log.info("checkpoint at %s already covers %d steps; nothing to run",
                 checkpoint_dir, steps)
    # 0.0, not inf, when no step ran outside the warm-up: no throughput.
    steps_per_sec = timed_steps / timed if timed > 0 else 0.0
    return RunResult(
        losses=losses,
        steps_per_sec=steps_per_sec,
        start_step=start_step,
        model_flops_per_step=flops_mod.train_flops_per_step(cfg, batch, seq),
        mfu=flops_mod.mfu(cfg, batch, seq, steps_per_sec, device),
        grad_norm=(gnorm.item() if with_grad_norm and gnorm is not None else None),
    )


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

    def _on_term(signum, frame):
        if state["seen"]:
            os._exit(143)
        state["seen"] = True
        stats.mark_terminating()
        timer = threading.Timer(grace_s, lambda: os._exit(143))
        timer.daemon = True  # a finished run must not wait on the timer
        timer.start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        # Not the main thread (embedders driving main() from a worker).
        log.debug("SIGTERM marker not installed (not main thread)")


#: Flags of the reference CLI that later slices of the port bring, with
#: the ROADMAP.md queue-1 item that ports each. Given a non-default value
#: they fail; they are never silently ignored.
_LATER = {
    "dp": ("mesh, dp/tp and ZeRO-1", 7, 1),
    "tp": ("mesh, dp/tp and ZeRO-1", 7, 1),
    "zero1": ("mesh, dp/tp and ZeRO-1", 7, False),
    "hlo_raw_dump": ("collective counters", 7, None),
    "sp": ("ring sequence parallelism", 8, 1),
    "sp_layout": ("ring sequence parallelism", 8, "contiguous"),
    "pp": ("pipeline parallelism", 9, 1),
    "microbatches": ("pipeline parallelism", 9, 2),
    "interleave": ("pipeline parallelism", 9, 1),
    "ep": ("expert parallelism", 10, 1),
    "coordinator": ("multi-host", 11, None),
    "num_processes": ("multi-host", 11, 1),
    "process_id": ("multi-host", 11, None),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tpumon-workload-torch")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=None)
    parser.add_argument(
        "--preset",
        choices=("tiny", "small", "medium", "llama3-8b"),
        default="tiny",
        help="model size: tiny/small for quick runs; medium (~0.67B) is the "
        "main path's model at seq 4096 (pair with --attn flash, --remat "
        "and --grad-accum); llama3-8b is Llama-3-8B's shape",
    )
    parser.add_argument(
        "--model", choices=("llama", "moe"), default="llama",
        help="moe takes the presets tiny and small (moe-small: 0.153B, 8 "
        "experts top-2; pair with --seq 4096 --attn flash --remat)",
    )
    for axis in ("dp", "tp", "sp", "pp", "ep"):
        parser.add_argument(f"--{axis}", type=int, default=1)
    parser.add_argument("--sp-layout", choices=("contiguous", "zigzag"),
                        default="contiguous")
    parser.add_argument("--microbatches", type=int, default=2)
    parser.add_argument("--interleave", type=int, default=1)
    parser.add_argument(
        "--capacity-factor", type=float, default=None,
        help="MoE expert capacity factor (default: the preset's 2.0)",
    )
    parser.add_argument("--zero1", action="store_true")
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="save to and resume from this directory (one subdirectory "
        "per step, the 2 newest kept); --steps counts global steps",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="save every this many steps as well as at the end (0 = end only)",
    )
    parser.add_argument("--hlo-raw-dump", default=None)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=None)
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
        "Hopper card) or the host cpu",
    )
    return parser


def model_config(args: argparse.Namespace) -> LlamaConfig | MoeConfig:
    """The config that ``--model``, ``--preset`` and ``--capacity-factor``
    of parsed :func:`build_parser` arguments name."""
    if args.model == "moe":
        moe_presets = {"tiny": MoeConfig.tiny, "small": MoeConfig.small}
        if args.preset not in moe_presets:
            log.warning("--model moe has tiny/small presets; ignoring "
                        "--preset %s", args.preset)
        cfg = moe_presets.get(args.preset, MoeConfig.tiny)()
        if args.capacity_factor is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=args.capacity_factor)
        return cfg
    return {
        "tiny": LlamaConfig.tiny,
        "small": LlamaConfig.small,
        "medium": LlamaConfig.medium,
        "llama3-8b": LlamaConfig.llama3_8b,
    }[args.preset]()


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, (what, item, default) in _LATER.items():
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            parser.error(
                f"{flag} belongs to a later slice of the port ({what}, "
                f"ROADMAP.md queue 1 item {item})"
            )
    if args.serve and not args.metrics_port:
        parser.error("--serve publishes tpu_serve_* on the metrics "
                     "port; it needs --metrics-port")
    if args.serve and args.checkpoint_dir:
        parser.error("--serve composes with the windowed loop, not "
                     "--checkpoint-dir")
    if args.capacity_factor is not None and args.model != "moe":
        parser.error("--capacity-factor requires --model moe")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    cfg = model_config(args)
    device = resolve_device(args.platform)

    server = None
    stats = None
    serve_stats = None
    if args.metrics_port:
        from prometheus_client.registry import CollectorRegistry

        from tpumon.exporter.server import (
            ExporterServer,
            _make_app,
            registry_renderer,
        )
        from tpumon.exporter.telemetry import SelfTelemetry
        from tpumon.workload_torch.stats import StatsCollector, WorkloadStats

        registry = CollectorRegistry()
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

    try:
        result = run(
            cfg,
            steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            grad_accum=args.grad_accum,
            remat=args.remat,
            loss_chunk=args.loss_chunk,
            attn=args.attn,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            stats=stats,
            stats_every=args.stats_every,
            phase_stats=args.phase_stats,
            serve=serve_stats,
            device=device,
        )
        log.info(
            "loss %.4f → %.4f | %.2f steps/s | %.1f GFLOP/step | MFU %s | "
            "device=%s",
            result.losses[0] if result.losses else float("nan"),
            result.losses[-1] if result.losses else float("nan"),
            result.steps_per_sec,
            result.model_flops_per_step / 1e9,
            f"{result.mfu:.2%}" if result.mfu is not None else "n/a (no peak)",
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        )
    finally:
        if server is not None:
            server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
