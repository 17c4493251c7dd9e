"""Collective-op counters of the port, at its own call sites.

The counterpart of ``tpumon/workload/hlo_counters.py``. The reference
counts the collectives XLA runs from libtpu's HLO logger; a CUDA program
has no such logger, so the port counts the collectives it issues itself:
every one goes through ``parallel/mesh.py``, which wraps each call in
:meth:`CollectiveCounters.span`. The ops carry the XLA names the monitor
already knows (``all-reduce``, ``all-gather``, the ring's
``collective-permute``). ``reduce-scatter`` and ``all-to-all`` are known
names that no call site issues: the expert split combines with an
all-reduce, as the reference's compiled step does.

Each call adds one to its op's count and its payload (numel × element
size) to the op's bytes. Its latency on the card is a pair of CUDA events
around the call on the current stream; the events are read in
:meth:`flush`, which the train loop calls after its one host sync a
window, so counting adds no sync of its own. On the CPU the call blocks,
and its latency is ``perf_counter`` around it.

:func:`counters_families` renders the reference's families with the
reference's names and labels; each is absent, not zero, until it has a
sample. :func:`expected_per_step` and :func:`expected_per_probe` are the
counts the train step issues, from its shape and options
(:func:`_pipeline_counts` under pp).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import Counter

import torch

from tpumon.workload_torch import spans

#: The XLA collective names the port counts under.
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")

#: Lines the raw dump keeps, as the reference's ``raw_limit``.
RAW_LIMIT = 4096


class CollectiveCounters:
    """Counts, bytes and latency of the collectives one rank issues.
    Thread-safe: the train loop writes, the metrics page reads.

    ``raw_path`` writes one JSON line per recorded collective (op, bytes,
    µs, rank), up to :data:`RAW_LIMIT` lines (``--hlo-raw-dump``)."""

    def __init__(self, raw_path: str | None = None, rank: int = 0) -> None:
        self._lock = threading.Lock()
        self._counts: Counter[str] = Counter()  # guarded-by: self._lock
        self._bytes: Counter[str] = Counter()  # guarded-by: self._lock
        self._latency_us: Counter[str] = Counter()  # guarded-by: self._lock
        self._latency_samples: Counter[str] = Counter()  # guarded-by: self._lock
        self._events = 0  # guarded-by: self._lock
        #: (op, nbytes, start event, end event) on the card, read by flush().
        self._pending: list = []  # train-loop thread only
        self._rank = rank
        self._raw_path = raw_path
        self._raw_file = None
        self._raw_count = 0

    @contextlib.contextmanager
    def span(self, op: str, nbytes: int, device: torch.device):
        """Count one ``op`` call of ``nbytes`` payload around the ``with``
        body, which issues it on ``device``. While a profiler records, the
        body runs in the span ``workload.collective.<op>`` (``spans.py``)."""
        if op not in OPS:
            raise ValueError(f"unknown collective op {op!r} (one of {OPS})")
        with self._lock:
            self._counts[op] += 1
            self._bytes[op] += int(nbytes)
            self._events += 1
        with spans.span("collective." + op):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._pending.append((op, nbytes, start, end))
            else:
                t0 = time.perf_counter()
                yield
                self._add_latency(op, nbytes, (time.perf_counter() - t0) * 1e6)

    def flush(self) -> None:
        """Read the CUDA events of the calls since the last flush. Call it
        after a host sync: the events are then complete, and reading them
        does not wait."""
        pending, self._pending = self._pending, []
        for op, nbytes, start, end in pending:
            end.synchronize()
            self._add_latency(op, nbytes, start.elapsed_time(end) * 1e3)

    def _add_latency(self, op: str, nbytes: int, us: float) -> None:
        with self._lock:
            self._latency_us[op] += us
            self._latency_samples[op] += 1
            if self._raw_path is not None and self._raw_count < RAW_LIMIT:
                if self._raw_file is None:
                    self._raw_file = open(self._raw_path, "w")
                self._raw_file.write(json.dumps(
                    {"op": op, "bytes": int(nbytes), "us": us, "rank": self._rank}
                ) + "\n")
                self._raw_file.flush()
                self._raw_count += 1

    def total_latency_us(self) -> float:
        """Summed latency of the flushed calls, µs."""
        with self._lock:
            return float(sum(self._latency_us.values()))

    def close(self) -> None:
        with self._lock:
            self._raw_path = None
            if self._raw_file is not None:
                self._raw_file.close()
                self._raw_file = None

    def detailed_snapshot(self) -> dict:
        """Counts, bytes and latency by op, and the calls recorded."""
        with self._lock:
            return {
                "counts": dict(self._counts),
                "events": self._events,
                "bytes": dict(self._bytes),
                "latency_us": dict(self._latency_us),
                "latency_samples": dict(self._latency_samples),
            }


def counters_families(counters: CollectiveCounters):
    """The reference's ``workload_collective_*`` families from one
    snapshot (a scrape never shows more latency samples than calls)."""
    from prometheus_client.core import CounterMetricFamily

    detail = counters.detailed_snapshot()
    if not detail["events"]:
        return
    ops = CounterMetricFamily(
        "workload_collective_ops_total",
        "Collective ops this rank issued at the port's own call sites, by "
        "op (XLA op names).",
        labels=("op",),
    )
    for op, n in sorted(detail["counts"].items()):
        ops.add_metric((op,), n)
    yield ops
    events = CounterMetricFamily(
        "workload_hlo_log_events_total",
        "Collective calls recorded by the port's counters (the libtpu HLO "
        "logger's event count has no CUDA source).",
    )
    events.add_metric((), detail["events"])
    yield events
    if detail["latency_us"]:
        lat = CounterMetricFamily(
            "workload_collective_op_latency_microseconds_total",
            "Summed per-op latency of this rank's collectives: CUDA events "
            "around each call on the card, wall time on the CPU (correlate "
            "with accelerator_collective_latency_microseconds).",
            labels=("op",),
        )
        samples = CounterMetricFamily(
            "workload_collective_op_latency_samples_total",
            "Calls whose latency was read, by op — the denominator for "
            "average-latency queries.",
            labels=("op",),
        )
        for op, us in sorted(detail["latency_us"].items()):
            lat.add_metric((op,), us)
            samples.add_metric((op,), detail["latency_samples"][op])
        yield lat
        yield samples
    by = CounterMetricFamily(
        "workload_collective_op_bytes_total",
        "Summed per-op payload bytes (numel × element size) of this "
        "rank's collectives.",
        labels=("op",),
    )
    for op, n in sorted(detail["bytes"].items()):
        by.add_metric((op,), n)
    yield by


class CountersCollector:
    """Registry adapter: ``registry.register(CountersCollector(c))``."""

    def __init__(self, counters: CollectiveCounters) -> None:
        self._counters = counters

    def collect(self):
        return counters_families(self._counters)


def _pipeline_counts(n_layers: int, dp: int, tp: int, remat: bool, moe: bool,
                     sp: int, ep: int, pp: int, microbatches: int,
                     interleave: int) -> tuple[Counter, Counter]:
    """(forward, backward) counts of one pipelined step
    (``parallel/pipeline.py``) before the gradients' data×seq all-reduce,
    the same on every stage. T ticks (``pipeline.ticks``) of a chunk of
    lpg = L / (pp·v) layers; b rows of the rank in M microbatches of
    mb = b / M rows, s = S / sp positions, D the width; payloads in the
    model dtype unless said.

    Every tick runs its body forward and backward on every stage, bubble
    ticks included, so each body collective counts T·lpg times:
    - under tp, forward the two row splits of each layer (2, [mb,s,D]),
      backward the two column splits' inputs (2); the vocab-sharded
      embedding (1, [b,s,D]) and the loss's two (f32 [b,s,1] and
      [b,s,2]) forward, the unembed's input (1, [b,s,D]) backward;
    - an MoE layer under ep: forward the combine's sum over expert (1,
      [mb,s,D]), backward the expert input's and the routed
      probabilities' gradients (2; [mb,s,D] and f32 [mb,s,E]);
    - under sp, the ring's permutes of each layer's attention
      (:func:`_permute_counts`).
    ``--remat`` recomputes a tick's whole chunk, and torch's checkpoint
    stops before the last layer's last saved tensor: a dense chunk runs
    2·lpg − 1 of its tp all-reduces again, an MoE chunk its 2·lpg and
    lpg − 1 of its sums over expert.

    The stage axis adds, forward, T hops of [mb,s,D] (``collective-
    permute``) and the all-reduce of the finished microbatches
    ([b,s,D]); backward, T − 1 hops (the last tick's hop feeds nothing on
    any stage) and the all-reduce of the pipe input's gradient ([b,s,D]).
    An MoE model adds, forward, the data mean of the stage's token sums
    (1 when dp > 1, f32 [v·lpg·2E]) and the stage sum of its aux loss (1,
    f32 scalar)."""
    T = _pipeline_ticks(microbatches, pp, interleave)
    lpg = n_layers // (pp * interleave)
    fwd, bwd = Counter(), Counter()
    fwd["all-reduce"] += 1
    bwd["all-reduce"] += 1
    fwd["collective-permute"] += T
    bwd["collective-permute"] += T - 1
    if tp > 1:
        fwd["all-reduce"] += 1 + 2 * T * lpg + 2
        bwd["all-reduce"] += 2 * T * lpg + 1
        if remat:
            bwd["all-reduce"] += T * (2 * lpg - (0 if moe else 1))
    if moe:
        fwd["all-reduce"] += int(dp * sp > 1) + 1
        if ep > 1:
            fwd["all-reduce"] += T * lpg
            bwd["all-reduce"] += 2 * T * lpg + (T * (lpg - 1) if remat else 0)
    return fwd, bwd


def _pass_counts(n_layers: int, dp: int, tp: int, remat: bool,
                 loss_chunk: int, seq: int, moe: bool, sp: int = 1,
                 ep: int = 1) -> tuple[Counter, Counter]:
    """(forward, backward) all-reduces and all-gathers of one microbatch's
    loss and gradient, before the gradients' data×seq all-reduce. B, s =
    seq/sp and D below are the microbatch's rows, the rank's positions and
    the model width; payloads are in the model dtype unless said.

    Under tp: forward, the vocab-sharded embedding (1, [B,s,D]), the two
    row splits of each layer (``wo`` [B,s,D] and ``w_down``, or the
    experts' ``w_down`` on the capacity buffers [E/ep,B,C,D]: 2 L), and
    two per cross-entropy call (the max and the sum-exp with the target's
    logit, f32), one call per loss chunk; backward, the two column splits'
    inputs of each layer (2 L, [B,s,D]) and the unembed's input (1), and a
    checkpointed loss chunk runs its two forward all-reduces again.

    Each MoE layer adds, on a mesh:
    - forward, under ep, the combine's sum over expert (1, [B,s,D]);
    - backward, under ep, the gradients of the two tensors each expert
      rank uses only for its own experts (``copy_to_expert``): the layer
      input of the expert products ([B,s,D]) and the router
      probabilities that enter the routing ([B,s,E] f32), 2;
    - forward, under sp, the all-gather of the router probabilities over
      seq (1, [B,s,E] f32 from each rank); its backward is local;
    - forward, when dp·sp > 1, the data×seq mean of the aux loss's two
      statistics (1, [2E] f32).

    ``--remat`` recomputes each layer in the backward, and torch's
    checkpoint stops a recompute once it has every tensor the backward
    saved: a dense layer's last saved tensor is ``w_down``'s input, so its
    recompute stops before that row split's all-reduce (1 a layer under
    tp), while an MoE layer's is the combine's input: it runs the row
    splits (2 under tp), the seq gather and the aux mean again, and stops
    before the combine's sum over expert.
    """
    fwd, bwd = Counter(), Counter()
    if tp > 1:
        ce_calls = seq // loss_chunk if loss_chunk else 1
        fwd["all-reduce"] += 1 + 2 * n_layers + 2 * ce_calls
        bwd["all-reduce"] += 2 * n_layers + 1
        if loss_chunk:
            bwd["all-reduce"] += 2 * ce_calls
        if remat:
            bwd["all-reduce"] += (2 if moe else 1) * n_layers
    if moe:
        experts, gather, mean = int(ep > 1), int(sp > 1), int(dp * sp > 1)
        fwd["all-reduce"] += n_layers * (experts + mean)
        fwd["all-gather"] += n_layers * gather
        bwd["all-reduce"] += n_layers * (2 * experts + remat * mean)
        bwd["all-gather"] += n_layers * remat * gather
    return fwd, bwd


def _permute_counts(n_layers: int, sp: int, sp_layout: str, attn: str,
                    seq_coord: int, remat: bool) -> tuple[int, int]:
    """(forward, backward) collective-permutes of one microbatch on the
    rank at seq coordinate ``seq_coord`` (``parallel/ring.py``).

    Each layer's attention call issues P permutes forward
    (``ring.permutes_per_call``): the ring's hops (n on the contiguous
    plain ring, whose last hop returns each block home; n − 1 on the
    others), plus under zigzag one permute for each of q, k, v and the
    output per carrier (even, odd) that moves this rank's stripe (a
    carrier that maps the rank to itself is a local copy: the even one
    on every rank at sp = 2). Every exchange is an autograd Function
    whose backward is the transposed exchange, run on every rank even
    for blocks it never attended: P more. ``--remat`` recomputes the
    attention in full (checkpoint stops a layer's recompute only at its
    MLP's last saved tensor, after the attention): P more in the
    backward."""
    if sp == 1:
        return 0, 0
    from tpumon.workload_torch.parallel.ring import permutes_per_call

    per_call = permutes_per_call(sp, sp_layout == "zigzag", attn == "flash",
                                 seq_coord)
    fwd = n_layers * per_call
    return fwd, fwd * (2 if remat else 1)


def _counts(n_layers, dp, tp, remat, loss_chunk, seq, moe, sp, ep, sp_layout,
            attn, seq_coord, pp, microbatches, interleave) -> tuple[Counter, Counter]:
    """(forward, backward) counts of one microbatch (of one step under
    pp), ring permutes included."""
    if pp > 1:
        fwd, bwd = _pipeline_counts(n_layers, dp, tp, remat, moe, sp, ep, pp,
                                    microbatches, interleave)
        # Every tick's chunk: T·lpg layer calls.
        n_layers = (n_layers // (pp * interleave)
                    * _pipeline_ticks(microbatches, pp, interleave))
    else:
        fwd, bwd = _pass_counts(n_layers, dp, tp, remat, loss_chunk, seq, moe, sp, ep)
    pf, pb = _permute_counts(n_layers, sp, sp_layout, attn, seq_coord, remat)
    fwd["collective-permute"] += pf
    bwd["collective-permute"] += pb
    return fwd, bwd


def _pipeline_ticks(microbatches: int, pp: int, interleave: int) -> int:
    from tpumon.workload_torch.parallel.pipeline import ticks

    return ticks(microbatches, pp, interleave)


def expected_per_step(*, n_layers: int, dp: int, tp: int, grad_accum: int,
                      remat: bool, loss_chunk: int, seq: int, zero1: bool,
                      grad_norm: bool, moe: bool = False, sp: int = 1,
                      sp_layout: str = "contiguous", attn: str = "xla",
                      seq_coord: int = 0, ep: int = 1, pp: int = 1,
                      microbatches: int = 1, interleave: int = 1) -> dict[str, int]:
    """The collectives one optimizer step issues on the rank at seq
    coordinate ``seq_coord``: the microbatches' model, expert and seq
    collectives (:func:`_pass_counts`) and ring permutes
    (:func:`_permute_counts`), or under pp the pipelined step's
    (:func:`_pipeline_counts`, with ``grad_accum`` 1), one all-reduce of
    the gradients (and the loss) over data×seq per microbatch when
    dp·sp > 1 (the weights are replicated over both), under
    ``grad_norm`` one all-reduce of the split leaves' squared norms over
    model under tp, one of the banks' over expert under ep and one of
    the layers' over stage under pp (4 B each; 8 B over model under pp:
    the layers' and the others'), and ZeRO-1's one all-gather of the
    updated slices. ``collective-permute`` appears only under sp > 1 or
    pp > 1."""
    fwd, bwd = _counts(n_layers, dp, tp, remat, loss_chunk, seq, moe, sp, ep,
                       sp_layout, attn, seq_coord, pp, microbatches, interleave)
    all_reduce = grad_accum * (fwd["all-reduce"] + bwd["all-reduce"] + (dp * sp > 1))
    all_reduce += int(grad_norm) * (int(tp > 1) + int(moe and ep > 1) + int(pp > 1))
    all_gather = grad_accum * (fwd["all-gather"] + bwd["all-gather"]) + int(zero1)
    out = {"all-reduce": all_reduce, "all-gather": all_gather}
    if sp > 1 or pp > 1:
        out["collective-permute"] = grad_accum * (fwd["collective-permute"]
                                                  + bwd["collective-permute"])
    return out


def expected_per_probe(*, n_layers: int, dp: int, tp: int, remat: bool,
                       loss_chunk: int, seq: int, zero1: bool,
                       moe: bool = False, sp: int = 1,
                       sp_layout: str = "contiguous", attn: str = "xla",
                       seq_coord: int = 0, ep: int = 1, pp: int = 1,
                       microbatches: int = 1, interleave: int = 1) -> dict[str, int]:
    """The collectives one phase probe issues on each rank: a forward, a
    forward and backward with the data×seq all-reduce of its gradients,
    and the optimizer update (ZeRO-1's all-gather), on one microbatch
    (under pp, one pipelined step)."""
    fwd, bwd = _counts(n_layers, dp, tp, remat, loss_chunk, seq, moe, sp, ep,
                       sp_layout, attn, seq_coord, pp, microbatches, interleave)
    out = {op: 2 * fwd[op] + bwd[op] for op in ("all-reduce", "all-gather")}
    out["all-reduce"] += int(dp * sp > 1)
    out["all-gather"] += int(zero1)
    if sp > 1 or pp > 1:
        out["collective-permute"] = 2 * fwd["collective-permute"] + bwd["collective-permute"]
    return out


__all__ = [
    "OPS",
    "RAW_LIMIT",
    "CollectiveCounters",
    "CountersCollector",
    "counters_families",
    "expected_per_probe",
    "expected_per_step",
]
