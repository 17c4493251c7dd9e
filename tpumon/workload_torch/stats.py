"""Live workload throughput/MFU/step-phase telemetry for the port's
/metrics page.

A copy of ``tpumon/workload/stats.py`` (the port imports nothing from
the JAX package), with the same family names, labels and sampling rules,
so the page stays one the monitor reads unchanged: steps, loss, windowed
steps/s, live MFU, per-step phase wall times (fwd/bwd/optimizer),
collective-wait fraction, checkpoint save/restore spans, and a
terminating flag — the ``tpu_step_*`` families the node exporter's
lifecycle plane (tpumon/lifecycle) probes.

Sampling discipline: the harness's fast loop enqueues steps without host
syncs. Stats are recorded on a *window* boundary (every ``stats_every``
steps the loop reads the latest loss and records the window), not per
step, and phase timings are measured at most once per window
(``harness.py --phase-stats``), never inside the fast path.
"""

from __future__ import annotations

import threading


class WorkloadStats:
    """Thread-safe run telemetry shared between the train loop (writer)
    and a Prometheus collector on the metrics port (reader)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._steps_total = 0  # guarded-by: self._lock
        self._start_step = 0  # guarded-by: self._lock
        self._last_loss: float | None = None  # guarded-by: self._lock
        self._window_rate: float | None = None  # guarded-by: self._lock
        self._flops_per_step = 0.0  # guarded-by: self._lock
        self._tokens_per_step = 0  # guarded-by: self._lock
        self._peak_flops_total: float | None = None  # guarded-by: self._lock
        self._axes: dict[str, int] = {}  # guarded-by: self._lock
        #: phase -> last measured wall seconds (fwd/bwd/optimizer).
        self._phase_s: dict[str, float] = {}  # guarded-by: self._lock
        #: Collective-wait fraction of step wall time over the last
        #: window (None until the harness computes one).
        self._collective_wait: float | None = None  # guarded-by: self._lock
        #: op -> (count, last span seconds) for checkpoint save/restore.
        self._checkpoints: dict[str, tuple[int, float]] = {}  # guarded-by: self._lock
        #: SIGTERM observed: the preemption signature the lifecycle
        #: classifier keys on (stays 1 for the rest of the process).
        self._terminating = False  # guarded-by: self._lock

    def configure(
        self,
        *,
        flops_per_step: float,
        tokens_per_step: int,
        peak_flops_total: float | None,
        axes: dict[str, int],
        start_step: int = 0,
    ) -> None:
        """Static run facts, set once the model/mesh are known.

        ``peak_flops_total`` is the summed published bf16 peak of the run's
        devices, or None when unknown (CPU dryruns) — MFU is then absent
        from the exposition rather than computed against a made-up peak
        (same rule as workload.flops.mfu). ``start_step`` offsets the
        global step counter after a checkpoint resume, so ``tpu_step_
        counter`` is the training-global step, not the process-local one.
        """
        with self._lock:
            self._flops_per_step = float(flops_per_step)
            self._tokens_per_step = int(tokens_per_step)
            self._peak_flops_total = peak_flops_total
            self._axes = dict(axes)
            self._start_step = int(start_step)

    def set_start_step(self, start_step: int) -> None:
        """Checkpoint-resume offset for the training-global step counter
        (known only after the restore, i.e. after configure())."""
        with self._lock:
            self._start_step = int(start_step)

    def record(self, loss: float, steps: int, seconds: float) -> None:
        """One window: ``steps`` optimizer steps took ``seconds`` wall."""
        with self._lock:
            self._steps_total += int(steps)
            self._last_loss = float(loss)
            if steps > 0 and seconds > 0:
                self._window_rate = steps / seconds

    def record_phases(self, phases: dict[str, float]) -> None:
        """Last measured per-phase wall seconds (phase ∈ fwd/bwd/
        optimizer; harness --phase-stats, one instrumented step per
        window — never the pipelined fast path)."""
        with self._lock:
            self._phase_s = {
                k: float(v) for k, v in phases.items() if v is not None
            }

    def record_collective_wait(self, fraction: float) -> None:
        """Collective-wait fraction of step wall time over the last
        window (clamped to [0, 1] — a measurement artifact must not
        exceed the step it is a fraction of)."""
        with self._lock:
            self._collective_wait = min(1.0, max(0.0, float(fraction)))

    def record_checkpoint(self, op: str, seconds: float) -> None:
        """One checkpoint span (op ∈ save/restore)."""
        with self._lock:
            count, _ = self._checkpoints.get(op, (0, 0.0))
            self._checkpoints[op] = (count + 1, float(seconds))

    def mark_terminating(self) -> None:
        """SIGTERM arrived: flag the page for the grace window — the
        lifecycle classifier's preemption signature."""
        with self._lock:
            self._terminating = True

    def snapshot(self) -> dict:
        with self._lock:
            rate = self._window_rate
            mfu = None
            if (
                rate is not None
                and self._peak_flops_total
                and self._flops_per_step
            ):
                mfu = self._flops_per_step * rate / self._peak_flops_total
            return {
                "steps_total": self._steps_total,
                "step_counter": self._start_step + self._steps_total,
                "last_loss": self._last_loss,
                "steps_per_second": rate,
                "step_seconds": (1.0 / rate) if rate else None,
                "tokens_per_second": (
                    rate * self._tokens_per_step if rate is not None else None
                ),
                "model_flops_per_step": self._flops_per_step,
                "mfu": mfu,
                "axes": dict(self._axes),
                "phases": dict(self._phase_s),
                "collective_wait_fraction": self._collective_wait,
                "checkpoints": dict(self._checkpoints),
                "terminating": self._terminating,
            }


def stats_families(stats: WorkloadStats):
    """Prometheus families for the harness /metrics endpoint. One
    snapshot serves the whole scrape (coherent steps/rate/mfu/phases)."""
    from prometheus_client.core import (
        CounterMetricFamily,
        GaugeMetricFamily,
    )

    snap = stats.snapshot()

    steps = CounterMetricFamily(
        "workload_steps_total",
        "Optimizer steps completed by the harness train loop.",
    )
    steps.add_metric((), snap["steps_total"])
    yield steps

    counter = GaugeMetricFamily(
        "tpu_step_counter",
        "Training-global optimizer step (start step after a checkpoint "
        "resume plus steps completed by this process).",
    )
    counter.add_metric((), snap["step_counter"])
    yield counter

    if snap["axes"]:
        mesh = GaugeMetricFamily(
            "workload_mesh_info",
            "Parallelism degrees of the running workload's mesh.",
            labels=("dp", "tp", "sp", "pp", "ep"),
        )
        mesh.add_metric(
            tuple(str(snap["axes"].get(a, 1)) for a in ("dp", "tp", "sp", "pp", "ep")),
            1,
        )
        yield mesh

    if snap["last_loss"] is not None:
        loss = GaugeMetricFamily(
            "workload_loss",
            "Training loss at the most recent recorded window boundary.",
        )
        loss.add_metric((), snap["last_loss"])
        yield loss

    if snap["steps_per_second"] is not None:
        rate = GaugeMetricFamily(
            "workload_steps_per_second",
            "Optimizer steps per second over the most recent window "
            "(windowed host sync; the loop stays pipelined between windows).",
        )
        rate.add_metric((), snap["steps_per_second"])
        yield rate

    if snap["step_seconds"] is not None:
        dur = GaugeMetricFamily(
            "tpu_step_duration_seconds",
            "Mean wall seconds per optimizer step over the most recent "
            "window (1 / workload_steps_per_second; the lifecycle "
            "plane's step-time-regression input).",
        )
        dur.add_metric((), snap["step_seconds"])
        yield dur

    if snap["phases"]:
        phase = GaugeMetricFamily(
            "tpu_step_phase_seconds",
            "Wall seconds of the last instrumented step's phases "
            "(phase ∈ fwd/bwd/optimizer; measured at most once per "
            "stats window, never inside the pipelined fast path).",
            labels=("phase",),
        )
        for name in sorted(snap["phases"]):
            phase.add_metric((name,), snap["phases"][name])
        yield phase

    if snap["collective_wait_fraction"] is not None:
        wait = GaugeMetricFamily(
            "tpu_step_collective_wait_fraction",
            "Fraction of step wall time spent inside collective ops "
            "over the most recent window (HLO-logger latency sums over "
            "window wall time; ICI-contention signal — correlate with "
            "accelerator_collective_latency_microseconds).",
        )
        wait.add_metric((), snap["collective_wait_fraction"])
        yield wait

    if snap["checkpoints"]:
        spans = GaugeMetricFamily(
            "tpu_step_checkpoint_seconds",
            "Wall seconds of the most recent checkpoint span by op "
            "(save/restore) — restore spans are the restore-storm "
            "signature the lifecycle classifier keys on.",
            labels=("op",),
        )
        totals = CounterMetricFamily(
            "tpu_step_checkpoints",
            "Checkpoint spans completed since process start, by op "
            "(save/restore).",
            labels=("op",),
        )
        for op in sorted(snap["checkpoints"]):
            count, last_s = snap["checkpoints"][op]
            spans.add_metric((op,), last_s)
            totals.add_metric((op,), float(count))
        yield spans
        yield totals

    terminating = GaugeMetricFamily(
        "tpu_step_terminating",
        "1 once SIGTERM reached the harness (preemption grace window "
        "in progress — the lifecycle classifier's preemption "
        "signature); 0 while training normally.",
    )
    terminating.add_metric((), 1.0 if snap["terminating"] else 0.0)
    yield terminating

    if snap["tokens_per_second"] is not None:
        toks = GaugeMetricFamily(
            "workload_tokens_per_second",
            "Training tokens per second over the most recent window.",
        )
        toks.add_metric((), snap["tokens_per_second"])
        yield toks

    if snap["model_flops_per_step"]:
        fl = GaugeMetricFamily(
            "workload_model_flops_per_step",
            "Model FLOPs one optimizer step executes "
            "(tpumon.workload.flops exact per-matmul accounting).",
        )
        fl.add_metric((), snap["model_flops_per_step"])
        yield fl

    if snap["mfu"] is not None:
        mfu = GaugeMetricFamily(
            "workload_mfu_ratio",
            "Live model FLOPs utilization vs the devices' published bf16 "
            "peak, over the most recent window (absent when the peak is "
            "unknown, e.g. CPU; correlate with "
            "accelerator_duty_cycle_percent).",
        )
        mfu.add_metric((), snap["mfu"])
        yield mfu


class StatsCollector:
    """Registry adapter: ``registry.register(StatsCollector(stats))``."""

    def __init__(self, stats: WorkloadStats) -> None:
        self._stats = stats

    def collect(self):
        return stats_families(self._stats)
