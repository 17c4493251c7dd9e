"""Request-level serving telemetry for the port's /metrics page.

A copy of ``tpumon/workload/serve.py`` (the port imports nothing from
the JAX package), with the same family names and labels: completed
requests, windowed requests/s, live queue depth, effective batch size, a
time-to-first-token proxy, and goodput under SLO — the ``tpu_serve_*``
families the node exporter's lifecycle plane lifts into
``tpu_lifecycle_serve_*`` and the fleet actuation tier turns into
External Metrics an HPA can scale on.

The TTFT proxy is queue wait plus one decode-step latency for requests
admitted in the window; SLO attainment is the fraction of the window's
requests whose proxy met the configured threshold. Both follow the
absent-not-zero rule until the serving loop records its first window.
"""

from __future__ import annotations

import threading


class ServeStats:
    """Thread-safe serving telemetry shared between the request loop
    (writer) and a Prometheus collector on the metrics port (reader)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests_total = 0  # guarded-by: self._lock
        self._window_rate: float | None = None  # guarded-by: self._lock
        self._queue_depth = 0  # guarded-by: self._lock
        self._batch_mean: float | None = None  # guarded-by: self._lock
        self._ttft_s: float | None = None  # guarded-by: self._lock
        self._slo_ratio: float | None = None  # guarded-by: self._lock
        self._slo_threshold_s: float | None = None  # guarded-by: self._lock

    def configure(self, *, slo_threshold_s: float | None) -> None:
        """Static run fact: the TTFT SLO the attainment ratio is
        measured against (None = no SLO configured; the ratio family is
        then absent rather than measured against a made-up bound)."""
        with self._lock:
            self._slo_threshold_s = (
                float(slo_threshold_s) if slo_threshold_s else None
            )

    def set_queue_depth(self, depth: int) -> None:
        """Instantaneous admitted-but-incomplete request count (the
        serving loop updates it on admit and on completion)."""
        with self._lock:
            self._queue_depth = max(0, int(depth))

    def record_window(
        self,
        *,
        requests: int,
        seconds: float,
        batch_mean: float | None,
        ttft_worst_s: float | None,
        slo_met: int | None = None,
    ) -> None:
        """One serving window: ``requests`` completed in ``seconds``
        wall, with the window's mean effective batch, worst TTFT proxy,
        and how many of the completed requests met the SLO."""
        with self._lock:
            self._requests_total += int(requests)
            if requests > 0 and seconds > 0:
                self._window_rate = requests / seconds
            if batch_mean is not None:
                self._batch_mean = float(batch_mean)
            if ttft_worst_s is not None:
                self._ttft_s = float(ttft_worst_s)
            if (
                slo_met is not None
                and requests > 0
                and self._slo_threshold_s is not None
            ):
                self._slo_ratio = min(1.0, max(0.0, slo_met / requests))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests_total": self._requests_total,
                "requests_per_second": self._window_rate,
                "queue_depth": self._queue_depth,
                "batch_size": self._batch_mean,
                "ttft_seconds": self._ttft_s,
                "slo_attainment_ratio": self._slo_ratio,
                "slo_threshold_seconds": self._slo_threshold_s,
            }


def serve_families(stats: ServeStats):
    """Prometheus families for the harness /metrics endpoint. One
    snapshot serves the whole scrape (coherent rate/queue/ttft/slo)."""
    from prometheus_client.core import (
        CounterMetricFamily,
        GaugeMetricFamily,
    )

    snap = stats.snapshot()

    total = CounterMetricFamily(
        "tpu_serve_requests_total",
        "Inference requests completed by the serving loop since start.",
    )
    total.add_metric((), snap["requests_total"])
    yield total

    depth = GaugeMetricFamily(
        "tpu_serve_queue_depth",
        "Requests admitted but not yet completed (instantaneous) — the "
        "scale-out pressure signal the actuation tier exports to HPAs.",
    )
    depth.add_metric((), snap["queue_depth"])
    yield depth

    if snap["requests_per_second"] is not None:
        rate = GaugeMetricFamily(
            "tpu_serve_requests_per_second",
            "Completed requests per second over the most recent stats "
            "window.",
        )
        rate.add_metric((), snap["requests_per_second"])
        yield rate

    if snap["batch_size"] is not None:
        batch = GaugeMetricFamily(
            "tpu_serve_batch_size",
            "Mean effective batch size over the most recent window.",
        )
        batch.add_metric((), snap["batch_size"])
        yield batch

    if snap["ttft_seconds"] is not None:
        ttft = GaugeMetricFamily(
            "tpu_serve_ttft_seconds",
            "Time-to-first-token proxy over the most recent window: "
            "queue wait plus one decode-step latency for newly "
            "admitted requests.",
        )
        ttft.add_metric((), snap["ttft_seconds"])
        yield ttft

    if snap["slo_attainment_ratio"] is not None:
        slo = GaugeMetricFamily(
            "tpu_serve_slo_attainment_ratio",
            "Fraction of requests whose TTFT proxy met the configured "
            "SLO over the most recent window — goodput under SLO.",
        )
        slo.add_metric((), snap["slo_attainment_ratio"])
        yield slo

    if snap["slo_threshold_seconds"] is not None:
        thr = GaugeMetricFamily(
            "tpu_serve_slo_threshold_seconds",
            "The configured TTFT SLO threshold the attainment ratio is "
            "measured against (constant per run).",
        )
        thr.add_metric((), snap["slo_threshold_seconds"])
        yield thr


class ServeCollector:
    """Registry adapter: ``registry.register(ServeCollector(stats))``."""

    def __init__(self, stats: ServeStats) -> None:
        self._stats = stats

    def collect(self):
        return serve_families(self._stats)
