"""The port's span table (``progspans.reduce``) on made-up events and on a
tiny program's profile on the host, the numbers it gives, and the trace
record's readers with the port's spans in the events."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import devtrace, progspans, spantable
from benchmark.program import Program
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.test_benchmark_trace import EVENTS, MS, _reader, _record

# (name, on_device, start, end, correlation, linked, thread): the step on
# thread 7, its backward on thread 9.
SPANNED = [
    ("workload.step", False, 0, 20 * MS, 1, 0, 7),
    ("workload.fwd", False, 1 * MS, 8 * MS, 2, 0, 7),
    ("workload.norm", False, 1 * MS + 1, 3 * MS, 3, 0, 7),
    ("aten::mul", False, 2 * MS, 2 * MS + 9, 10, 0, 7),
    ("workload.qkv", False, 3 * MS + 1, 6 * MS, 4, 0, 7),
    ("workload.cast", False, 4 * MS, 5 * MS, 5, 0, 7),
    ("aten::_to_copy", False, 4 * MS + 1, 4 * MS + 9, 11, 0, 7),
    ("aten::mm", False, 5 * MS + 1, 5 * MS + 9, 12, 0, 7),
    ("workload.attn_core", False, 6 * MS + 1, 7 * MS + 9, 6, 0, 7),
    ("bench.attn_fwd", False, 6 * MS + 2, 7 * MS + 8, 16, 0, 7),
    ("workload.bwd", False, 8 * MS + 1, 19 * MS, 7, 0, 7),
    ("workload.norm.bwd", False, 9 * MS, 12 * MS, 8, 0, 9),
    ("aten::mul", False, 10 * MS, 10 * MS + 9, 13, 0, 9),
    ("aten::add", False, 13 * MS, 13 * MS + 9, 14, 0, 9),
    ("aten::copy_", False, 21 * MS, 21 * MS + 9, 15, 0, 7),
    ("workload.norm", True, 2 * MS, 3 * MS, 90, 3, 0),  # mirrored annotation
    ("void at::native::vectorized_elementwise_kernel<4>", True, 2 * MS, 3 * MS, 101, 10, 0),
    ("void at::native::unrolled_elementwise_kernel<bf16>", True, 4 * MS, 5 * MS, 102, 11, 0),
    ("nvjet_tst_128x256", True, 5 * MS, 7 * MS, 103, 12, 0),
    ("void fwd::fwd_kernel<128, 128, 128>", True, 7 * MS, 8 * MS, 104, 16, 0),
    ("void at::native::reduce_kernel<512>", True, 10 * MS, 11 * MS, 105, 13, 0),
    ("void at::native::vectorized_elementwise_kernel<2>", True, 13 * MS, 14 * MS, 106, 14, 0),
    ("Memcpy DtoD", True, 21 * MS, 22 * MS, 107, 15, 0),
    ("void some_kernel<float>", True, 23 * MS, 24 * MS, 108, 99, 0),
]


def test_the_innermost_span_wins():
    spans = progspans.reduce(SPANNED, steps=1)["spans"]
    assert spans["norm"]["device_s"] == pytest.approx(0.001)
    assert spans["cast"]["by_class_s"] == {"elementwise": pytest.approx(0.001)}
    # The product after the cast closed is the projection's own.
    assert spans["qkv"]["by_class_s"] == {"matmul": pytest.approx(0.002)}
    # Flash inside the benchmark's span is attention, in the port's span.
    assert spans["attn_core"]["by_class_s"] == {"attention": pytest.approx(0.001)}
    assert spans["norm.bwd"]["by_class_s"] == {"elementwise": pytest.approx(0.001)}
    assert spans["norm"]["calls"] == 1 and spans["step"]["calls"] == 1


def test_a_kernel_outside_every_span_of_its_thread_goes_to_the_step_thread():
    spans = progspans.reduce(SPANNED, steps=1)["spans"]
    assert spans["bwd"]["device_s"] == pytest.approx(0.001)
    assert spans["fwd"]["device_s"] == spans["step"]["device_s"] == 0.0


def test_unspanned_and_unlinked_kernels_are_reported():
    program = progspans.reduce(SPANNED, steps=1)
    assert program["unspanned_s"] == pytest.approx(0.002)
    assert program["unspanned_by_class_s"] == {"memory": pytest.approx(0.001),
                                               "other": pytest.approx(0.001)}


def test_idle_gaps_by_the_span_that_ended_them():
    idle = progspans.reduce(SPANNED, steps=1)["idle_by_span"]
    assert idle == {"cast": pytest.approx(0.001), "norm.bwd": pytest.approx(0.002),
                    "bwd": pytest.approx(0.002), "unspanned": pytest.approx(0.007),
                    "unlinked": pytest.approx(0.001)}
    assert list(idle)[0] == "unspanned"


def test_the_classes_add_up_to_the_trace_records():
    program = progspans.reduce(SPANNED, steps=1)
    record = devtrace.reduce(SPANNED, wall_s=0.025, steps=1)
    assert record["program"] == program
    total: dict[str, float] = dict(program["unspanned_by_class_s"])
    for entry in program["spans"].values():
        for cls, s in entry["by_class_s"].items():
            total[cls] = total.get(cls, 0.0) + s
    assert total == pytest.approx(record["by_class_s"])
    nonproduct = sum(s for cls, s in record["by_class_s"].items()
                     if cls not in progspans.PRODUCTS)
    assert progspans.nonproduct_s(program) == pytest.approx(nonproduct)


#: The port's spans around the trace tests' events, each opening before
#: the operation it holds, and the profiler's mirror of one on the device.
AROUND = [
    ("workload.step", False, -2, 10 * MS, 200, 0, 7),
    ("workload.fwd", False, -1, 3 * MS, 201, 0, 7),
    ("workload.attn_core", False, 1 * MS - 1, 2 * MS + 1, 202, 0, 7),
    ("workload.attn_core.bwd", False, 5 * MS - 1, 7 * MS + 1, 203, 0, 9),
    ("workload.loss", False, 8 * MS - 1, 9 * MS + 1, 204, 0, 7),
    ("workload.loss", True, 9 * MS, 10 * MS, 205, 204, 0),
]

READERS = ["tokens_per_s", "peak_mem_gib", "setup_s", "step_mfu_pct",
           "device_idle_pct", "flash_fwd_roofline", "flash_bwd_roofline",
           "nongemm_ms_per_step"]


@pytest.mark.parametrize("name", READERS)
def test_existing_readers_read_the_same_with_the_ports_spans(name):
    plain = _record(devtrace.reduce(EVENTS, wall_s=0.010, steps=1))
    spanned = _record(devtrace.reduce(EVENTS + AROUND, wall_s=0.010, steps=1))
    # Only the span table (the record's ``program``) reads the port's spans.
    assert spanned["trace"].pop("program")["spans"]
    assert not plain["trace"].pop("program")["spans"]
    assert spanned["trace"] == plain["trace"]
    assert _reader(name)(spanned) == _reader(name)(plain)


#: A made-up span table: two steps.
TABLE = {"steps": 2, "unspanned_s": 0.0, "unspanned_by_class_s": {},
         "idle_by_span": {}, "spans": {
             name: {"calls": 4, "device_s": s, "by_class_s": {"elementwise": s}}
             for name, s in [("norm", 0.10), ("norm.bwd", 0.20), ("rope", 0.06),
                             ("cast", 0.01), ("cast.bwd", 0.01), ("loss", 0.05),
                             ("loss.bwd", 0.07), ("optimizer", 0.08),
                             ("router", 0.03), ("router.bwd", 0.01),
                             ("dispatch", 0.02), ("dispatch.bwd", 0.04),
                             ("combine", 0.02), ("combine.bwd", 0.06)]}}

EXPECTED_MS = {"norm_ms_per_step": 150.0, "rope_ms_per_step": 30.0,
               "cast_ms_per_step": 10.0, "loss_ms_per_step": 60.0,
               "optimizer_ms_per_step": 40.0, "route_ms_per_step": 20.0,
               "dispatch_ms_per_step": 70.0}


@pytest.mark.parametrize("metric", sorted(progspans.METRICS))
def test_each_number_of_a_span_table(metric):
    spans = progspans.METRICS[metric]
    assert progspans.ms_per_step(TABLE, spans) == pytest.approx(EXPECTED_MS[metric])
    empty = dict(TABLE, spans={"step": TABLE["spans"]["norm"]})
    assert progspans.ms_per_step(empty, spans) is None
    assert progspans.ms_per_step(None, spans) is None


def test_the_summary_holds_the_table_to_the_record():
    trace = devtrace.reduce(SPANNED, wall_s=0.025, steps=1)
    line = spantable.summary(trace, progspans.reduce(SPANNED, steps=1))
    checks = line["checks"]
    assert checks["nonproduct_over_nongemm"] == pytest.approx(1.0)
    assert checks["attn_core_over_attention"] == pytest.approx(1.0)
    assert checks["unspanned_pct_of_busy"] == pytest.approx(100 * 0.002 / 0.009)
    assert line["metrics"]["norm_ms_per_step"] == pytest.approx(2.0)
    assert line["metrics"]["route_ms_per_step"] is None
    assert list(line["spans_ms"])[0] == "qkv"


def _host_events(prof):
    """The capture's event tuples (``devtrace.capture``'s), host only."""
    return [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
             e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
             e.linked_correlation_id(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "moe"])
def test_the_table_of_a_tiny_programs_step_on_the_host(moe):
    prog = Program(tiny_cell(moe), 3000000001, "cpu", spans=True)
    prog.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.step()
    program = progspans.reduce(_host_events(prof), steps=1)
    names = set(program["spans"])
    model = {"embed", "layer", "norm", "qkv", "rope", "attn_core", "attn_out",
             "cast", "loss"}
    model |= {"router", "dispatch", "experts", "combine"} if moe else {"mlp"}
    assert names == ({"step", "fwd", "bwd", "optimizer"} | model
                     | {f"{n}.bwd" for n in model})
    assert program["spans"]["step"]["calls"] == 1
    assert program["spans"]["fwd"]["calls"] == 2  # grad_accum
    assert program["unspanned_s"] == 0.0  # no device here


def _capture_of_every_span():
    """A made-up capture of two steps: on the step's thread each span of
    ``progspans.METRICS`` opens in turn around one operation that launches
    one kernel of (i + 1) ms, and on the engine's thread its backward half
    (the optimizer has none) around one of (i + 1) / 2 ms. Returns the
    events and each span's device seconds."""
    names = sorted({n for spans in progspans.METRICS.values() for n in spans})
    events = [("workload.step", False, 0, 10 * MS * len(names), 1, 0, 7)]
    seconds, corr = {}, 10
    for i, name in enumerate(names):
        halves = [(name, 7, i + 1.0)]
        if name != "optimizer":
            halves.append((f"{name}.bwd", 9, (i + 1.0) / 2))
        for j, (span, thread, ms) in enumerate(halves):
            t0 = (10 * i + 5 * j) * MS
            events += [
                (f"workload.{span}", False, t0 + 1, t0 + 4 * MS, corr, 0, thread),
                ("aten::mul", False, t0 + 2, t0 + 3, corr + 1, 0, thread),
                ("void at::native::vectorized_elementwise_kernel<4>", True,
                 t0 + 1 * MS, t0 + 1 * MS + int(ms * MS), corr + 2, corr + 1, 0),
            ]
            seconds[span] = ms / 1e3
            corr += 3
    return events, seconds


@pytest.mark.parametrize("metric", sorted(progspans.METRICS))
def test_each_span_metric_reads_the_span_tables_row(metric):
    events, seconds = _capture_of_every_span()
    rec = _record(devtrace.reduce(events, wall_s=0.2, steps=2))
    value = _reader(metric)(rec)
    assert value == spantable.metrics(rec["trace"]["program"])[metric]
    want = sum(seconds.get(n, 0.0) + seconds.get(f"{n}.bwd", 0.0)
               for n in progspans.METRICS[metric])
    assert value == pytest.approx(1e3 * want / 2)


@pytest.mark.parametrize("metric", sorted(progspans.METRICS))
def test_a_span_metric_with_nothing_to_read_returns_none(metric):
    assert _reader(metric)(_record(None)) is None
    plain = _record(devtrace.reduce(EVENTS, wall_s=0.010, steps=1))
    assert _reader(metric)(plain) is None


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "moe"])
def test_span_metrics_of_a_tiny_programs_step_on_the_host(moe):
    """The readers on the record of a traced step on the host (no device
    activity: 0 ms where the span ran), as the span table's rows."""
    prog = Program(tiny_cell(moe), 3000000001, "cpu", spans=True)
    prog.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.step()
    rec = _record(devtrace.reduce(_host_events(prof), wall_s=1.0, steps=1))
    rows = spantable.metrics(rec["trace"]["program"])
    for metric in progspans.METRICS:
        value = _reader(metric)(rec)
        assert value == rows[metric]
        ran = moe or metric not in ("route_ms_per_step", "dispatch_ms_per_step")
        assert value == (0.0 if ran else None), metric
