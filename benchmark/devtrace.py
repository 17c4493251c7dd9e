"""The traced span of a run: the benchmark's own spans around the port's
attention core, a ``torch.profiler`` capture of a few whole steps, and
its reduction to one record that the per-layer metric readers read.

Every device activity of the capture is kept as (name, start, end) on
the device, linked to the host event that launched it (its correlation
id), and through that to the benchmark span open on the launching thread
at that time. The reduction gives the traced wall time, the union of the
device's busy intervals, seconds by kernel class and by name, the
attention calls and their device seconds, the longest idle gaps by
the host operation that launched the kernel ending each gap, and the
port's span table (``progspans.py``), which the span metrics read.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

from benchmark import kernel_classes

FWD_SPAN, BWD_SPAN = kernel_classes.ATTN_SPANS


def spanned(attn_impl):
    """``attn_impl`` with a ``bench.attn_fwd`` span around each call and,
    through hooks on its autograd node, a ``bench.attn_bwd`` span around
    its backward. The port runs unchanged inside."""

    def attn(q, k, v):
        with record_function(FWD_SPAN):
            out = attn_impl(q, k, v)
        node = out.grad_fn
        if node is not None:
            held = []

            def enter(grad_outputs):
                held.append(record_function(BWD_SPAN))
                held[-1].__enter__()

            def leave(grad_inputs, grad_outputs):
                if held:
                    held.pop().__exit__(None, None, None)

            node.register_prehook(enter)
            node.register_hook(leave)
        return out

    return attn


def capture(run_steps, device) -> tuple[list, float]:
    """Run ``run_steps()`` under the profiler (host and CUDA activity),
    between two synchronisations; returns the raw events and the wall
    seconds between the synchronisations."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize(device)
    prof.start()
    t0 = time.perf_counter()
    run_steps()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    prof.stop()
    events = [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
               e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
               e.linked_correlation_id(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    return events, wall


def _union(intervals):
    """Merged [start, end) intervals of sorted ``intervals``."""
    merged = []
    for start, end in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class _Spans:
    """The benchmark's attention spans by thread, for lookups by time."""

    def __init__(self, host):
        by_thread = defaultdict(list)
        for name, start, end, thread in host:
            if name in kernel_classes.ATTN_SPANS:
                by_thread[thread].append((start, end, name))
        self.by_thread = {t: sorted(v) for t, v in by_thread.items()}
        self.starts = {t: [s for s, _, _ in v] for t, v in self.by_thread.items()}
        self.count = {name: sum(1 for v in self.by_thread.values()
                                for _, _, n in v if n == name)
                      for name in kernel_classes.ATTN_SPANS}

    def at(self, thread, t):
        spans = self.by_thread.get(thread)
        if not spans:
            return None
        i = bisect.bisect_right(self.starts[thread], t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return None


def _innermost(ops_by_thread, starts_by_thread, thread, t):
    """Name of the innermost host operation running on ``thread`` at
    ``t`` (not a CUDA runtime call), or None."""
    ops = ops_by_thread.get(thread, [])
    i = bisect.bisect_right(starts_by_thread.get(thread, []), t) - 1
    while i >= 0:
        start, end, name = ops[i]
        if end >= t:
            return name
        i -= 1
    return None


def reduce(events, wall_s: float, steps: int, top: int = 10) -> dict:
    """The record of one capture: ``steps`` whole steps in ``wall_s``, with
    the port's span table of the same capture under ``program``
    (``progspans.reduce``), worked out here on the host after it."""
    # progspans builds on this module's linkage, so it comes in here.
    from benchmark import progspans

    host, device = [], []
    launch_at = {}
    # The profiler mirrors host annotations (the spans, the optimizer's
    # step) onto the device's timeline; they are no device work.
    annotations = {e[0] for e in events if not e[1]}
    for name, on_device, start, end, corr, linked, thread in events:
        if on_device:
            if name not in annotations:
                device.append((start, end, name, linked))
        elif not _runtime(name):
            # Host operations only: a kernel's linked id is the id of the
            # operation that launched it; the runtime's own calls number
            # their correlations apart.
            host.append((name, start, end, thread))
            launch_at[corr] = (thread, start)
    spans = _Spans(host)
    ops_by_thread = defaultdict(list)
    for name, start, end, thread in host:
        if name not in kernel_classes.ATTN_SPANS:
            ops_by_thread[thread].append((start, end, name))
    for v in ops_by_thread.values():
        v.sort()
    op_starts = {t: [s for s, _, _ in v] for t, v in ops_by_thread.items()}

    device.sort()
    by_class = defaultdict(float)
    by_name = defaultdict(lambda: [0, 0.0, None])
    attn_s = defaultdict(float)
    linked_found = 0
    for start, end, name, linked in device:
        where = launch_at.get(linked)
        span = None
        if where is not None:
            linked_found += 1
            span = spans.at(*where)
        cls = kernel_classes.classify(name, span)
        seconds = (end - start) / 1e9
        by_class[cls] += seconds
        entry = by_name[name]
        entry[0] += 1
        entry[1] += seconds
        entry[2] = cls
        if cls == "attention":
            attn_s[span or _flash_span(name)] += seconds

    merged = _union([(s, e) for s, e, _, _ in device])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps = defaultdict(float)
    ends = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    next_kernel = {s: linked for s, _, _, linked in device}
    for gap_start, gap_end in sorted(ends, key=lambda g: g[0] - g[1])[:500]:
        where = launch_at.get(next_kernel.get(gap_end))
        label = (_innermost(ops_by_thread, op_starts, *where) if where else None)
        gaps[label or "unlinked"] += (gap_end - gap_start) / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "steps": steps,
        "window_s": wall_s,
        "busy_s": busy,
        "kernels": len(device),
        "kernels_linked": linked_found,
        "by_class_s": dict(by_class),
        "attention": {
            "fwd": {"calls": spans.count[FWD_SPAN], "seconds": attn_s[FWD_SPAN]},
            "bwd": {"calls": spans.count[BWD_SPAN], "seconds": attn_s[BWD_SPAN]},
        },
        "device_ops": [[f"{cls}: {name}", seconds]
                       for name, (_, seconds, cls) in ranked[:top]],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
        "unclassified": [name for name, (_, _, cls) in ranked if cls == "other"],
        "program": progspans.reduce(events, steps),
    }


def _runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel…)."""
    return name.startswith(("cuda", "cu")) and "::" not in name


def _flash_span(name: str) -> str:
    """A flash kernel launched outside the spans: its direction by name."""
    return FWD_SPAN if "fwd::" in name else BWD_SPAN
