"""The port's own spans in a traced capture: device time by the span of
the port (``workload.*``, ``tpumon/workload_torch/spans.py``) the host was
in when it launched each kernel.

The linkage is ``devtrace.reduce``'s: a kernel, the host operation it is
linked to (its correlation id), that operation's thread and start. A
kernel goes to the innermost ``workload.*`` span open on that thread at
that time; failing that, to the innermost one open then on the thread
that holds ``workload.step`` (the autograd engine's device thread runs
gradient sums outside every region's backward); failing that, it is
unspanned. So each span's time is its self time: what its children
launched is theirs. Kernel classes are ``devtrace``'s, the benchmark's
attention spans included, so the spans' classes add up to its
``by_class_s``.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from benchmark import devtrace, kernel_classes

#: The prefix of every span of the port.
PREFIX = "workload."

#: The span around the whole train step.
STEP = "step"

#: The per-layer numbers a span table gives (device ms a step), by the
#: spans each adds up with their backward halves.
METRICS = {
    "norm_ms_per_step": ("norm",),
    "rope_ms_per_step": ("rope",),
    "cast_ms_per_step": ("cast",),
    "loss_ms_per_step": ("loss",),
    "optimizer_ms_per_step": ("optimizer",),
    "route_ms_per_step": ("router",),
    "dispatch_ms_per_step": ("dispatch", "combine"),
}

#: Kernel classes that are products (``nongemm_ms_per_step``'s complement).
PRODUCTS = ("matmul", "attention", "nccl")


def _innermost(spans_by_thread: dict, queries: list) -> dict:
    """For each query (thread, time, key), the name of the innermost span
    of ``spans_by_thread`` (sorted (start, -end, name) lists) open on that
    thread at that time: the latest started of those with start ≤ time ≤
    end. Returns {key: name} for the queries that found one."""
    found = {}
    by_thread = defaultdict(list)
    for thread, t, key in queries:
        by_thread[thread].append((t, key))
    for thread, asked in by_thread.items():
        spans = spans_by_thread.get(thread)
        if not spans:
            continue
        asked.sort()
        opened, i = [], 0
        for t, key in asked:
            while i < len(spans) and spans[i][0] <= t:
                opened.append(spans[i])
                i += 1
            opened = [s for s in opened if -s[1] >= t]
            if opened:
                found[key] = opened[-1][2]
    return found


def reduce(events, steps: int) -> dict:
    """The span table of one capture of ``steps`` whole steps (events as
    ``devtrace.capture`` returns them): each span's calls, device seconds
    and device seconds by kernel class; the unspanned seconds; and the
    device's idle gaps by the span whose kernel ended each gap."""
    annotations = {e[0] for e in events if not e[1]}
    device, launch_at, calls = [], {}, Counter()
    ours, bench = defaultdict(list), defaultdict(list)
    for name, on_device, start, end, corr, linked, thread in events:
        if on_device:
            if name not in annotations:
                device.append((start, end, name, linked))
        elif not devtrace._runtime(name):
            launch_at[corr] = (thread, start)
            if name.startswith(PREFIX):
                short = name[len(PREFIX):]
                calls[short] += 1
                ours[thread].append((start, -end, short))
            elif name in kernel_classes.ATTN_SPANS:
                bench[thread].append((start, -end, name))
    for spans in (*ours.values(), *bench.values()):
        spans.sort()
    step_threads = sorted({t for t, spans in ours.items()
                           if any(n == STEP for _, _, n in spans)})

    device.sort()
    queries = [(*launch_at[linked], i) for i, (_, _, _, linked) in enumerate(device)
               if linked in launch_at]
    owner = _innermost(ours, queries)
    for thread in step_threads:
        left = [(thread, t, i) for _, t, i in queries if i not in owner]
        owner.update(_innermost(ours, left))
    attn = _innermost(bench, queries)

    table = {name: {"calls": n, "device_s": 0.0, "by_class_s": defaultdict(float)}
             for name, n in calls.items()}
    unspanned = defaultdict(float)
    for i, (start, end, name, _) in enumerate(device):
        cls = kernel_classes.classify(name, attn.get(i))
        seconds = (end - start) / 1e9
        if i in owner:
            entry = table[owner[i]]
            entry["device_s"] += seconds
            entry["by_class_s"][cls] += seconds
        else:
            unspanned[cls] += seconds

    idle = defaultdict(float)
    merged = devtrace._union([(s, e) for s, e, _, _ in device])
    first_at = {}
    for i, (start, _, _, linked) in enumerate(device):
        first_at.setdefault(start, (i, linked))
    for (_, gap_start), (gap_end, _) in zip(merged, merged[1:]):
        i, linked = first_at[gap_end]
        label = owner.get(i) or ("unspanned" if linked in launch_at else "unlinked")
        idle[label] += (gap_end - gap_start) / 1e9

    for entry in table.values():
        entry["by_class_s"] = dict(entry["by_class_s"])
    return {
        "steps": steps,
        "spans": table,
        "unspanned_s": sum(unspanned.values()),
        "unspanned_by_class_s": dict(unspanned),
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
    }


def ms_per_step(program: dict | None, spans) -> float | None:
    """Device ms a step of ``spans`` and their backward halves, self time,
    from a span table; None where there is no table or none of them ran."""
    if not program:
        return None
    table = program["spans"]
    ran = [n for base in spans for n in (base, base + ".bwd") if n in table]
    if not ran:
        return None
    return 1e3 * sum(table[n]["device_s"] for n in ran) / program["steps"]


def nonproduct_s(program: dict) -> float:
    """Device seconds of the table's non-product kernels, spanned or not."""
    classes = [e["by_class_s"] for e in program["spans"].values()]
    classes.append(program["unspanned_by_class_s"])
    return sum(s for by_class in classes for cls, s in by_class.items()
               if cls not in PRODUCTS)
