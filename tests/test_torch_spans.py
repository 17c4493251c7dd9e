"""The port's spans (``tpumon/workload_torch/spans.py``): nothing while no
profiler records; under one, every named span of the train step and the
model with its backward half, at counts that follow from the step's
shape, around every host operation of the step."""

from __future__ import annotations

import copy

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tpumon.workload_torch import harness, spans  # noqa: E402
from tpumon.workload_torch.collective_counters import CollectiveCounters  # noqa: E402
from tpumon.workload_torch.models import llama, moe  # noqa: E402
from tpumon.workload_torch.ops.flash_attention import make_flash_attn  # noqa: E402

#: The tiny step: grad_accum micro-batches of seq tokens, remat, flash.
MICRO, SEQ, CHUNK = 2, 64, 32
LAYERS = llama.LlamaConfig.tiny().n_layers


def _model(is_moe: bool):
    gen = torch.Generator().manual_seed(0)
    if is_moe:
        return moe.init_params(moe.MoeConfig.tiny(), gen)
    return llama.init_params(llama.LlamaConfig.tiny(), gen)


def _chunk(is_moe: bool) -> int:
    return 0 if is_moe else CHUNK  # the port fuses the loss for dense only


def _step(model):
    opt = harness.build_optimizer(model.named_parameters(), model)
    return harness.make_train_step(
        model, opt, make_flash_attn(), grad_accum=MICRO, remat=True,
        loss_chunk=_chunk(isinstance(model, moe.Moe)))


def _tokens():
    return torch.randint(0, 512, (2 * MICRO, SEQ + 1),
                         generator=torch.Generator().manual_seed(1))


def _events(prof):
    return prof.profiler.kineto_results.events()


def _span_counts(prof) -> dict[str, int]:
    counts: dict[str, int] = {}
    for e in _events(prof):
        if e.name().startswith(spans.PREFIX):
            name = e.name()[len(spans.PREFIX):]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _graph_nodes(loss) -> list[str]:
    """The class names of every autograd node behind ``loss``."""
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_span_off_the_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("step") is spans.span("norm")
    with spans.span("step") as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("step") is not spans.span("step")


@pytest.mark.parametrize("is_moe", [False, True], ids=["llama", "moe"])
def test_off_the_profiler_the_graph_has_no_span_nodes(is_moe):
    model = _model(is_moe)
    batch = _tokens()[:MICRO]

    def loss():
        return harness.loss_fn(model, batch, make_flash_attn(), True,
                               _chunk(is_moe))

    off = _graph_nodes(loss())
    with profile(activities=[ProfilerActivity.CPU]):
        on = _graph_nodes(loss())
    span_nodes = [n for n in on if n in ("_OpenBackward", "_CloseBackward")]
    assert span_nodes
    assert not [n for n in off if n in ("_OpenBackward", "_CloseBackward")]
    assert len(off) == len(on) - len(span_nodes)


@pytest.mark.parametrize("is_moe", [False, True], ids=["llama", "moe"])
def test_a_profiled_step_is_bit_identical_to_a_plain_one(is_moe):
    plain = _model(is_moe)
    traced = copy.deepcopy(plain)
    tokens = _tokens()
    loss_off, _ = _step(plain)(tokens)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on, _ = _step(traced)(tokens)
    assert torch.equal(loss_off, loss_on)
    for (name, a), b in zip(plain.named_parameters(), traced.parameters()):
        assert torch.equal(a.grad, b.grad), name
        assert torch.equal(a, b), name


def _expected(is_moe: bool) -> dict[str, int]:
    """Spans a step of the tiny shape opens: M micro-batches of L layers,
    each layer's forward run twice (remat's recompute), its backward once,
    and, dense, the loss in SEQ / CHUNK checkpointed chunks."""
    M, L = MICRO, LAYERS
    loss = 2 if is_moe else SEQ // CHUNK  # unembed + mean, or one per chunk
    loss_runs = loss if is_moe else 2 * loss  # chunks are recomputed too
    per_layer = {"layer": 1, "norm": 2, "qkv": 1, "rope": 1, "attn_core": 1,
                 "attn_out": 1, "cast": 7}
    per_layer.update({"router": 2, "dispatch": 1, "experts": 1, "combine": 1}
                     if is_moe else {"mlp": 1})
    counts = {"step": 1, "optimizer": 1, "fwd": M, "bwd": M}
    for name, n in per_layer.items():
        counts[name] = M * 2 * L * n
        counts[f"{name}.bwd"] = M * L * n
    counts["norm"] += M  # the final norm, outside remat
    counts["norm.bwd"] += M
    counts["embed"] = counts["embed.bwd"] = M
    counts["loss"], counts["loss.bwd"] = M * loss_runs, M * loss
    counts["cast"] += M * (1 + loss_runs // (2 if is_moe else 1))  # embed, unembed
    counts["cast.bwd"] += M * (1 + (1 if is_moe else loss))
    return counts


@pytest.mark.parametrize("is_moe", [False, True], ids=["llama", "moe"])
def test_every_span_and_its_backward_half_at_the_counts_of_the_shape(is_moe):
    step, tokens = _step(_model(is_moe)), _tokens()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(tokens)
    assert _span_counts(prof) == _expected(is_moe)


def _by_thread(events):
    out: dict[int, list] = {}
    for e in events:
        out.setdefault(e.start_thread_id(), []).append(e)
    return out


def _inside(e, outer) -> bool:
    return (outer.start_ns() <= e.start_ns()
            and e.start_ns() + e.duration_ns() <= outer.start_ns() + outer.duration_ns())


@pytest.mark.parametrize("is_moe", [False, True], ids=["llama", "moe"])
def test_every_host_op_of_the_step_lies_inside_a_span(is_moe):
    step, tokens = _step(_model(is_moe)), _tokens()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(tokens)
    events = [e for e in _events(prof) if e.device_type() == torch.autograd.DeviceType.CPU]
    by_thread = _by_thread([e for e in events if e.name().startswith(spans.PREFIX)])
    step_threads = {e.start_thread_id() for e in events if e.name() == "workload.step"}
    assert len(step_threads) == 1
    ops = [e for e in events if e.name().startswith("aten::")]
    assert ops
    for op in ops:
        threads = {op.start_thread_id(), *step_threads}
        assert any(_inside(op, s) for t in threads for s in by_thread.get(t, [])), op.name()


@pytest.mark.parametrize("is_moe", [False, True], ids=["llama", "moe"])
def test_each_backward_half_holds_the_ops_of_its_region(is_moe):
    step, tokens = _step(_model(is_moe)), _tokens()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(tokens)
    events = list(_events(prof))
    halves = [e for e in events if e.name().startswith(spans.PREFIX)
              and e.name().endswith(".bwd")]
    ops = [e for e in events if e.name().startswith("aten::")]
    for half in halves:
        assert any(op.start_thread_id() == half.start_thread_id()
                   and _inside(op, half) for op in ops), half.name()


@pytest.mark.parametrize("start_at", ["backward", "forward"])
def test_a_profiler_started_or_stopped_mid_step_raises_nothing(start_at):
    """Remat's check of the recomputed saved tensors holds whether the
    profiler saw the first forward (and not the backward) or only the
    backward."""
    model = _model(False)
    batch = _tokens()[:MICRO]
    prof = profile(activities=[ProfilerActivity.CPU])
    if start_at == "forward":
        prof.start()
    loss = harness.loss_fn(model, batch, make_flash_attn(), True, CHUNK)
    if start_at == "forward":
        prof.stop()
    else:
        prof.start()
    loss.backward()
    if start_at == "backward":
        prof.stop()
    names = {e.name() for e in _events(prof)}
    assert "workload.norm" in names  # the forward or the recompute
    assert all(p.grad is not None and p.grad.isfinite().all()
               for p in model.parameters())


def test_a_collective_on_a_cpu_tensor_runs_in_its_span():
    counters = CollectiveCounters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with counters.span("all-reduce", 16, torch.device("cpu")):
            torch.ones(4).sum()
    names = [e.name() for e in _events(prof)]
    assert "workload.collective.all-reduce" in names
    assert counters.detailed_snapshot()["counts"] == {"all-reduce": 1}
