"""Port parity of pipeline parallelism: ``tpumon/workload_torch/parallel/
pipeline.py`` and the harness at pp > 1 against
``tpumon/workload/harness.run(pp=...)`` on the conftest's forced CPU
devices.

The reference's four pipelined dryrun cells (``__graft_entry__.py``:
2 dp×pp×tp GPipe, 2b pp×sp interleaved, 2c and 2c-flash pp×sp zigzag, 2d
MoE pp×ep×tp) and the compositions around them run on the port's ranks:
four spawned processes in a gloo group that meets at a file, one start
for every four-rank job (``parallel.checks.run_jobs``) and one of eight
for cell 2d, each with a 120 s limit so a deadlock fails fast. Both sides
take the reference's seeded weights and tokens (the dryrun's ``pcfg``,
the tiny preset at 4 layers, where pp·interleave needs it). The
reference's flash runs in interpret mode on the CPU, the port's through
the kernels' plain versions. Tolerances: f32 losses and grad norm at rel
1e-5 (summation order only), bf16 at the dryrun's loss |Δ| ≤ 5e-3 and
grad-norm rel ≤ 0.02; ZeRO-1 against plain dp, and the schedule and the
layer storage against the reference's, exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.collective_counters import (  # noqa: E402
    expected_per_probe,
    expected_per_step,
)
from tpumon.workload_torch.models import llama as tllama  # noqa: E402
from tpumon.workload_torch.models import moe as tmoe  # noqa: E402
from tpumon.workload_torch.parallel import checks, launch, pipeline  # noqa: E402
from tpumon.workload_torch.parallel import mesh as mesh_mod  # noqa: E402
from tpumon.workload_torch.parallel.ring import flash_calls_per_layer  # noqa: E402

F32_RTOL = 1e-5
LOSS_TOL = 5e-3
GRAD_RTOL = 0.02
SPAWN_TIMEOUT_S = 120

RUN = dict(steps=2, seq=32, with_grad_norm=True)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: The models of the jobs: (family, layers).
MODELS = {"dense": ("llama", 4), "moe": ("moe", 2), "moe4": ("moe", 4)}

#: Every four-rank job: name -> (model, mesh (dp, tp, sp, pp, ep), dtype,
#: batch, run kwargs, windowed with the phase probe).
JOBS = {
    "dp2pp2": ("dense", (2, 1, 1, 2, 1), "f32", 4, dict(microbatches=2), False),
    "pp2tp2": ("dense", (1, 2, 1, 2, 1), "f32", 4, dict(microbatches=2), False),
    "pp4": ("dense", (1, 1, 1, 4, 1), "f32", 4, dict(microbatches=2), False),
    "pp2sp2-interleave2": ("dense", (1, 1, 2, 2, 1), "f32", 4, dict(
        microbatches=2, interleave=2), False),
    "pp2sp2-zigzag": ("dense", (1, 1, 2, 2, 1), "f32", 4, dict(
        microbatches=2, sp_layout="zigzag"), False),
    "dp2pp2-interleave2-remat": ("dense", (2, 1, 1, 2, 1), "f32", 8, dict(
        microbatches=4, interleave=2, remat=True), False),
    "moe-pp2ep2": ("moe", (1, 1, 1, 2, 2), "f32", 4, dict(microbatches=2), False),
    "moe-pp2tp2": ("moe", (1, 2, 1, 2, 1), "f32", 4, dict(microbatches=2), False),
    "moe-pp2ep2-interleave2": ("moe4", (1, 1, 1, 2, 2), "f32", 4, dict(
        microbatches=2, interleave=2), False),
    "pp2sp2-zigzag-flash-bf16": ("dense", (1, 1, 2, 2, 1), "bf16", 4, dict(
        microbatches=2, sp_layout="zigzag", attn="flash"), False),
    "dp2pp2-zero1": ("dense", (2, 1, 1, 2, 1), "f32", 4, dict(
        microbatches=2, zero1=True), False),
    "probe": ("dense", (1, 2, 1, 2, 1), "f32", 4, dict(
        microbatches=2, interleave=2, remat=True, attn="flash", stats_every=1,
        phase_stats=True), True),
    "moe-probe": ("moe", (2, 1, 1, 2, 1), "f32", 4, dict(
        microbatches=2, remat=True, attn="flash", stats_every=1,
        phase_stats=True), True),
}
#: The jobs held to the reference's run on the same mesh.
PARITY = ("dp2pp2", "pp2tp2", "pp4", "pp2sp2-interleave2", "pp2sp2-zigzag",
          "dp2pp2-interleave2-remat", "moe-pp2ep2", "moe-pp2tp2",
          "moe-pp2ep2-interleave2", "pp2sp2-zigzag-flash-bf16")
#: Cell 2d: MoE dp×pp×ep×tp at pp=2×ep=2×tp=2, eight ranks.
CELL_2D = ("moe", (1, 2, 1, 2, 2), "f32", 4, dict(microbatches=2), False)


def _jax_cfg(model, dtype=None):
    import jax.numpy as jnp

    from tpumon.workload.models import llama as jllama
    from tpumon.workload.models import moe as jmoe

    family, layers = MODELS[model]
    base = jmoe.MoeConfig.tiny() if family == "moe" else jllama.LlamaConfig.tiny()
    cfg = dataclasses.replace(base, n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype={"f32": jnp.float32,
                                              "bf16": jnp.bfloat16}[dtype])
    return cfg


def _reference(model, batch, seed=0):
    """The weights and tokens ``tpumon.workload.harness.run`` draws from
    ``seed`` for ``model``, as numpy."""
    import jax

    from tpumon.workload.models import llama as jllama
    from tpumon.workload.models import moe as jmoe

    cfg = _jax_cfg(model)
    init = jmoe.init_params if MODELS[model][0] == "moe" else jllama.init_params
    k_params, k_data = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, init(cfg, k_params))
    tokens = np.asarray(jax.random.randint(
        k_data, (batch, RUN["seq"] + 1), 0, cfg.vocab, jax.numpy.int32))
    return params, tokens


def _cfg(model, dtype):
    family, layers = MODELS[model]
    base = tmoe.MoeConfig.tiny() if family == "moe" else tllama.LlamaConfig.tiny()
    return dataclasses.replace(base, n_layers=layers, dtype=DTYPES[dtype])


def _job(spec):
    model, (dp, tp, sp, pp, ep), dtype, batch, kw, windowed = spec
    params, tokens = _reference(model, batch)
    return dict(cfg=_cfg(model, dtype), dp=dp, tp=tp, sp=sp, pp=pp, ep=ep,
                stats=windowed, kwargs=dict(params=params, tokens=tokens,
                                            batch=batch, **RUN, **kw))


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    """Every four-rank job of this file in one start."""
    pytest.importorskip("jax")
    ranks = launch.spawn(checks.run_jobs, 4,
                         str(tmp_path_factory.mktemp("pipeline") / "rendezvous"),
                         ([_job(spec) for spec in JOBS.values()],),
                         timeout_s=SPAWN_TIMEOUT_S)
    return {key: [r[i] for r in ranks] for i, key in enumerate(JOBS)}


def _jax_run(spec):
    from tpumon.workload.harness import run as jax_run

    model, (dp, tp, sp, pp, ep), dtype, batch, kw, _ = spec
    return jax_run(_jax_cfg(model, dtype), dp=dp, tp=tp, sp=sp, pp=pp, ep=ep,
                   batch=batch, **RUN, **kw)


def _hold(ranks, ref, dtype):
    for rank in ranks:
        assert len(rank["losses"]) == 2
        assert rank["losses"] == ranks[0]["losses"]
        assert rank["grad_norms"] == ranks[0]["grad_norms"]
        if dtype == "f32":
            np.testing.assert_allclose(rank["losses"], ref.losses, rtol=F32_RTOL)
            assert rank["grad_norms"][-1] == pytest.approx(ref.grad_norm, rel=F32_RTOL)
        else:
            np.testing.assert_allclose(rank["losses"], ref.losses, rtol=0, atol=LOSS_TOL)
            assert abs(rank["grad_norms"][-1] - ref.grad_norm) <= GRAD_RTOL * ref.grad_norm
        assert rank["losses"][-1] < rank["losses"][0]


@pytest.mark.parametrize("key", PARITY)
def test_pipeline_matches_reference(pipe_runs, key):
    """GPipe at dp=2×pp=2, pp=2×tp=2 (cell 2) and pp=4; pp=2×sp=2
    interleaved on the contiguous ring (cell 2b) and GPipe on the zigzag
    ring (cell 2c); dp=2×pp=2 interleaved over two rounds with remat; MoE
    at pp=2×ep=2 (also interleaved: the aux statistics summed over ticks)
    and pp=2×tp=2; bf16 zigzag flash at pp=2×sp=2 (cell 2c-flash): every
    rank against the reference's run on the same mesh."""
    spec = JOBS[key]
    _hold(pipe_runs[key], _jax_run(spec), spec[2])


def test_cell_2d_moe_pp2_ep2_tp2_matches_reference(tmp_path):
    """Cell 2d: MoE at pp=2×ep=2×tp=2 on eight ranks (the expert banks
    split over expert and model inside the stage bodies)."""
    pytest.importorskip("jax")
    ranks = launch.spawn(checks.run_jobs, 8, str(tmp_path / "rendezvous"),
                         ([_job(CELL_2D)],), timeout_s=SPAWN_TIMEOUT_S)
    _hold([r[0] for r in ranks], _jax_run(CELL_2D), "f32")


def test_zero1_matches_plain_dp(pipe_runs):
    """ZeRO-1 at dp=2×pp=2: the moments shard over data within each
    stage, and the f32 losses and grad norms equal plain dp's bit for
    bit (AdamW is elementwise)."""
    for plain, zero1 in zip(pipe_runs["dp2pp2"], pipe_runs["dp2pp2-zero1"]):
        assert plain["losses"] == zero1["losses"]
        assert plain["grad_norms"] == zero1["grad_norms"]
        assert sum(zero1["moment_bytes"].values()) < sum(plain["moment_bytes"].values())
        # Each stage holds its own two of the four layers.
        stage = plain["coords"]["stage"]
        held = {mesh_mod.layer_index(n) for n in plain["moment_bytes"]} - {None}
        assert held == {2 * stage, 2 * stage + 1}


def _want(key, rank):
    _, (dp, tp, sp, pp, ep), _, _, kw, windowed = JOBS[key]
    model, steps = JOBS[key][0], RUN["steps"]
    shape = dict(n_layers=MODELS[model][1], dp=dp, tp=tp, sp=sp, ep=ep, pp=pp,
                 moe=MODELS[model][0] == "moe", remat=kw.get("remat", False),
                 loss_chunk=0, seq=RUN["seq"], zero1=kw.get("zero1", False),
                 sp_layout=kw.get("sp_layout", "contiguous"),
                 attn=kw.get("attn", "xla"), seq_coord=rank["coords"]["seq"],
                 microbatches=kw["microbatches"],
                 interleave=kw.get("interleave", 1))
    step = expected_per_step(grad_accum=1, grad_norm=True, **shape)
    probe = expected_per_probe(**shape)
    probes = steps if windowed else 0
    counts = {op: (steps + 1) * step[op] + probes * probe[op] for op in step}
    return {op: n for op, n in counts.items() if n}


@pytest.mark.parametrize("key", JOBS)
def test_counts_equal_the_formula(pipe_runs, key):
    """Every rank, first and last stage alike, issues the formula's
    collectives: the warm-up and the timed steps, plus a probe a window."""
    stages = set()
    for rank in pipe_runs[key]:
        assert rank["counts"] == _want(key, rank)
        assert "collective-permute" in rank["counts"]
        stages.add(rank["coords"]["stage"])
    assert stages == set(range(JOBS[key][1][3]))


@pytest.mark.parametrize("key", ["probe", "moe-probe", "pp2sp2-zigzag-flash-bf16"])
def test_flash_calls_equal_the_formula(pipe_runs, key):
    """Every tick runs its chunk's attention forward and backward, bubble
    ticks included: T·lpg layer calls a step, each with the ring's flash
    calls of the rank, the forward twice under remat; a phase probe adds
    a forward, and a forward and backward (its recompute under remat)."""
    model, (_, _, sp, pp, _), _, _, kw, windowed = JOBS[key]
    v, remat = kw.get("interleave", 1), kw.get("remat", False)
    layer_calls = (MODELS[model][1] // (pp * v)
                   * pipeline.ticks(kw["microbatches"], pp, v))
    steps = RUN["steps"] + 1
    probes = RUN["steps"] if windowed else 0
    for rank in pipe_runs[key]:
        per_layer = (flash_calls_per_layer(sp, kw.get("sp_layout") == "zigzag",
                                           rank["coords"]["seq"]) if sp > 1 else 1)
        calls = layer_calls * per_layer
        fwd = calls * (2 if remat else 1)
        assert rank["flash_calls"] == {
            "flash_fwd": steps * fwd + probes * (calls + fwd),
            "flash_dq": steps * calls + probes * calls,
            "flash_dkv": steps * calls + probes * calls,
        }


def test_payloads_from_the_shapes(pipe_runs):
    """The bytes behind the counts at pp=2×tp=2 GPipe, f32 over the
    warm-up and 2 timed steps (L = 4, lpg = 2, M = 2 microbatches of
    mb = 2 rows, b = 4, s = 32, D = 128, vocab V = 512, T = 3 ticks): per
    step, forward the embedding's [b,s,D], each tick's 2·lpg row splits of
    [mb,s,D], the finished microbatches' [b,s,D] over stage and the
    loss's [b,s,1] and [b,s,2]; backward each tick's 2·lpg column splits,
    the unembed's input and the pipe input's gradient over stage; the grad
    norm's 8 B over model and 4 B over stage; T hops forward and T − 1
    backward of [mb,s,D]."""
    b, mb, s, D, T, lpg = 4, 2, 32, 128, 3, 2
    act = b * s * D * 4
    tick = mb * s * D * 4
    ar = 4 * act + 4 * T * lpg * tick + b * s * 3 * 4 + 8 + 4
    for rank in pipe_runs["pp2tp2"]:
        assert rank["bytes"] == {"all-reduce": 3 * ar,
                                 "collective-permute": 3 * (2 * T - 1) * tick}


M_GRID = (1, 2, 3, 4, 8)
PP_GRID = (2, 3, 4)
V_GRID = (1, 2, 3)


@pytest.mark.parametrize("v", V_GRID)
@pytest.mark.parametrize("pp", PP_GRID)
@pytest.mark.parametrize("microbatches", M_GRID)
def test_schedule_matches_reference(microbatches, pp, v):
    pytest.importorskip("jax")
    from tpumon.workload.parallel.pipeline import _schedule

    got, want = pipeline._schedule(microbatches, pp, v), _schedule(microbatches, pp, v)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == pipeline.ticks(microbatches, pp, v)


class _Taken(Exception):
    pass


class _Recorder:
    """A parameter leaf that records the index the reference's forward
    takes its layer stack at, then stops the forward."""

    def __init__(self, seen):
        self.seen = seen

    def __getitem__(self, index):
        self.seen.append(np.asarray(index))
        raise _Taken

    def astype(self, dtype):
        raise _Taken  # the embedding: the stack was never reordered


@pytest.mark.parametrize("v", V_GRID)
@pytest.mark.parametrize("pp", PP_GRID)
@pytest.mark.parametrize("lpg", (1, 2))
def test_storage_order_matches_reference(lpg, pp, v):
    """The layer stack's storage order (model block c·pp + s at stage s,
    chunk c) is the one the reference's forward takes its stack in (the
    identity at v = 1, where it takes none), and each stage's chunks are
    its rows of it."""
    jax = pytest.importorskip("jax")
    from tpumon.workload.models.llama import LlamaConfig
    from tpumon.workload.parallel.mesh import make_mesh
    from tpumon.workload.parallel.pipeline import make_pipelined_forward

    n_layers = lpg * pp * v
    mesh = make_mesh(1, 1, 1, pp, devices=jax.devices()[:pp])
    forward = make_pipelined_forward(mesh, LlamaConfig(n_layers=n_layers),
                                     microbatches=pp, interleave=v)
    seen = []
    with pytest.raises(_Taken):
        forward({"layers": {"wq": _Recorder(seen)}, "embed": _Recorder(seen)},
                np.zeros((pp, 8), np.int32))
    order = pipeline.storage_order(n_layers, pp, v)
    want = seen[0] if seen else np.arange(n_layers)
    np.testing.assert_array_equal(order, want)
    stages = [pipeline.stage_layers(n_layers, pp, v, s) for s in range(pp)]
    assert sum((sum(chunks, []) for chunks in stages), []) == order.tolist()
    assert all(len(chunks) == v and all(len(c) == lpg for c in chunks)
               for chunks in stages)


@pytest.mark.parametrize("model,kw,message", [
    ("dense", dict(interleave=0), "interleave must be >= 1, got 0"),
    ("dense", dict(interleave=3), r"n_layers (4) must divide by pp*interleave (2*3)"),
    ("dense", dict(interleave=2, microbatches=3), "microbatches (3) must divide by pp (2)"),
    ("dense", dict(microbatches=3),
     "per-data-shard batch (4) must divide by microbatches (3)"),
    ("dense", dict(grad_accum=2), "grad_accum composes with dp/tp/sp/ep, not pp"),
    ("dense", dict(loss_chunk=16), "composes with dp/tp (not MoE, pp, or sp"),
    ("moe", dict(sp=2), "pp with MoE composes with dp/ep/tp only (sp=1)"),
])
def test_run_refusals(model, kw, message):
    """The reference's refusals of a pipelined run, raised before any
    collective (no mesh is made)."""
    import re

    with pytest.raises(ValueError, match=re.escape(message)):
        harness.run(_cfg(model, "f32"), steps=1, batch=4, seq=32, pp=2,
                    device="cpu", **kw)


def test_stage_model_holds_its_layers_under_global_names():
    """A stage's model holds only its chunks' layers, keyed by their
    global index, beside the replicated ends; it refuses to run its own
    forward."""
    mesh = mesh_mod.Mesh(
        shape={"data": 1, "stage": 2, "expert": 1, "seq": 1, "model": 1},
        coords={"data": 0, "stage": 1, "expert": 0, "seq": 0, "model": 0},
        rank=1, device=torch.device("cpu"), backend="gloo", groups={}, counters=None)
    layers = sum(pipeline.stage_layers(4, 2, 2, 1), [])
    assert layers == [1, 3]
    model = tllama.Llama(_cfg("dense", "f32"), mesh=mesh, layers=layers)
    names = {n.split(".")[0] + "." + n.split(".")[1] for n in model.state_dict()
             if n.startswith("blocks.")}
    assert names == {"blocks.1", "blocks.3"}
    full = tllama.Llama(_cfg("dense", "f32")).state_dict()
    kept = mesh_mod.shard_params(full, mesh, mesh_mod.PARAM_SPECS, layers)
    assert set(kept) == set(model.state_dict())
    with pytest.raises(RuntimeError, match="parallel.pipeline"):
        model(torch.zeros((1, 8), dtype=torch.long))


def test_main_runs_pp2_tp2_interleaved_on_cpu(caplog):
    """The CLI at pp=2×tp=2 with the circular schedule on the host: it
    rounds the tiny preset's 2 layers up to 4, starts four ranks whose
    losses are equal, and each rank's counts equal the formula, the
    stage hops among them."""
    import json

    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    argv = ["--platform", "cpu", "--preset", "tiny", "--pp", "2", "--tp", "2",
            "--interleave", "2", "--microbatches", "2", "--batch", "4", "--seq", "32",
            "--steps", "2", "--grad-norm"]
    assert harness.main(argv) == 0
    assert any("rounding n_layers 2 → 4 for pp=2 interleave=2" in r.getMessage()
               for r in caplog.records)
    reports = {r.args[0]: json.loads(r.args[1]) for r in caplog.records
               if str(r.msg).startswith("rank %d report")}
    assert sorted(reports) == [0, 1, 2, 3]
    step = expected_per_step(n_layers=4, dp=1, tp=2, pp=2, microbatches=2,
                             interleave=2, grad_accum=1, remat=False, loss_chunk=0,
                             seq=32, zero1=False, grad_norm=True)
    want = {op: 3 * n for op, n in step.items() if n}
    assert want["collective-permute"] == 3 * (5 + 4)
    for rep in reports.values():
        assert rep["losses"] == reports[0]["losses"]
        assert rep["collectives"]["counts"] == want
    assert sorted((rep["coords"]["stage"], rep["coords"]["model"])
                  for rep in reports.values()) == [(0, 0), (0, 1), (1, 0), (1, 1)]
