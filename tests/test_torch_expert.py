"""Port parity of expert parallelism: the MoE model and the harness at
ep > 1 (and MoE under sp) against ``tpumon/workload/harness.run(ep=...)``
on the conftest's forced CPU devices.

The reference splits only the expert banks over ``expert``; tokens and
the routing are replicated there, and its compiled step combines the
experts' outputs with an all-reduce, not an all-to-all
(:func:`test_reference_step_issues_no_all_to_all`). The port does the same
by hand (``models/moe.py``, ``parallel/mesh.py``).

The port's ranks are four spawned processes in a gloo group that meets at
a file; one start runs every job (``parallel.checks.run_jobs``) with a
120 s limit, so a deadlock fails fast. Both sides take the reference's
seeded weights and tokens. The reference's flash runs in interpret mode
on the CPU, the port's through the kernels' plain versions. Tolerances:
f32 losses and grad norm at rel 1e-5 (summation order only), bf16 at the
dryrun's loss |Δ| ≤ 5e-3 and grad-norm rel ≤ 0.02 (``__graft_entry__.py``);
routes, the seq gather's routing and ZeRO-1 against plain dp bit for bit.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.collective_counters import (  # noqa: E402
    expected_per_probe,
    expected_per_step,
)
from tpumon.workload_torch.models import moe as tmoe  # noqa: E402
from tpumon.workload_torch.models.moe import MoeConfig  # noqa: E402
from tpumon.workload_torch.parallel import checks, launch  # noqa: E402
from tpumon.workload_torch.parallel import mesh as mesh_mod  # noqa: E402

F32_RTOL = 1e-5
LOSS_TOL = 5e-3
GRAD_RTOL = 0.02
SPAWN_TIMEOUT_S = 120

RUN = dict(steps=2, batch=4, seq=32, with_grad_norm=True)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

#: Every harness job of the one start: name -> (mesh (dp, tp, sp, ep),
#: dtype, run kwargs, windowed with the phase probe).
JOBS = {
    "dp2ep2": ((2, 1, 1, 2), "f32", dict(grad_accum=2, remat=True), False),
    "ep2tp2": ((1, 2, 1, 2), "f32", {}, False),
    "ep4": ((1, 1, 1, 4), "f32", {}, False),
    "ep2sp2-contiguous": ((1, 1, 2, 2), "f32", dict(sp_layout="contiguous"), False),
    "ep2sp2-zigzag": ((1, 1, 2, 2), "f32", dict(sp_layout="zigzag", attn="flash"), False),
    "dp2sp2": ((2, 1, 2, 1), "f32", {}, False),
    "dp2ep2-flash-bf16": ((2, 1, 1, 2), "bf16", dict(attn="flash"), False),
    "dp2ep2-zero1": ((2, 1, 1, 2), "f32", dict(grad_accum=2, remat=True, zero1=True), False),
    "probe": ((1, 1, 2, 2), "f32", dict(
        sp_layout="zigzag", attn="flash", remat=True, grad_accum=2,
        stats_every=1, phase_stats=True), True),
}
#: The jobs held to the reference's run on the same mesh.
PARITY = ("dp2ep2", "ep2tp2", "ep4", "ep2sp2-contiguous", "ep2sp2-zigzag",
          "dp2sp2", "dp2ep2-flash-bf16")


def _reference(batch, seq, seed=0):
    """The weights and tokens ``tpumon.workload.harness.run`` draws from
    ``seed`` for the tiny MoE model, as numpy."""
    import jax

    from tpumon.workload.models import moe as jmoe

    k_params, k_data = jax.random.split(jax.random.PRNGKey(seed))
    cfg = jmoe.MoeConfig.tiny()
    params = jax.tree.map(np.asarray, jmoe.init_params(cfg, k_params))
    tokens = np.asarray(jax.random.randint(
        k_data, (batch, seq + 1), 0, cfg.vocab, jax.numpy.int32))
    return params, tokens


def _cfg(dtype):
    return dataclasses.replace(MoeConfig.tiny(), dtype=DTYPES[dtype])


@pytest.fixture(scope="module")
def expert_runs(tmp_path_factory):
    """Every job of this file in one start of four ranks, and the seq
    gather's routing check."""
    pytest.importorskip("jax")
    params, tokens = _reference(RUN["batch"], RUN["seq"])
    jobs = []
    for (dp, tp, sp, ep), dtype, kw, windowed in JOBS.values():
        jobs.append(dict(cfg=_cfg(dtype), dp=dp, tp=tp, sp=sp, ep=ep, stats=windowed,
                         routes=True, kwargs=dict(params=params, tokens=tokens,
                                                  **RUN, **kw)))
    jobs.append(dict(gather_route=True))
    ranks = launch.spawn(checks.run_jobs, 4,
                         str(tmp_path_factory.mktemp("expert") / "rendezvous"),
                         (jobs,), timeout_s=SPAWN_TIMEOUT_S)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(JOBS)}
    out["gather_route"] = [r[len(JOBS)] for r in ranks]
    out["params"], out["tokens"] = params, tokens
    return out


def _single(runs, key):
    """The single-device port's run of ``key``'s options on the same weights
    and tokens, and every MoE layer's dispatch tensors in call order."""
    _, dtype, kw, _ = JOBS[key]
    kw = {k: v for k, v in kw.items()
          if k not in ("sp_layout", "zero1", "stats_every", "phase_stats")}
    routes, route_tokens = [], tmoe.route_tokens

    def recording(*args):
        out = route_tokens(*args)
        routes.append(out[0].detach().numpy())
        return out

    tmoe.route_tokens = recording
    try:
        result = harness.run(_cfg(dtype), device="cpu", params=runs["params"],
                             tokens=runs["tokens"], **RUN, **kw)
    finally:
        tmoe.route_tokens = route_tokens
    return result, routes


@pytest.mark.parametrize("key", PARITY)
def test_expert_mesh_matches_reference(expert_runs, key):
    """dp=2×ep=2 (grad_accum and remat), ep=2×tp=2 (dryrun cell 3), ep=4
    (one expert a rank), ep=2×sp=2 in both ring layouts (cell 4), MoE at
    dp=2×sp=2 with ep = 1, and bf16 flash at dp=2×ep=2, against the
    reference's run on the same mesh, every rank."""
    import jax.numpy as jnp

    from tpumon.workload.harness import run as jax_run
    from tpumon.workload.models import moe as jmoe

    (dp, tp, sp, ep), dtype, kw, _ = JOBS[key]
    jcfg = dataclasses.replace(jmoe.MoeConfig.tiny(),
                               dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    ref = jax_run(jcfg, dp=dp, tp=tp, sp=sp, ep=ep, **RUN, **kw)
    ranks = expert_runs[key]
    for rank in ranks:
        assert len(rank["losses"]) == 2
        assert rank["losses"] == ranks[0]["losses"]
        if dtype == "f32":
            np.testing.assert_allclose(rank["losses"], ref.losses, rtol=F32_RTOL)
            assert rank["grad_norms"][-1] == pytest.approx(ref.grad_norm, rel=F32_RTOL)
        else:
            np.testing.assert_allclose(rank["losses"], ref.losses, rtol=0, atol=LOSS_TOL)
            assert abs(rank["grad_norms"][-1] - ref.grad_norm) <= GRAD_RTOL * ref.grad_norm
        assert rank["losses"][-1] < rank["losses"][0]


@pytest.mark.parametrize("key", ["dp2ep2", "ep2tp2", "ep4", "ep2sp2-contiguous"])
def test_routes_match_single_device(expert_runs, key):
    """Every rank routes its rows as the single-device port does (which
    ``tests/test_torch_moe.py`` holds bit for bit to the reference): each
    expert rank routes the whole batch row, and under sp each rank holds
    its rows of the whole sequence's routing. Bit for bit where no seq
    split is involved; under sp the routing decisions agree here too (the
    probabilities differ by summation order only, and no top-k or
    capacity edge lies within it)."""
    (dp, _, sp, _), _, kw, _ = JOBS[key]
    _, routes = _single(expert_runs, key)
    accum = kw.get("grad_accum", 1)
    rows = RUN["batch"] // dp // accum
    cols = RUN["seq"] // sp
    for rank in expert_runs[key]:
        d, c = rank["coords"]["data"], rank["coords"]["seq"]
        assert len(rank["routes"]) == len(routes)
        for mine, whole in zip(rank["routes"], routes):
            # Each data rank's chunk holds rows d·rows … of the
            # single-device chunk (strided chunks of contiguous shards).
            np.testing.assert_array_equal(
                mine, whole[d * rows:(d + 1) * rows, c * cols:(c + 1) * cols])


def test_seq_gather_routes_as_the_unsplit_sequence(expert_runs):
    """The seq gather plus ``_route`` on a seq split of given f32
    probabilities equals ``_route`` on the unsplit ones, bit for bit, with
    one all-gather a rank."""
    for rank in expert_runs["gather_route"]:
        assert rank["gathered_equal"]
        assert rank["equal"] == [True, True]
        assert rank["counts"] == {"all-gather": 1}


def test_zero1_matches_plain_dp(expert_runs):
    """ZeRO-1 at dp=2×ep=2: the moments shard over data within each expert
    coordinate, and the f32 losses and grad norms equal plain dp's bit for
    bit (AdamW is elementwise)."""
    plain, zero1 = expert_runs["dp2ep2"], expert_runs["dp2ep2-zero1"]
    for p, z in zip(plain, zero1):
        assert p["losses"] == z["losses"]
        assert p["grad_norms"] == z["grad_norms"]
        assert sum(z["moment_bytes"].values()) < sum(p["moment_bytes"].values())
        # The banks are split over expert: each rank holds E/ep of them.
        cfg = MoeConfig.tiny()
        bank = cfg.n_experts // 2 * cfg.dim * cfg.ffn_dim * 4 * 2  # f32, 2 moments
        assert p["moment_bytes"]["blocks.0.w_gate"] == bank
        assert z["moment_bytes"]["blocks.0.w_gate"] == bank // 2


def test_probe_run_matches_single_device_f32(expert_runs):
    """The windowed ep=2×sp=2 zigzag flash run with --remat, grad_accum=2
    and a phase probe each window, against the single-device port."""
    single, _ = _single(expert_runs, "probe")
    for rank in expert_runs["probe"]:
        np.testing.assert_allclose(rank["losses"], single.losses, rtol=F32_RTOL)
        np.testing.assert_allclose(rank["grad_norms"], single.grad_norms, rtol=F32_RTOL)


@pytest.mark.parametrize("key", JOBS)
def test_counts_equal_the_formula(expert_runs, key):
    """Every rank issues the formula's collectives (its own, by seq
    coordinate): the warm-up and the timed steps, plus a probe a window."""
    (dp, tp, sp, ep), _, kw, windowed = JOBS[key]
    for rank in expert_runs[key]:
        shape = dict(n_layers=MoeConfig.tiny().n_layers, dp=dp, tp=tp, sp=sp, ep=ep,
                     moe=True, remat=kw.get("remat", False), loss_chunk=0,
                     seq=RUN["seq"], zero1=kw.get("zero1", False),
                     sp_layout=kw.get("sp_layout", "contiguous"),
                     attn=kw.get("attn", "xla"), seq_coord=rank["coords"]["seq"])
        step = expected_per_step(grad_accum=kw.get("grad_accum", 1), grad_norm=True,
                                 **shape)
        probe = expected_per_probe(**shape)
        probes = RUN["steps"] if windowed else 0
        want = {op: (RUN["steps"] + 1) * step[op] + probes * probe[op] for op in step}
        assert rank["counts"] == {op: n for op, n in want.items() if n}
        assert "all-to-all" not in rank["counts"]


def test_payloads_from_the_shapes(expert_runs):
    """The bytes behind the counts, from the shapes (f32, L = 2 layers, B
    rows, s positions a rank, D = 128, E = 4), over the warm-up and the 2
    timed steps. ep=4 (B = 4, s = 32): per layer the combine's sum [B,s,D]
    forward, the expert input's gradient [B,s,D] and the routed
    probabilities' [B,s,E] backward, and the grad norm's 4 bytes a step.
    dp=2×sp=2 (B = 2, s = 16): per layer the probabilities' all-gather
    [B,s,E], the aux mean [2E] and the ring's two hops of K and V forward
    and two backward, and the gradient bucket with the loss."""
    cfg = MoeConfig.tiny()
    L, D, E = cfg.n_layers, cfg.dim, cfg.n_experts
    step = L * (2 * 4 * 32 * D + 4 * 32 * E) * 4 + 4
    for rank in expert_runs["ep4"]:
        assert rank["bytes"] == {"all-reduce": 3 * step}
    n_params = sum(p.numel() for p in tmoe.Moe(cfg).parameters())
    ar = L * 2 * E * 4 + (n_params + 1) * 4
    for rank in expert_runs["dp2sp2"]:
        hop = 2 * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 4  # K and V stacked
        assert rank["bytes"] == {"all-reduce": 3 * ar, "all-gather": 3 * L * 2 * 16 * E * 4,
                                 "collective-permute": 3 * L * 4 * hop}


def test_reference_step_issues_no_all_to_all():
    """The design's premise: the reference's own train step at dp=2×ep=2
    (MoE tiny, banks sharded with ``moe_param_specs``, tokens with
    ``batch_spec``), compiled on the conftest's CPU devices, combines the
    experts with all-reduces over the expert groups and holds no
    all-to-all. Instructions are matched by opcode, so tuple-shaped ones
    (``= (f32[..], …) all-reduce(``) count too."""
    jax = pytest.importorskip("jax")
    import optax

    from tpumon.workload.harness import make_train_step
    from tpumon.workload.models import moe as jmoe
    from tpumon.workload.parallel import mesh as jmesh

    cfg = jmoe.MoeConfig.tiny()
    mesh = jmesh.make_mesh(2, 1, 1, 1, 2, devices=jax.devices()[:4])
    params, tokens = _reference(4, 32)
    optimizer = optax.adamw(1e-3)
    step = make_train_step(cfg, optimizer, None, jmesh.make_act_sharder(mesh),
                           jmesh.make_expert_sharder(mesh))
    params = jmesh.shard_tree(params, jmesh.moe_param_specs(), mesh)
    tokens = jmesh.shard_tree(tokens, jmesh.batch_spec(), mesh)
    text = jax.jit(step).lower(params, optimizer.init(params), tokens).compile().as_text()
    ops = re.findall(r"(?<=\s)(all-to-all|all-reduce|all-gather|reduce-scatter|"
                     r"collective-permute)(?:-start)?\(", text)
    assert "all-reduce" in ops
    assert "all-to-all" not in ops, sorted(set(ops))
    # The expert groups of a 2×2 data×expert mesh are {0,1} and {2,3}.
    assert re.search(r"\sall-reduce(?:-start)?\([^\n]*replica_groups=\{\{0,1\},\{2,3\}\}",
                     text)


def test_ep_refusals(capsys, monkeypatch):
    """An expert count that ep does not divide, and ep without a MoE
    model, are refused (the reference's message for the latter) before
    any rank starts."""
    from tpumon.workload_torch.models.llama import LlamaConfig

    with pytest.raises(ValueError, match=r"n_experts \(4\) must divide by ep \(3\)"):
        tmoe.Moe(MoeConfig.tiny(), mesh=mesh_mod.Mesh(
            shape={"data": 1, "stage": 1, "expert": 3, "seq": 1, "model": 1},
            coords={}, rank=0, device=torch.device("cpu"), backend="gloo",
            groups={}, counters=None))
    with pytest.raises(ValueError, match="ep > 1 requires a MoeConfig"):
        harness.run(LlamaConfig.tiny(), steps=1, batch=4, seq=32, ep=2, device="cpu")
    monkeypatch.setattr(launch, "launch", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(SystemExit) as exc:
        harness.main(["--model", "moe", "--ep", "3", "--platform", "cpu"])
    assert exc.value.code == 2
    assert "n_experts (4) must divide by ep (3)" in capsys.readouterr().err


def test_main_runs_dp2_ep2_on_cpu(caplog):
    """The CLI at dp=2×ep=2 on the host starts its four ranks: four rank
    reports with equal losses, each rank's counts equal to the formula,
    no all-to-all among them."""
    import json

    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    argv = ["--platform", "cpu", "--model", "moe", "--preset", "tiny", "--dp", "2",
            "--ep", "2", "--batch", "4", "--seq", "32", "--steps", "2",
            "--grad-norm"]
    assert harness.main(argv) == 0
    reports = {r.args[0]: json.loads(r.args[1]) for r in caplog.records
               if str(r.msg).startswith("rank %d report")}
    assert sorted(reports) == [0, 1, 2, 3]
    step = expected_per_step(n_layers=2, dp=2, tp=1, ep=2, moe=True, grad_accum=1,
                             remat=False, loss_chunk=0, seq=32, zero1=False,
                             grad_norm=True)
    want = {op: 3 * n for op, n in step.items() if n}
    for rep in reports.values():
        assert rep["losses"] == reports[0]["losses"]
        assert rep["collectives"]["counts"] == want
    assert sorted((rep["coords"]["data"], rep["coords"]["expert"])
                  for rep in reports.values()) == [(0, 0), (0, 1), (1, 0), (1, 1)]
