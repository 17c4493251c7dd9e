"""Port parity on a dp×tp mesh: ``tpumon/workload_torch/parallel`` and the
harness at dp=2 × tp=2 against ``tpumon/workload/harness.run(dp=2, tp=2)``
on the conftest's forced CPU devices.

The port's ranks are four spawned processes in a gloo group that meets at
a file under ``tmp_path``; one start runs several checks
(``parallel.checks``). Both sides take the reference's seeded weights and
tokens. Tolerances: f32 loss and grad norm at rel 1e-5 (summation order
only), bf16 at the dryrun's loss |Δ| ≤ 5e-3 and grad-norm rel ≤ 0.02
(``__graft_entry__.py``), ZeRO-1 against plain dp within the reference's
1e-4 (``tests/test_parallel.py``), the Megatron f/g pair at 1e-5.
"""

import dataclasses
import threading
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.models import llama as tllama  # noqa: E402
from tpumon.workload_torch.models.moe import MoeConfig  # noqa: E402
from tpumon.workload_torch.parallel import checks, launch  # noqa: E402
from tpumon.workload_torch.parallel import mesh as mesh_mod  # noqa: E402

F32_RTOL = 1e-5
LOSS_TOL = 5e-3
GRAD_RTOL = 0.02
ZERO1_TOL = 1e-4

RUN = dict(steps=2, batch=4, seq=32, with_grad_norm=True)
VARIANTS = {"plain": {}, "chunked": dict(loss_chunk=16, grad_accum=2)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _reference(module, jcfg, batch, seq, seed=0):
    """The weights and tokens ``tpumon.workload.harness.run`` draws from
    ``seed``, as numpy."""
    import jax

    k_params, k_data = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, module.init_params(jcfg, k_params))
    tokens = np.asarray(jax.random.randint(
        k_data, (batch, seq + 1), 0, jcfg.vocab, jax.numpy.int32))
    return params, tokens


def _jax_cfg(module_cfg, dtype_name):
    import jax.numpy as jnp

    return dataclasses.replace(
        module_cfg, dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name])


def _spawn(tmp_path, jobs):
    return launch.spawn(checks.run_jobs, 4, str(tmp_path / "rendezvous"), (jobs,))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """Every dense mesh check of this file in one start: the runs at both
    dtypes and variants, ZeRO-1 beside plain dp, and the f/g pair."""
    pytest.importorskip("jax")
    from tpumon.workload.models import llama as jllama

    params, tokens = _reference(jllama, jllama.LlamaConfig.tiny(),
                                RUN["batch"], RUN["seq"])
    jobs, keys = [], []
    for dname, dtype in DTYPES.items():
        for vname, variant in VARIANTS.items():
            cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=dtype)
            jobs.append(dict(cfg=cfg, dp=2, tp=2, kwargs=dict(
                params=params, tokens=tokens, **RUN, **variant)))
            keys.append((dname, vname))
    f32 = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    jobs.append(dict(cfg=f32, dp=2, tp=2, kwargs=dict(
        params=params, tokens=tokens, zero1=True, **RUN)))
    keys.append("zero1")
    jobs.append(dict(pair=True))
    keys.append("pair")
    ranks = _spawn(tmp_path_factory.mktemp("dense"), jobs)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys)}
    return {"params": params, "tokens": tokens, **out}


@pytest.mark.parametrize("dp,tp,sp,pp,ep", [
    (2, 2, 1, 1, 1), (4, 1, 1, 1, 1), (1, 4, 1, 1, 1), (2, 1, 2, 2, 1),
    (1, 2, 1, 2, 2),
])
def test_mesh_layout_matches_reference(dp, tp, sp, pp, ep):
    """Which ranks share each axis's group, against the reference's
    ``make_mesh`` (device ids stand for ranks)."""
    jax = pytest.importorskip("jax")
    from tpumon.workload.parallel.mesh import make_mesh

    total = dp * tp * sp * pp * ep
    ref = make_mesh(dp, tp, sp, pp, ep, devices=jax.devices()[:total])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    grid = mesh_mod.layout(dp, tp, sp, pp, ep)
    assert grid.shape == ids.shape and mesh_mod.AXES == ref.axis_names
    for axis in mesh_mod.AXES:
        assert mesh_mod.axis_groups(grid, axis) == mesh_mod.axis_groups(ids, axis)
    assert mesh_mod.axis_groups(grid, "model")[0] == list(range(tp))


def test_copy_reduce_pair_matches_unsplit_product(dense):
    for rank in dense["pair"]:
        for key in ("out", "dx", "dw1", "dw2"):
            assert rank[key] <= 1e-5, (key, rank[key])
        # One all-reduce forward (g), one backward (f), over model only.
        assert rank["counts"] == {"all-reduce": 2}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_mesh_matches_reference(dense, dtype, variant):
    """dp=2×tp=2 against the reference's dp=2×tp=2 run, every rank."""
    pytest.importorskip("jax")
    from tpumon.workload.harness import run as jax_run
    from tpumon.workload.models import llama as jllama

    ref = jax_run(_jax_cfg(jllama.LlamaConfig.tiny(), dtype), dp=2, tp=2,
                  **RUN, **VARIANTS[variant])
    for rank in dense[(dtype, variant)]:
        assert len(rank["losses"]) == 2
        if dtype == "f32":
            np.testing.assert_allclose(rank["losses"], ref.losses, rtol=F32_RTOL)
            assert rank["grad_norms"][-1] == pytest.approx(ref.grad_norm, rel=F32_RTOL)
        else:
            np.testing.assert_allclose(rank["losses"], ref.losses, rtol=0,
                                       atol=LOSS_TOL)
            assert abs(rank["grad_norms"][-1] - ref.grad_norm) <= GRAD_RTOL * ref.grad_norm
        assert rank["losses"][-1] < rank["losses"][0]


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_mesh_matches_single_device_f32(dense, variant):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    single = harness.run(cfg, device="cpu", params=dense["params"],
                         tokens=dense["tokens"], **RUN, **VARIANTS[variant])
    for rank in dense[("f32", variant)]:
        np.testing.assert_allclose(rank["losses"], single.losses, rtol=F32_RTOL)
        np.testing.assert_allclose(rank["grad_norms"], single.grad_norms,
                                   rtol=F32_RTOL)


def test_zero1_matches_plain_dp(dense):
    """ZeRO-1 against plain dp on the same weights (AdamW is elementwise,
    so the f32 losses come out bit for bit), with each rank holding 1/dp
    of the moments of every leaf that has a dim to shard."""
    plain, zero1 = dense[("f32", "plain")], dense["zero1"]
    for p, z in zip(plain, zero1):
        assert max(abs(a - b) for a, b in zip(p["losses"], z["losses"])) < ZERO1_TOL
        assert p["losses"] == z["losses"]  # bit for bit
        assert p["grad_norms"] == z["grad_norms"]
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.Llama(cfg, mesh=types.SimpleNamespace(tp=2))
    for name, param in model.named_parameters():
        dim = mesh_mod.zero1_dim(param.shape, mesh_mod.split_dim(
            name, mesh_mod.PARAM_SPECS), 2)
        for p, z in zip(plain, zero1):
            want = p["moment_bytes"][name] // 2 if dim is not None else p["moment_bytes"][name]
            assert z["moment_bytes"][name] == want, name
    assert sum(zero1[0]["moment_bytes"].values()) < sum(plain[0]["moment_bytes"].values())


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    pytest.importorskip("jax")
    from tpumon.workload.models import moe as jmoe

    params, tokens = _reference(jmoe, jmoe.MoeConfig.tiny(), RUN["batch"], RUN["seq"])
    cfg = dataclasses.replace(MoeConfig.tiny(), dtype=torch.float32)
    jobs = [dict(cfg=cfg, dp=2, tp=2, routes=True, kwargs=dict(
        params=params, tokens=tokens, grad_accum=2, remat=True, **RUN))]
    ranks = _spawn(tmp_path_factory.mktemp("moe"), jobs)
    return {"params": params, "tokens": tokens, "ranks": [r[0] for r in ranks]}


def test_moe_mesh_matches_reference_f32(moe):
    """MoE tiny at dp=2×tp=2 (expert banks split on the FFN dim, router
    replicated) against the reference's dp=2×tp=2 run in f32; every
    layer's routing on the mesh is bit for bit the single-device port's,
    which ``tests/test_torch_moe.py`` holds bit for bit to the reference."""
    pytest.importorskip("jax")
    from tpumon.workload.harness import run as jax_run
    from tpumon.workload.models import moe as jmoe
    from tpumon.workload_torch.models import moe as tmoe

    kw = dict(grad_accum=2, remat=True, **RUN)
    ref = jax_run(_jax_cfg(jmoe.MoeConfig.tiny(), "f32"), dp=2, tp=2, **kw)
    cfg = dataclasses.replace(MoeConfig.tiny(), dtype=torch.float32)
    routes, route_tokens = [], tmoe.route_tokens

    def recording(*args):
        out = route_tokens(*args)
        routes.append(out[0].detach().numpy())
        return out

    tmoe.route_tokens = recording
    try:
        single = harness.run(cfg, device="cpu", params=moe["params"],
                             tokens=moe["tokens"], **kw)
    finally:
        tmoe.route_tokens = route_tokens
    for d, rank in enumerate(moe["ranks"][::2]):  # model rank 0 of each data rank
        np.testing.assert_allclose(rank["losses"], ref.losses, rtol=F32_RTOL)
        assert rank["grad_norms"][-1] == pytest.approx(ref.grad_norm, rel=F32_RTOL)
        # Each data rank routes its own rows: batch rows 2d, 2d+1, one per
        # accumulation chunk; the single-device run routes rows {0, 2} then
        # {1, 3}.
        assert len(rank["routes"]) == len(routes)
        for mine, whole in zip(rank["routes"], routes):
            np.testing.assert_array_equal(mine[0], whole[d])
    for rank in moe["ranks"]:
        assert rank["losses"] == moe["ranks"][0]["losses"]


def test_reference_rejections(capsys):
    """n_kv_heads % tp, zero1 without dp ≥ 2, and a per-shard batch that
    grad_accum does not divide (the reference's ValueErrors)."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), n_kv_heads=1)
    with pytest.raises(ValueError, match=r"n_kv_heads \(1\) must divide by tp \(2\)"):
        tllama.Llama(cfg, mesh=types.SimpleNamespace(tp=2))
    with pytest.raises(ValueError, match="dp > 1"):
        harness.run(tllama.LlamaConfig.tiny(), steps=1, batch=4, seq=32, tp=2,
                    zero1=True, device="cpu")
    with pytest.raises(ValueError, match=r"per-data-shard batch \(2\) must divide"):
        harness.run(tllama.LlamaConfig.tiny(), steps=1, batch=4, seq=32, dp=2,
                    grad_accum=4, device="cpu")
    with pytest.raises(SystemExit) as exc:
        harness.main(["--zero1", "--tp", "2", "--platform", "cpu"])
    assert exc.value.code == 2 and "--dp > 1" in capsys.readouterr().err


def test_a_failed_rank_ends_the_others(tmp_path):
    """A rank that raises fails the start, and the ranks waiting on it in
    a collective are stopped, not waited on."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(checks.fail_on_rank, 4, str(tmp_path / "rendezvous"), (1,))
    assert time.monotonic() - t0 < launch.KILL_GRACE_S


class _Scraper:
    """Keeps every page of ``url`` that holds ``want`` while running."""

    def __init__(self, url: str, want: str) -> None:
        self.url, self.want, self.pages = url, want, []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._done.is_set():
            try:
                with urllib.request.urlopen(self.url, timeout=2) as resp:
                    text = resp.read().decode()
                if self.want in text:
                    self.pages.append(text)
            except OSError:
                pass
            self._done.wait(0.1)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=10)


def test_main_runs_a_mesh_on_cpu_and_rank0_page_parses(caplog):
    """``harness.main`` at --dp 2 --tp 2 on the host starts its four ranks
    itself; rank 0's page carries the collective families (names the
    monitor registers) and the wait fraction, and the lifecycle probe
    reads the mesh's axes."""
    from tpumon.families import WORKLOAD_FAMILIES
    from tpumon.lifecycle.probe import step_snapshot_from_text

    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    port = launch.free_port()
    argv = ["--dp", "2", "--tp", "2", "--platform", "cpu", "--steps", "8",
            "--stats-every", "2", "--batch", "4", "--seq", "32", "--attn",
            "flash", "--phase-stats", "--metrics-port", str(port)]
    with _Scraper(f"http://127.0.0.1:{port}/metrics",
                  "tpu_step_collective_wait_fraction") as scraper:
        assert harness.main(argv) == 0
    assert scraper.pages, "never scraped rank 0's page with the wait fraction"
    page = scraper.pages[-1]
    snap = step_snapshot_from_text(page)
    assert 0.0 <= snap["collective_wait_fraction"] <= 1.0
    assert snap["axes"] == {"dp": 2, "tp": 2, "sp": 1, "pp": 1, "ep": 1}
    assert set(snap["phases"]) == {"fwd", "bwd", "optimizer"}
    families = {line.split()[2].removesuffix("_total") + "_total"
                for line in page.splitlines()
                if line.startswith(("# TYPE workload_collective",
                                    "# TYPE workload_hlo"))}
    assert families == {
        "workload_collective_ops_total", "workload_hlo_log_events_total",
        "workload_collective_op_latency_microseconds_total",
        "workload_collective_op_latency_samples_total",
        "workload_collective_op_bytes_total",
    }
    assert families <= set(WORKLOAD_FAMILIES)
    assert 'workload_collective_ops_total{op="all-reduce"}' in page
    reports = [r for r in caplog.records if r.getMessage().startswith("rank ")]
    assert len(reports) == 4


@pytest.mark.cuda
def test_tp2_kernel_case_on_card():
    """One rank's attention on the medium train step at dp=2×tp=2 (B=1,
    S=4096, H=8, KV=2, D=128, causal): each kernel against its plain
    version at chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    from tpumon.workload_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(1, 4096, 8, 128), randn(1, 4096, 2, 128), randn(1, 4096, 2, 128), randn(1, 4096, 8, 128)
    o, lse = fa.flash_fwd(q, k, v)
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v)
    assert (o.float() - ref_o.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = fa.flash_delta(ref_o, do)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    assert rel(fa.flash_dq(q, k, v, do, ref_lse, delta),
               fa.flash_dq_reference(q, k, v, do, ref_lse, delta)) <= 1e-2
    dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta)
    ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta)
    assert rel(dk, ref_dk) <= 1e-2 and rel(dv, ref_dv) <= 1e-2
