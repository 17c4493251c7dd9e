"""Port parity: the torch harness against tpumon/workload/harness.py, and
the port's entry points, page and import boundary.

The trajectory test gives both sides the reference's seeded weights and
tokens (run() derives them from PRNGKey(seed); the port takes them as
``params=``/``tokens=``) and compares a 3-step loss trajectory and the
final gradient norm at the dryrun's tolerances: loss |Δ| ≤ 5e-3, grad-norm
relative ≤ 0.02 (__graft_entry__.py), bf16 on both sides.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.models.llama import LlamaConfig, init_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOSS_TOL = 5e-3
GRAD_RTOL = 0.02


class _LossLog:
    """Duck-typed stats sink for run(): one loss per window."""

    def __init__(self) -> None:
        self.losses: list[float] = []

    def configure(self, **_kw) -> None:
        pass

    def record(self, loss, _steps, _seconds) -> None:
        self.losses.append(loss)


RUN = dict(steps=2, batch=4, seq=64, grad_accum=2, loss_chunk=32, remat=True,
           with_grad_norm=True, stats_every=1)


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_trajectory_and_grad_norm_match_reference(attn):
    jax = pytest.importorskip("jax")
    from tpumon.workload.harness import run as jax_run
    from tpumon.workload.models.llama import LlamaConfig as JaxConfig
    from tpumon.workload.models.llama import init_params as jax_init

    key = jax.random.PRNGKey(0)
    k_params, k_data = jax.random.split(key)  # as harness.run does
    params = jax.tree.map(np.asarray, jax_init(JaxConfig.tiny(), k_params))
    tokens = np.asarray(jax.random.randint(
        k_data, (RUN["batch"], RUN["seq"] + 1), 0, JaxConfig.tiny().vocab,
        jax.numpy.int32,
    ))

    ref_log, port_log = _LossLog(), _LossLog()
    ref = jax_run(JaxConfig.tiny(), attn=attn, stats=ref_log, **RUN)
    port = harness.run(LlamaConfig.tiny(), attn=attn, stats=port_log,
                       device="cpu", params=params, tokens=tokens, **RUN)
    ref_traj = [ref.losses[0], *ref_log.losses]
    port_traj = [port.losses[0], *port_log.losses]
    assert len(port_traj) == 3
    assert port.losses[-1] == port_traj[-1]
    np.testing.assert_allclose(port_traj, ref_traj, rtol=0, atol=LOSS_TOL)
    assert abs(port.grad_norm - ref.grad_norm) <= GRAD_RTOL * ref.grad_norm
    assert port_traj[-1] < port_traj[0]


def test_page_parses_with_lifecycle_probe():
    """The port's collectors render a page the unchanged monitor reads."""
    from prometheus_client import generate_latest
    from prometheus_client.registry import CollectorRegistry

    from tpumon.lifecycle.probe import step_snapshot_from_text
    from tpumon.workload_torch.serve import ServeCollector, ServeStats
    from tpumon.workload_torch.stats import StatsCollector, WorkloadStats

    stats, serve = WorkloadStats(), ServeStats()
    serve.configure(slo_threshold_s=60.0)
    registry = CollectorRegistry()
    registry.register(StatsCollector(stats))
    registry.register(ServeCollector(serve))
    result = harness.run(
        LlamaConfig.tiny(), steps=4, batch=2, seq=32, attn="flash",
        stats=stats, stats_every=2, phase_stats=True, serve=serve, device="cpu",
    )
    snap = step_snapshot_from_text(generate_latest(registry).decode())
    assert snap["step"] == 4
    assert snap["loss"] == pytest.approx(result.losses[-1])
    assert snap["step_seconds"] > 0 and snap["steps_per_second"] > 0
    assert set(snap["phases"]) == {"fwd", "bwd", "optimizer"}
    assert snap["terminating"] is False
    assert snap["serve_requests_per_second"] > 0
    assert snap["serve_batch_size"] == 2
    assert snap["serve_slo_attainment_ratio"] == 1.0
    assert "mfu" not in snap  # no published peak for the CPU: absent, not 0
    assert "collective_wait_fraction" not in snap  # one device: absent


def test_phase_probe_leaves_live_state_untouched():
    model = init_params(LlamaConfig.tiny(), torch.Generator().manual_seed(0))
    optimizer = harness.make_optimizer(model.parameters())
    step = harness.make_train_step(model, optimizer, grad_accum=2, remat=True)
    tokens = torch.randint(0, 512, (4, 33), generator=torch.Generator().manual_seed(1))
    step(tokens)
    before = [p.detach().clone() for p in model.parameters()]
    grads = [p.grad.clone() for p in model.parameters()]
    state = {i: {k: v.clone() for k, v in s.items()}
             for i, s in optimizer.state_dict()["state"].items()}
    probe = harness._make_phase_probe(model, optimizer, None, True, 0, grad_accum=2)
    phases = probe(tokens)
    assert set(phases) == {"fwd", "bwd", "optimizer"}
    for p, b, g in zip(model.parameters(), before, grads):
        assert torch.equal(p, b) and torch.equal(p.grad, g)
    for i, s in optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, state[i][k]), (i, k)


def test_platform_cuda_raises_without_a_card(monkeypatch):
    from tpumon.workload_torch.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run(LlamaConfig.tiny(), steps=1, batch=2, seq=16)  # device=None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--steps", "1", "--platform", "cuda"])


def test_platform_cuda_raises_below_hopper(monkeypatch):
    from tpumon.workload_torch.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *_: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA A100")
    with pytest.raises(RuntimeError, match="Hopper"):
        resolve_device("cuda")


@pytest.mark.parametrize("flags,message", [
    (["--sp", "2", "--loss-chunk", "16"], "composes with dp/tp (not MoE, pp, or sp"),
    (["--sp", "2", "--seq", "33"], r"seq (33) must divide by sp (2)"),
    (["--sp", "2", "--sp-layout", "zigzag", "--seq", "34"],
     r"seq (34) must divide by 2*sp (4)"),
    (["--ep", "2"], "ep > 1 requires a MoeConfig"),
    (["--ep", "3", "--model", "moe"], "n_experts (4) must divide by ep (3)"),
    (["--pp", "2", "--grad-accum", "2"], "grad_accum composes with dp/tp/sp/ep, not pp"),
    (["--pp", "2", "--model", "moe", "--sp", "2"],
     "pp with MoE composes with dp/ep/tp only (sp=1)"),
    (["--pp", "2", "--interleave", "2", "--microbatches", "3"],
     "microbatches (3) must divide by pp (2)"),
    (["--pp", "2", "--loss-chunk", "16"], "composes with dp/tp (not MoE, pp, or sp"),
    (["--dp", "2", "--num-processes", "2"], "--num-processes > 1 requires --coordinator"),
    (["--dp", "3", "--coordinator", "127.0.0.1:1234", "--num-processes", "2"],
     "(3) must be divisible by --num-processes (2)"),
    (["--dp", "2", "--coordinator", "127.0.0.1:1234", "--num-processes", "2",
      "--process-id", "2"], "--process-id (2) must be in [0, --num-processes (2))"),
])
def test_sp_refusals_before_any_rank_starts(flags, message, capsys, monkeypatch):
    """The reference's refusals of a sequence-parallel run, of expert
    parallelism without a MoE model, of an expert count that ep does not
    divide, of a pipelined run with grad_accum, loss_chunk, MoE under sp
    or microbatches the circular schedule cannot feed in rounds of pp, and
    of a multi-host job without a coordinator, with ranks that the hosts
    cannot share evenly or a host index outside it exit with code 2 in the
    launching process: no rank is started."""
    from tpumon.workload_torch.parallel import launch

    def no_launch(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(launch, "launch", no_launch)
    with pytest.raises(SystemExit) as exc:
        harness.main([*flags, "--platform", "cpu"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_main_runs_on_cpu(caplog):
    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    assert harness.main(["--platform", "cpu", "--steps", "2", "--batch", "2",
                         "--seq", "16", "--attn", "flash"]) == 0
    assert any(r.msg.startswith("loss ") for r in caplog.records)


_IMPORT_PROBE = r"""
import importlib, pkgutil, sys
import tpumon.workload_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "optax", "tpumon.workload.")))
missing = {"tpumon.workload_torch." + m for m in (
    "models.moe", "checkpoint", "bench_attention", "parallel.mesh",
    "parallel.ring", "bench_ring", "parallel.pipeline", "entry",
    "collective_counters")} - set(names)
print(len(names), bad, sorted(missing))
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """A fresh interpreter (conftest imports jax in this one) imports
    every module of the port and finds neither jax nor tpumon.workload.*."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_profile_summary():
    """The profile phase's arithmetic on a hand-made trace of 2 steps:
    overlapping or touching spans count once toward the busy time, and
    the flash kernels are found by their C++ names."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    spans = [
        ("void fwd::fwd_kernel<128>(CUtensorMap_st)", 0.0, 100.0),
        ("void dq::dq_kernel<128>(CUtensorMap_st)", 50.0, 150.0),
        ("gemm", 300.0, 400.0),
        ("void dkv::dkv_kernel<128, 1>(CUtensorMap_st)", 400.0, 500.0),
        ("gemm", 900.0, 1000.0),
    ]
    out = chip_smoke.profile_summary(spans, wall_s=2e-3, steps=2, top=2)
    assert out["step_ms"] == pytest.approx(1.0)
    assert out["device_busy_ms_per_step"] == pytest.approx(0.225)
    assert out["idle_share"] == pytest.approx(0.775)
    assert out["flash_ms_per_step"] == pytest.approx(
        {"flash_fwd": 0.05, "flash_dq": 0.05, "flash_dkv": 0.05})
    assert out["flash_share_of_step"] == pytest.approx(0.15)
    assert out["ms_per_step_by_class"] == pytest.approx(
        {"flash": 0.15, "matmul": 0.1})
    assert [k["name"] for k in out["top_kernels"]] == [
        "gemm", "void fwd::fwd_kernel<128>(CUtensorMap_st)"]
    assert out["top_kernels"][0]["calls_per_step"] == 1.0
    assert out["top_kernels"][0]["ms_per_step"] == pytest.approx(0.1)
