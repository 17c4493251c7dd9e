"""The port's entry points (``tpumon/workload_torch/entry.py``) against the
reference's: ``__graft_entry__.entry`` and ``dryrun_multichip``,
``bench.py::probe_compiled_kernel`` and
``tpumon/discovery/topology.py::_jax_chip_count``.

The forward runs on weights transplanted from the reference's
(``from_jax_params``): f32 at rel 1e-5, bf16 at the dryrun's bounds
(loss |Δ| ≤ 5e-3, the logits' relative L2 ≤ 0.02). The dryrun matrix
runs at n = 4 on the CPU here (one start of four ranks); n = 8 is marked
slow, as the reference's own dryrun test is.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import entry as entry_mod  # noqa: E402
from tpumon.workload_torch.models.llama import LlamaConfig, from_jax_params  # noqa: E402

LOSS_TOL = 5e-3
GRAD_RTOL = 0.02


def _reference_forward(dtype_name):
    """The reference entry()'s params (numpy), tokens and logits at the
    given dtype."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import entry as jax_entry
    from tpumon.workload.models.llama import LlamaConfig as JaxConfig
    from tpumon.workload.models.llama import forward

    _, (params, tokens) = jax_entry()
    cfg = dataclasses.replace(
        JaxConfig.tiny(), dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name])
    logits = forward(params, tokens, cfg)
    return (jax.tree.map(np.asarray, params), np.asarray(tokens),
            np.asarray(logits, np.float32))


def _nll(logits, tokens):
    logits = torch.tensor(np.array(logits), dtype=torch.float32)
    targets = torch.tensor(np.array(tokens), dtype=torch.long)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)).item()


def test_entry_gives_the_tiny_forward_and_its_arguments():
    fn, (model, tokens) = entry_mod.entry(platform="cpu")
    assert tokens.dtype == torch.int64 and tuple(tokens.shape) == (2, 32)
    assert not tokens.any()
    with torch.no_grad():
        out = fn(model, tokens)
    assert tuple(out.shape) == (2, 32, 512) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_entry_forward_matches_reference_entry(dtype_name):
    params, ref_tokens, ref = _reference_forward(dtype_name)
    fn, (_, tokens) = entry_mod.entry(platform="cpu")
    assert np.array_equal(tokens.numpy(), ref_tokens)
    cfg = dataclasses.replace(
        LlamaConfig.tiny(), dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name])
    with torch.no_grad():
        got = fn(from_jax_params(cfg, params, "cpu"), tokens).float().numpy()
    assert got.shape == ref.shape == (2, 32, 512)
    if dtype_name == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    else:
        assert abs(_nll(got, ref_tokens) - _nll(ref, ref_tokens)) <= LOSS_TOL
        assert np.linalg.norm(got - ref) <= GRAD_RTOL * np.linalg.norm(ref)


#: The reference's cells for n ranks, with their meshes (dp, tp, sp, pp,
#: ep), read off ``__graft_entry__.dryrun_multichip``'s rules.
CELLS = {
    2: [("1", (1, 2, 1, 1, 1)), ("2", (1, 1, 1, 2, 1)), ("3", (1, 1, 1, 1, 2)),
        ("5", (1, 2, 1, 1, 1))],
    4: [("1", (1, 2, 2, 1, 1)), ("1b", (1, 2, 2, 1, 1)), ("1c", (1, 2, 2, 1, 1)),
        ("1d", (1, 2, 2, 1, 1)), ("2", (1, 1, 1, 4, 1)), ("3", (1, 1, 1, 1, 4)),
        ("5", (2, 2, 1, 1, 1)), ("6", (2, 2, 1, 1, 1))],
    8: [("1", (2, 2, 2, 1, 1)), ("1b", (2, 2, 2, 1, 1)), ("1c", (2, 2, 2, 1, 1)),
        ("1d", (2, 2, 2, 1, 1)), ("2", (1, 2, 1, 4, 1)), ("2b", (2, 1, 2, 2, 1)),
        ("2c", (2, 1, 2, 2, 1)), ("2c-flash", (2, 1, 2, 2, 1)),
        ("2d", (1, 2, 1, 2, 2)), ("3", (1, 2, 1, 1, 4)), ("4", (1, 1, 2, 1, 4)),
        ("5", (2, 2, 1, 1, 1)), ("6", (2, 2, 1, 1, 1))],
}


@pytest.mark.parametrize("n", sorted(CELLS))
def test_dryrun_cells_are_the_reference_cells(n):
    cells = entry_mod.dryrun_cells(n)
    got = [(c.name, tuple(c.mesh[a] for a in ("dp", "tp", "sp", "pp", "ep")))
           for c in cells]
    assert got == CELLS[n]
    for cell in cells:
        assert cell.batch == 2 * cell.mesh["dp"] and cell.ranks <= n
    by_name = {c.name: c for c in cells}
    flash = {name for name, c in by_name.items() if c.kwargs.get("attn") == "flash"}
    assert flash == {"1c", "1d", "2c-flash", "5"} & set(by_name)
    if n == 8:
        assert by_name["2b"].kwargs == {"microbatches": 2, "interleave": 2}
        assert by_name["2c-flash"].kwargs == {"microbatches": 2, "sp_layout": "zigzag",
                                              "attn": "flash"}
        assert by_name["5"].ranks == 4 and by_name["2d"].cfg.n_experts == 4
        assert by_name["2"].cfg.n_layers == 4


def _cell():
    return entry_mod.dryrun_cells(2)[0]


@pytest.mark.parametrize("loss,gnorm,message", [
    (5.0 + 6e-3, 1.0, "diverges from dense"),
    (5.0, 1.03, "grad-norm"),
    (float("nan"), 1.0, "non-finite"),
])
def test_a_cell_outside_the_bounds_raises(loss, gnorm, message):
    with pytest.raises(RuntimeError, match=message):
        entry_mod.check_cell(_cell(), loss, gnorm, 5.0, 1.0)


def test_a_cell_inside_the_bounds_passes():
    delta, rel = entry_mod.check_cell(_cell(), 5.004, 1.019, 5.0, 1.0)
    assert delta == pytest.approx(0.004) and rel == pytest.approx(0.019)


def test_dryrun_multichip_4_on_cpu(capsys):
    """All eight cells of n = 4 on one start of four CPU ranks, each
    within the bounds of the dense step (else it raises), cells 5 and 6
    on the full world; the reference's lines are printed."""
    rows = entry_mod.dryrun_multichip(4, platform="cpu")
    out = capsys.readouterr().out
    assert [r["cell"] for r in rows] == [name for name, _ in CELLS[4]]
    for row in rows:
        assert row["loss_abs"] <= LOSS_TOL and row["grad_norm_rel"] <= GRAD_RTOL
        assert row["launches_rank0"] == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    assert "dryrun dp=1 tp=2 sp=2 over 4 ranks: loss=" in out
    assert "dryrun dp=2 tp=2 zero1: loss=" in out
    assert out.rstrip().splitlines()[-1].startswith("dryrun_multichip OK: dp×tp×sp, ")


@pytest.mark.slow
def test_dryrun_multichip_8_on_cpu(capsys):
    """The whole matrix: 13 cells on eight ranks, cells 5 and 6 on a
    sub-mesh of four (the other four sit them out)."""
    rows = entry_mod.dryrun_multichip(8, platform="cpu")
    assert [r["cell"] for r in rows] == [name for name, _ in CELLS[8]]
    assert [r["ranks"] for r in rows if r["cell"] in ("5", "6")] == [4, 4]
    assert "exercised on 8 ranks" in capsys.readouterr().out


def test_probe_disabled_by_env(monkeypatch):
    monkeypatch.setenv("TPUMON_BENCH_KERNEL_PROBE", "0")
    assert entry_mod.probe_compiled_kernel() == {
        "validated": False, "detail": "probe disabled by env"}


def test_probe_without_a_card_is_not_validated(monkeypatch):
    """The probe runs in a subprocess that asks for the card: with none
    (hidden here as on a host without one) it fails, and the detail is
    the reason."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.delenv("TPUMON_BENCH_KERNEL_PROBE", raising=False)
    got = entry_mod.probe_compiled_kernel(timeout_s=120)
    assert got["validated"] is False
    assert "no CUDA device" in got["detail"]


def test_probe_timeout_is_reported(monkeypatch):
    monkeypatch.delenv("TPUMON_BENCH_KERNEL_PROBE", raising=False)
    monkeypatch.setattr(entry_mod, "_KERNEL_PROBE_CODE", "import time; time.sleep(30)")
    got = entry_mod.probe_compiled_kernel(timeout_s=1)
    assert got == {"validated": False, "detail": "probe timed out after 1s"}


def test_gpu_chip_count_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert entry_mod.gpu_chip_count() == (0, "none")


def test_chip_counter_counts_cards_once():
    calls = []

    def count():
        calls.append(1)
        return 2

    counter = entry_mod.ChipCounter(count)
    assert counter() == (2, "gpu") and counter() == (2, "gpu")
    assert len(calls) == 1


def test_chip_counter_times_out_to_zero_then_picks_up_the_count():
    release = threading.Event()

    def hung():
        release.wait(10)
        return 4

    counter = entry_mod.ChipCounter(hung)
    assert counter(timeout_s=0.1) == (0, "none")
    release.set()
    assert counter(timeout_s=5) == (4, "gpu")


def test_chip_counter_failure_reads_as_none():
    def broken():
        raise RuntimeError("no CUDA enumeration")

    assert entry_mod.ChipCounter(broken)() == (0, "none")
