"""Port parity of ring sequence parallelism: ``tpumon/workload_torch/
parallel/ring.py`` and the harness at sp > 1 against
``tpumon/workload/harness.run(sp=...)`` on the conftest's forced CPU
devices, and the ring's local math against the reference's ring algebra.

The port's ranks are four spawned processes in a gloo group that meets at
a file (one start runs every job, ``parallel.checks.run_jobs``, with a
120 s limit so a deadlock fails fast). Both sides take the reference's
seeded weights and tokens. The reference's flash runs in interpret mode
on the CPU, the port's through the kernels' plain versions. Tolerances:
f32 losses and grad norm at rel 1e-5 (summation order only), bf16 at the
dryrun's loss |Δ| ≤ 5e-3 and grad-norm rel ≤ 0.02
(``__graft_entry__.py``), the local math at atol 1e-5 and the lse merge
at 1e-6 in f32.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.collective_counters import (  # noqa: E402
    expected_per_probe,
    expected_per_step,
)
from tpumon.workload_torch.models import llama as tllama  # noqa: E402
from tpumon.workload_torch.parallel import checks, launch, ring  # noqa: E402

F32_RTOL = 1e-5
LOSS_TOL = 5e-3
GRAD_RTOL = 0.02
MATH_ATOL = 1e-5
MERGE_ATOL = 1e-6
SPAWN_TIMEOUT_S = 120

RUN = dict(steps=2, batch=4, seq=32, with_grad_norm=True)
MESHES = {"dp2sp2": (2, 1, 2), "tp2sp2": (1, 2, 2)}
LAYOUTS = ("contiguous", "zigzag")
ATTNS = ("xla", "flash")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

#: Every harness job of the one start: name -> (mesh (dp, tp, sp), dtype,
#: run kwargs, windowed with the phase probe).
JOBS = {
    **{f"{m}-{layout}-{attn}-f32": (MESHES[m], "f32", dict(sp_layout=layout, attn=attn), False)
       for m in MESHES for layout in LAYOUTS for attn in ATTNS},
    "tp2sp2-zigzag-flash-bf16": ((1, 2, 2), "bf16", dict(
        sp_layout="zigzag", attn="flash"), False),
    # Rank 0 of a contiguous causal flash ring attends no arriving block.
    "sp4-contiguous-flash-f32": ((1, 1, 4), "f32", dict(
        sp_layout="contiguous", attn="flash"), False),
    "sp4-zigzag-xla-f32": ((1, 1, 4), "f32", dict(
        sp_layout="zigzag", attn="xla"), False),
    "remat_probe": ((1, 2, 2), "f32", dict(
        sp_layout="zigzag", attn="flash", remat=True, grad_accum=2,
        stats_every=1, phase_stats=True), True),
}


def _reference(batch, seq, seed=0):
    """The weights and tokens ``tpumon.workload.harness.run`` draws from
    ``seed`` for the tiny dense model, as numpy."""
    import jax

    from tpumon.workload.models import llama as jllama

    k_params, k_data = jax.random.split(jax.random.PRNGKey(seed))
    cfg = jllama.LlamaConfig.tiny()
    params = jax.tree.map(np.asarray, jllama.init_params(cfg, k_params))
    tokens = np.asarray(jax.random.randint(
        k_data, (batch, seq + 1), 0, cfg.vocab, jax.numpy.int32))
    return params, tokens


def _jax_run(dp, tp, sp, dtype, **kw):
    import jax.numpy as jnp

    from tpumon.workload.harness import run as jax_run
    from tpumon.workload.models import llama as jllama

    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                              dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    return jax_run(cfg, dp=dp, tp=tp, sp=sp, **RUN, **kw)


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every ring job of this file in one start of four ranks."""
    pytest.importorskip("jax")
    params, tokens = _reference(RUN["batch"], RUN["seq"])
    jobs = []
    for (dp, tp, sp), dtype, kw, windowed in JOBS.values():
        cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=DTYPES[dtype])
        jobs.append(dict(cfg=cfg, dp=dp, tp=tp, sp=sp, stats=windowed, kwargs=dict(
            params=params, tokens=tokens, **RUN, **kw)))
    ranks = launch.spawn(checks.run_jobs, 4,
                         str(tmp_path_factory.mktemp("ring") / "rendezvous"),
                         (jobs,), timeout_s=SPAWN_TIMEOUT_S)
    return {key: [r[i] for r in ranks] for i, key in enumerate(JOBS)}


def _hold(ranks, ref, dtype):
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


@pytest.mark.parametrize("attn", ATTNS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_ring_matches_reference_f32(ring_runs, mesh, layout, attn):
    """dp=2×sp=2 and tp=2×sp=2 in both layouts and on both attention
    paths against the reference's run on the same mesh, every rank."""
    ref = _jax_run(*MESHES[mesh], "f32", sp_layout=layout, attn=attn)
    _hold(ring_runs[f"{mesh}-{layout}-{attn}-f32"], ref, "f32")


def test_zigzag_flash_matches_reference_bf16(ring_runs):
    ref = _jax_run(1, 2, 2, "bf16", sp_layout="zigzag", attn="flash")
    _hold(ring_runs["tp2sp2-zigzag-flash-bf16"], ref, "bf16")


@pytest.mark.parametrize("layout,attn", [("contiguous", "flash"), ("zigzag", "xla")])
def test_sp4_matches_reference_f32(ring_runs, layout, attn):
    """sp=4: on the contiguous causal flash ring rank 0 attends no
    arriving block, and its backward still runs the reverse hops; under
    zigzag the ranks whose carriers map to themselves send less."""
    ref = _jax_run(1, 1, 4, "f32", sp_layout=layout, attn=attn)
    _hold(ring_runs[f"sp4-{layout}-{attn}-f32"], ref, "f32")


@pytest.mark.parametrize("key", JOBS)
def test_counts_equal_the_formula(ring_runs, key):
    """Every rank issues the formula's collectives (its own, by seq
    coordinate): the warm-up and the timed steps, plus a probe a window."""
    (dp, tp, sp), _, kw, windowed = JOBS[key]
    for rank in ring_runs[key]:
        shape = dict(n_layers=tllama.LlamaConfig.tiny().n_layers, dp=dp, tp=tp,
                     remat=kw.get("remat", False), loss_chunk=0, seq=RUN["seq"],
                     zero1=False, sp=sp, sp_layout=kw["sp_layout"], attn=kw["attn"],
                     seq_coord=rank["coords"]["seq"])
        step = expected_per_step(grad_accum=kw.get("grad_accum", 1), grad_norm=True, **shape)
        probe = expected_per_probe(**shape)
        probes = RUN["steps"] if windowed else 0
        want = {op: (RUN["steps"] + 1) * step[op] + probes * probe[op] for op in step}
        assert rank["counts"] == {op: n for op, n in want.items() if n}


def test_remat_probe_matches_single_device_f32(ring_runs):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    params, tokens = _reference(RUN["batch"], RUN["seq"])
    single = harness.run(cfg, device="cpu", params=params, tokens=tokens,
                         remat=True, grad_accum=2, **RUN)
    for rank in ring_runs["remat_probe"]:
        np.testing.assert_allclose(rank["losses"], single.losses, rtol=F32_RTOL)
        np.testing.assert_allclose(rank["grad_norms"], single.grad_norms, rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# Single process: the ring's pieces against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(2, 9))
def test_zigzag_perms_match_reference(n):
    pytest.importorskip("jax")
    from tpumon.workload.parallel.ring import _zigzag_perms

    assert ring._zigzag_perms(n) == _zigzag_perms(n)


def _stripes(x, n):
    return list(torch.chunk(x, 2 * n, dim=1))


def _ring_outputs(q, k, v, n, variant, **tiles):
    """The full output of the ring's local math run for every rank d in
    one process, blocks cut from the full k/v as the hops would deliver
    them (block i from rank (d − i) mod n); ``tiles`` (block_q, block_k)
    go to the flash variants."""
    zigzag, flash = variant.startswith("zigzag"), variant.endswith("flash")
    if zigzag:
        def shard(x, d):
            s = _stripes(x, n)
            return torch.cat([s[d], s[2 * n - 1 - d]], dim=1)
    else:
        def shard(x, d):
            return torch.chunk(x, n, dim=1)[d]
    outs = []
    for d in range(n):
        blocks = [(shard(k, (d - i) % n), shard(v, (d - i) % n)) for i in range(n)]
        if zigzag:
            math_fn = ring._zigzag_flash_math if flash else ring._zigzag_attention_math
        else:
            math_fn = ring._ring_flash_math if flash else ring._ring_attention_math
        outs.append(math_fn(shard(q, d), blocks, d, n, **tiles))
    if not zigzag:
        return torch.cat(outs, dim=1)
    stripes = [None] * (2 * n)
    for d, out in enumerate(outs):
        lo, hi = torch.chunk(out, 2, dim=1)
        stripes[d], stripes[2 * n - 1 - d] = lo, hi
    return torch.cat(stripes, dim=1)


VARIANTS = ("contiguous", "contiguous-flash", "zigzag", "zigzag-flash")


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("variant", VARIANTS)
def test_local_math_matches_reference_ring(variant, n):
    """The local math over given blocks, assembled over every rank, with
    its gradients, against the reference's ring (``make_ring_attn`` in a
    shard_map over n CPU devices) and against ``reference_attention``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tpumon.workload.parallel.mesh import make_mesh
    from tpumon.workload.parallel.ring import make_ring_attn

    rng = np.random.default_rng(n)
    B, S, H, KV, D = 2, 32, 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    mesh = make_mesh(1, 1, n, devices=jax.devices()[:n])
    attn = make_ring_attn(mesh, zigzag=variant.startswith("zigzag"),
                          flash=variant.endswith("flash"))

    def jloss(q, k, v):
        return jnp.sum(attn(q, k, v) * g)

    j_out = np.asarray(jax.jit(attn)(q, k, v))
    j_grads = [np.asarray(x) for x in jax.jit(jax.grad(jloss, (0, 1, 2)))(q, k, v)]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = _ring_outputs(tq, tk, tv, n, variant)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=MATH_ATOL, rtol=0)
    for mine, theirs in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(mine.numpy(), theirs, atol=MATH_ATOL, rtol=0)

    dq, dk, dv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    dense = ring.reference_attention(dq, dk, dv)
    (dense * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(),
                               atol=MATH_ATOL, rtol=0)
    for mine, theirs in zip((tq.grad, tk.grad, tv.grad), (dq.grad, dk.grad, dv.grad)):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), atol=MATH_ATOL, rtol=0)


@pytest.mark.parametrize("tiles", [(64, 64), (256, 100)])
@pytest.mark.parametrize("variant", ("contiguous-flash", "zigzag-flash"))
def test_flash_ring_with_tiles_equals_without(variant, tiles):
    """Explicit block_q/block_k through the flash ring's local math give
    the same output and gradients as the chooser's (the plain versions on
    the CPU, f32, bit for bit)."""
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 2, 32, 4, 2, 16
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    g = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    results = []
    for kw in ({}, {"block_q": tiles[0], "block_k": tiles[1]}):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = _ring_outputs(*leaves, 2, variant, **kw)
        (out * g).sum().backward()
        results.append([out.detach(), *(t.grad for t in leaves)])
    for plain, tiled in zip(*results):
        assert torch.equal(plain, tiled)


@pytest.mark.parametrize("zigzag", (False, True))
def test_ring_flash_passes_tiles_to_every_kernel_call(monkeypatch, zigzag):
    """``ring_flash_local``/``zigzag_ring_flash_local`` (and
    ``make_ring_attn`` for the contiguous ring) hand block_q/block_k to
    every flash call, as the reference's ``_make_flash_partial``."""
    calls = []
    real_flash = ring._flash

    def recording_flash(q, k, v, causal, block_q=None, block_k=None):
        calls.append((block_q, block_k))
        return real_flash(q, k, v, causal, block_q, block_k)

    n, d = 2, 1
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 16, 4, 8), (1, 16, 2, 8), (1, 16, 2, 8)))
    monkeypatch.setattr(ring, "_flash", recording_flash)
    monkeypatch.setattr(ring, "ring_hops", lambda k, v, mesh, hops: [(k, v)] * (hops + 1))
    mesh = type("Mesh", (), {"sp": n, "coords": {ring.AXIS: d}})()
    if zigzag:
        ring.zigzag_ring_flash_local(q, k, v, mesh, block_q=64, block_k=128)
        assert len(calls) == ring.flash_calls_per_layer(n, True, d)
    else:
        ring.make_ring_attn(mesh, flash=True, block_q=64, block_k=128)(q, k, v)
        assert len(calls) == ring.flash_calls_per_layer(n, False, d)
    assert set(calls) == {(64, 128)}


def test_merge_partials_and_its_gradient_match_reference():
    jax = pytest.importorskip("jax")
    from tpumon.workload.parallel.ring import _merge_partials

    rng = np.random.default_rng(7)
    B, s, H, D = 2, 8, 4, 16
    o_a, o_b = (rng.standard_normal((B, s, H, D)).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((B, H, s)).astype(np.float32) for _ in range(2))
    g_o = rng.standard_normal((B, s, H, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, H, s)).astype(np.float32)

    (j_o, j_lse), vjp = jax.vjp(_merge_partials, o_a, lse_a, o_b, lse_b)
    j_grads = vjp((g_o, g_lse))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (o_a, lse_a, o_b, lse_b)]
    t_o, t_lse = ring._merge_partials(*leaves)
    ((t_o * torch.from_numpy(g_o)).sum() + (t_lse * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(t_o.detach().numpy(), np.asarray(j_o), atol=MERGE_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.detach().numpy(), np.asarray(j_lse), atol=MERGE_ATOL, rtol=0)
    for leaf, theirs in zip(leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(theirs), atol=MERGE_ATOL, rtol=0)


@pytest.mark.parametrize("dp,tp,sp,want", [
    (2, 1, 2, [[0, 1, 2, 3]]),
    (2, 2, 2, [[0, 2, 4, 6], [1, 3, 5, 7]]),
    (1, 2, 4, [[0, 2, 4, 6], [1, 3, 5, 7]]),
])
def test_data_seq_groups(dp, tp, sp, want):
    """The gradient bucket's groups: the ranks that share a model
    coordinate, data-major, each the union of its data and seq groups."""
    from tpumon.workload_torch.parallel import mesh as mesh_mod

    grid = mesh_mod.layout(dp, tp, sp)
    groups = mesh_mod.data_seq_groups(grid)
    assert groups == want
    for group in groups:
        for axis in ("data", "seq"):
            for ranks in mesh_mod.axis_groups(grid, axis):
                assert set(ranks) <= set(group) or not set(ranks) & set(group)


def test_zigzag_refuses_non_causal():
    with pytest.raises(ValueError, match="zigzag layout only pays off"):
        ring.make_ring_attn(None, zigzag=True, causal=False)


def test_main_runs_the_ring_on_cpu(caplog):
    """The CLI at tp=2×sp=2 zigzag flash on the host: four ranks with
    equal losses, each issuing the formula's collectives, and rank 0's
    page carrying sp=2 and the permutes."""
    import threading
    import urllib.request

    from tpumon.lifecycle.probe import step_snapshot_from_text

    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    port = launch.free_port()
    argv = ["--platform", "cpu", "--tp", "2", "--sp", "2", "--sp-layout", "zigzag",
            "--attn", "flash", "--steps", "2", "--stats-every", "1", "--batch",
            "2", "--seq", "32", "--grad-norm", "--phase-stats", "--metrics-port",
            str(port)]
    pages, done = [], threading.Event()

    def scrape():
        while not done.is_set():
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                            timeout=2) as resp:
                    text = resp.read().decode()
                if "collective-permute" in text:
                    pages.append(text)
            except OSError:
                pass
            done.wait(0.1)

    thread = threading.Thread(target=scrape, daemon=True)
    thread.start()
    t0 = time.monotonic()
    try:
        assert harness.main(argv) == 0
    finally:
        done.set()
        thread.join(timeout=10)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S
    reports = {r.args[0]: r.args[1] for r in caplog.records
               if str(r.msg).startswith("rank %d report")}
    assert sorted(reports) == [0, 1, 2, 3]
    import json

    reports = {rank: json.loads(text) for rank, text in reports.items()}
    shape = dict(n_layers=2, dp=1, tp=2, remat=False, loss_chunk=0, seq=32,
                 zero1=False, sp=2, sp_layout="zigzag", attn="flash")
    for rank, rep in reports.items():
        assert rep["losses"] == reports[0]["losses"]
        coord = rep["coords"]["seq"]
        step = expected_per_step(grad_accum=1, grad_norm=True, seq_coord=coord, **shape)
        probe = expected_per_probe(seq_coord=coord, **shape)
        want = {op: 3 * step[op] + 2 * probe[op] for op in step}
        assert rep["collectives"]["counts"] == {op: n for op, n in want.items() if n}
    assert pages, "never scraped rank 0's page with the permutes"
    snap = step_snapshot_from_text(pages[-1])
    assert snap["axes"] == {"dp": 1, "tp": 2, "sp": 2, "pp": 1, "ep": 1}
    assert 0.0 <= snap["collective_wait_fraction"] <= 1.0
    assert 'workload_collective_ops_total{op="collective-permute"}' in pages[-1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("zigzag-flash", "contiguous-flash"))
def test_ring_flash_math_on_card(variant):
    """The flash ring's local math at the zigzag stripes of the card's
    ring phase (B=2, 1024-row stripes, H=8, KV=2, D=128; sp=2, so S=4096
    in all) through the kernels, with the lse cotangent folded into Δ,
    against dense f32 attention on the card: O within 2e-2, the
    gradients within 1e-2 relative L2 (chip_smoke.py's LIMITS)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, g = randn(2, 4096, 8, 128), randn(2, 4096, 2, 128), randn(2, 4096, 2, 128), randn(2, 4096, 8, 128)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = _ring_outputs(*leaves, 2, variant)
    (out.float() * g.float()).sum().backward()
    dense_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dense = ring.reference_attention(*dense_leaves)
    (dense.float() * g.float()).sum().backward()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    assert (out.float() - dense.float()).abs().max().item() <= 2e-2
    for mine, theirs in zip(leaves, dense_leaves):
        assert rel(mine.grad, theirs.grad) <= 1e-2


@pytest.mark.cuda
def test_permute_stages_cuda_tensors_over_gloo(tmp_path):
    """Two ranks on one card over gloo swap a bf16 CUDA tensor through
    ``permute``: it arrives intact, on the card, counted once."""
    _card()
    ranks = launch.spawn(checks.permute_on_card, 2, str(tmp_path / "rendezvous"),
                         timeout_s=SPAWN_TIMEOUT_S)
    for rank in ranks:
        assert rank["max_abs"] == 0.0
        assert rank["device"] == "cuda:0" and rank["dtype"] == "torch.bfloat16"
        assert rank["counts"] == {"collective-permute": 1}
