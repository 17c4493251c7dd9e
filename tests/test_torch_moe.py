"""Port parity: the torch MoE against tpumon/workload/models/moe.py.

Weights come from the reference's own init (JAX pytree → numpy →
``from_jax_params``), tokens and router probabilities from numpy with a
fixed seed. Tolerances: logits and aux f32 atol 1e-4 (summation order
only) and bf16 atol 5e-2 (the frameworks round bf16 activations at other
places); routing exactly, on the same f32 probabilities; the train loss
trajectory at atol 5e-3 and the grad norm at relative 0.02 (the dense
parity test's bounds), bf16 on both sides.

Ties: ``torch.argmax`` and ``jnp.argmax`` both take the first maximum, and
``torch.amax`` splits its gradient between tied maxima as ``jnp.max``
does. A bf16 argmax tie could still flip a route between the two sides,
which is why the model is held in f32 first; with random f32 inputs no
tie occurs.
"""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import flops as tflops  # noqa: E402
from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.models import moe as tmoe  # noqa: E402
from tpumon.workload_torch.ops import flash_attention as fa  # noqa: E402
from tpumon.workload_torch.ops.flash_attention import make_flash_attn  # noqa: E402

LOSS_TOL = 5e-3
GRAD_RTOL = 0.02


def _jmoe():
    pytest.importorskip("jax")
    from tpumon.workload.models import moe

    return moe


def _jax_tree(cfg, seed=0):
    import jax

    return jax.tree.map(np.asarray, _jmoe().init_params(cfg, jax.random.PRNGKey(seed)))


def _tokens(batch, seq, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq), dtype=np.int32)


def _probs(B, S, E, seed=2):
    logits = np.random.default_rng(seed).standard_normal((B, S, E)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_presets_match_reference_field_by_field(preset):
    import jax.numpy as jnp

    ref = getattr(_jmoe().MoeConfig, preset)()
    port = getattr(tmoe.MoeConfig, preset)()
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    assert ref_fields == {f.name for f in dataclasses.fields(port)}
    for name in sorted(ref_fields - {"dtype"}):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert port.head_dim == ref.head_dim
    for seq in (32, 4096, 4097):
        assert port.capacity(seq) == ref.capacity(seq)


def test_param_names_and_shapes_match_reference():
    cfg = tmoe.MoeConfig.tiny()
    tree = _jax_tree(_jmoe().MoeConfig.tiny())
    model = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    for name in ("embed", "final_norm", "unembed"):
        assert tuple(getattr(model, name).shape) == tree[name].shape, name
    assert set(tree["layers"]) == set(tmoe.LAYER_PARAMS)
    assert len(model.blocks) == cfg.n_layers
    for name in tmoe.LAYER_PARAMS:
        for block in model.blocks:
            assert tuple(getattr(block, name).shape) == tree["layers"][name].shape[1:]
    for _, p in model.named_parameters():
        assert p.dtype == torch.float32


def test_init_params_matches_reference_distribution():
    """normal(0.02) weights and ones for the norms (the numbers differ
    from jax.random's; the distribution is what is ported)."""
    model = tmoe.init_params(tmoe.MoeConfig.tiny(), torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith("norm"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert abs(p.std().item() - 0.02) < 0.002, name
            assert abs(p.mean().item()) < 0.002, name


@pytest.mark.parametrize("capacity", [32, 5], ids=["fits", "overflows"])
def test_route_matches_reference_exactly(capacity):
    """Dispatch and combine equal the reference's bit for bit on the same
    f32 probabilities, also when tokens overflow an expert's capacity."""
    import jax.numpy as jnp

    B, S, E, top_k = 2, 32, 4, 2
    probs = _probs(B, S, E)
    ref_d, ref_c = (np.asarray(a) for a in
                    _jmoe()._route(jnp.asarray(probs), top_k, capacity))
    d, c = tmoe._route(torch.from_numpy(probs), top_k, capacity)
    np.testing.assert_array_equal(d.numpy(), ref_d)
    np.testing.assert_array_equal(c.numpy(), ref_c)
    placed = d.sum().item()
    if capacity == 5:
        assert placed < B * S * top_k  # some tokens were dropped
    else:
        assert placed == B * S * top_k


def test_expert_ffn_matches_reference():
    """f32 atol 1e-5: dispatch → SwiGLU bank → combine."""
    import jax.numpy as jnp

    jcfg = dataclasses.replace(_jmoe().MoeConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tmoe.MoeConfig.tiny(), dtype=torch.float32)
    tree = _jax_tree(jcfg, seed=3)
    layer = {k: v[0] for k, v in tree["layers"].items()}
    x = np.random.default_rng(4).standard_normal((2, 32, jcfg.dim)).astype(np.float32)
    dispatch, combine = _jmoe()._route(jnp.asarray(_probs(2, 32, jcfg.n_experts)),
                                       jcfg.top_k, jcfg.capacity(32))
    ref = _jmoe().expert_ffn(jnp.asarray(x), dispatch, combine, layer, jcfg)
    t = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    out = tmoe.expert_ffn(
        torch.from_numpy(x), torch.from_numpy(np.array(dispatch)),
        torch.from_numpy(np.array(combine)), t["w_gate"], t["w_up"],
        t["w_down"], tcfg,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_logits_and_aux_match_reference(dtype, atol):
    import jax.numpy as jnp

    jcfg = dataclasses.replace(_jmoe().MoeConfig.tiny(), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tmoe.MoeConfig.tiny(), dtype=getattr(torch, dtype))
    tree = _jax_tree(jcfg)
    tokens = _tokens(2, 32, jcfg.vocab)
    ref_logits, ref_aux = _jmoe().forward(tree, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        logits, aux = tmoe.from_jax_params(tcfg, tree)(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and logits.shape == ref_logits.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=0, atol=atol)
    assert abs(aux.item() - float(ref_aux)) <= atol


def test_from_jax_params_rejects_wrong_shapes():
    tree = _jax_tree(_jmoe().MoeConfig.tiny())
    tree["layers"]["router"] = tree["layers"]["router"].transpose(0, 2, 1)
    with pytest.raises(ValueError, match="router"):
        tmoe.from_jax_params(tmoe.MoeConfig.tiny(), tree)


@pytest.mark.parametrize("remat", [False, True])
def test_flash_forward_matches_xla(remat):
    """``attn_impl=make_flash_attn()`` against the plain attention path in
    f32, atol 1e-4 on the logits and the aux loss. (In bf16 one token of
    this input changes its route: the two attention paths round at other
    places and the router's top two are within that rounding.)"""
    cfg = dataclasses.replace(tmoe.MoeConfig.tiny(), dtype=torch.float32)
    model = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(2, 32, cfg.vocab)).long()
    with torch.no_grad():
        ref, ref_aux = model(tokens)
        out, aux = model(tokens, attn_impl=make_flash_attn(), remat=remat)
    assert torch.allclose(out, ref, atol=1e-4), (out - ref).abs().max()
    assert abs(aux.item() - ref_aux.item()) <= 1e-4


def test_remat_matches_plain():
    """remat recomputes each layer's body (routing included) in the
    backward without changing it: the loss trajectories agree to 1e-5,
    the reference's bound (tests/test_workload.py)."""
    cfg = tmoe.MoeConfig.tiny()
    kw = dict(steps=3, batch=2, seq=32, seed=5, device="cpu")
    plain = harness.run(cfg, **kw)
    remat = harness.run(cfg, remat=True, **kw)
    for a, b in zip(plain.losses, remat.losses):
        assert abs(a - b) < 1e-5, (plain.losses, remat.losses)


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_flops_match_reference(preset):
    from tpumon.workload import flops as jflops

    ref_cfg = getattr(_jmoe().MoeConfig, preset)()
    port_cfg = getattr(tmoe.MoeConfig, preset)()
    for batch, seq in ((2, 32), (8, 4096)):
        assert tflops.train_flops_per_step(port_cfg, batch, seq) == \
            jflops.train_flops_per_step(ref_cfg, batch, seq)
    if preset == "small":
        gflop = tflops.train_flops_per_step(port_cfg, 8, 4096) / 1e9
        assert round(gflop, 1) == 15468.3


class _LossLog:
    """Duck-typed stats sink for run(): one loss per window."""

    def __init__(self) -> None:
        self.losses: list[float] = []

    def configure(self, **_kw) -> None:
        pass

    def record(self, loss, _steps, _seconds) -> None:
        self.losses.append(loss)


RUN = dict(steps=2, batch=4, seq=64, grad_accum=2, remat=True,
           with_grad_norm=True, stats_every=1)


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_trajectory_and_grad_norm_match_reference(attn):
    """The port's run() and the reference's on the reference's seeded
    weights and tokens; the reference's flash runs its Pallas kernels in
    interpret mode."""
    jax = pytest.importorskip("jax")
    from tpumon.workload.harness import run as jax_run

    jcfg = _jmoe().MoeConfig.tiny()
    k_params, k_data = jax.random.split(jax.random.PRNGKey(0))  # as run() does
    params = jax.tree.map(np.asarray, _jmoe().init_params(jcfg, k_params))
    tokens = np.asarray(jax.random.randint(
        k_data, (RUN["batch"], RUN["seq"] + 1), 0, jcfg.vocab, jax.numpy.int32))

    ref_log, port_log = _LossLog(), _LossLog()
    ref = jax_run(jcfg, attn=attn, stats=ref_log, **RUN)
    port = harness.run(tmoe.MoeConfig.tiny(), attn=attn, stats=port_log,
                       device="cpu", params=params, tokens=tokens, **RUN)
    ref_traj = [ref.losses[0], *ref_log.losses]
    port_traj = [port.losses[0], *port_log.losses]
    assert len(port_traj) == 3
    np.testing.assert_allclose(port_traj, ref_traj, rtol=0, atol=LOSS_TOL)
    assert abs(port.grad_norm - ref.grad_norm) <= GRAD_RTOL * ref.grad_norm
    assert port_traj[-1] < port_traj[0]
    assert port.model_flops_per_step == ref.model_flops_per_step


def test_moe_rejects_loss_chunk():
    with pytest.raises(ValueError, match="dense"):
        harness.run(tmoe.MoeConfig.tiny(), steps=1, batch=2, seq=32,
                    loss_chunk=16, device="cpu")


def test_cli_moe_presets_and_capacity_factor(caplog, capsys):
    """--model moe runs on the host; a dense-only preset falls back to
    tiny with a warning, as in the reference; --capacity-factor needs
    --model moe."""
    caplog.set_level(logging.INFO, logger="tpumon.workload_torch.harness")
    argv = ["--model", "moe", "--platform", "cpu", "--steps", "2", "--batch",
            "2", "--seq", "32", "--attn", "flash", "--capacity-factor", "1.0"]
    assert harness.main([*argv, "--preset", "medium"]) == 0
    assert any("ignoring --preset medium" in r.getMessage() for r in caplog.records)
    assert any(r.msg.startswith("loss ") for r in caplog.records)
    with pytest.raises(SystemExit) as exc:
        harness.main(["--capacity-factor", "1.0", "--platform", "cpu"])
    assert exc.value.code == 2
    assert "requires --model moe" in capsys.readouterr().err


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,flash,atol",
    [(torch.float32, False, 1e-4), (torch.bfloat16, True, 5e-2)],
    ids=["f32-plain", "bf16-flash"],
)
def test_forward_on_card_matches_cpu(dtype, flash, atol):
    """The MoE forward on the card against the same forward on the host
    (head_dim 64, so the flash kernels take it): f32 with the plain
    attention at atol 1e-4 (full-f32 products, no TF32), bf16 through the
    kernels at atol 5e-2 on the logits and the aux loss."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tmoe.MoeConfig.tiny(), dim=256, dtype=dtype)
    model = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(2, 128, cfg.vocab)).long()
    impl = make_flash_attn() if flash else None
    with torch.no_grad():
        ref, ref_aux = model(tokens, impl)
        fa.reset_launches()
        out, aux = model.to(dev)(tokens.to(dev), impl)
    assert fa.launches["flash_fwd"] == (cfg.n_layers if flash else 0)
    assert torch.isfinite(out).all()
    assert (out.cpu() - ref).abs().max().item() <= atol
    assert abs(aux.item() - ref_aux.item()) <= atol
