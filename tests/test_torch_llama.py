"""Port parity: the torch Llama against tpumon/workload/models/llama.py.

Weights come from the reference's own init (JAX pytree → numpy →
``from_jax_params``), tokens from numpy with a fixed seed. Logit
tolerances: f32 atol 1e-4 (summation order only), bf16 atol 5e-2 (the two
frameworks round bf16 activations at different places; the reference's
own flash-vs-XLA test uses the same bound).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tpumon.workload.models import llama as jllama  # noqa: E402
from tpumon.workload_torch.models import llama as tllama  # noqa: E402
from tpumon.workload_torch.ops.flash_attention import make_flash_attn  # noqa: E402

PRESETS = ("tiny", "small", "medium", "llama3_8b")


def _jax_tree(cfg, seed=0):
    return jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed)))


def _tokens(batch, seq, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq), dtype=np.int32)


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_reference_field_by_field(preset):
    ref = getattr(jllama.LlamaConfig, preset)()
    port = getattr(tllama.LlamaConfig, preset)()
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    assert ref_fields == {f.name for f in dataclasses.fields(port)}
    for name in sorted(ref_fields - {"dtype"}):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert port.head_dim == ref.head_dim


def test_param_names_and_shapes_match_reference():
    cfg = tllama.LlamaConfig.tiny()
    tree = _jax_tree(jllama.LlamaConfig.tiny())
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    assert tuple(model.embed.shape) == tree["embed"].shape
    assert tuple(model.final_norm.shape) == tree["final_norm"].shape
    assert tuple(model.unembed.shape) == tree["unembed"].shape
    assert set(tree["layers"]) == set(tllama.LAYER_PARAMS)
    assert len(model.blocks) == cfg.n_layers
    for name in tllama.LAYER_PARAMS:
        for block in model.blocks:
            assert tuple(getattr(block, name).shape) == tree["layers"][name].shape[1:]
    for _, p in model.named_parameters():
        assert p.dtype == torch.float32


def test_init_params_matches_reference_distribution():
    """normal(0.02) weights and ones for the norms (numbers differ from
    jax.random's; the distribution is what is ported)."""
    model = tllama.init_params(
        tllama.LlamaConfig.tiny(), torch.Generator().manual_seed(0)
    )
    for name, p in model.named_parameters():
        if name.endswith("norm"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert abs(p.std().item() - 0.02) < 0.002, name
            assert abs(p.mean().item()) < 0.002, name


@pytest.mark.parametrize(
    "jdtype,tdtype,atol",
    [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 5e-2)],
)
def test_logits_match_reference(jdtype, tdtype, atol):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jdtype)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=tdtype)
    tree = _jax_tree(jcfg)
    tokens = _tokens(2, 32, jcfg.vocab)
    ref = np.asarray(jllama.forward(tree, jnp.asarray(tokens), jcfg))
    model = tllama.from_jax_params(tcfg, tree)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


def test_hidden_states_match_reference():
    """``unembed=False`` returns the final-norm hidden states (the chunked
    loss's input), f32 atol 1e-4."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    tree = _jax_tree(jcfg, seed=3)
    tokens = _tokens(1, 16, jcfg.vocab, seed=4)
    ref = np.asarray(jllama.forward(tree, jnp.asarray(tokens), jcfg, unembed=False))
    with torch.no_grad():
        out = tllama.from_jax_params(tcfg, tree)(
            torch.from_numpy(tokens).long(), unembed=False
        )
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_from_jax_params_rejects_wrong_shapes():
    cfg = tllama.LlamaConfig.tiny()
    tree = _jax_tree(jllama.LlamaConfig.tiny())
    tree["unembed"] = tree["unembed"].T
    with pytest.raises(ValueError, match="unembed"):
        tllama.from_jax_params(cfg, tree)


def test_causality():
    """Changing a future token must not change past logits."""
    model = tllama.init_params(
        tllama.LlamaConfig.tiny(), torch.Generator().manual_seed(0)
    )
    t1 = torch.zeros((1, 16), dtype=torch.long)
    t2 = t1.clone()
    t2[0, 10] = 5
    with torch.no_grad():
        l1, l2 = model(t1), model(t2)
    assert torch.allclose(l1[0, :10], l2[0, :10], atol=1e-3)
    assert not torch.allclose(l1[0, 10:], l2[0, 10:], atol=1e-3)


@pytest.mark.parametrize("remat", [False, True])
def test_flash_forward_matches_xla(remat):
    """``attn_impl=make_flash_attn()`` against the plain einsum path, bf16
    atol 5e-2 (the reference's own bound for the same comparison)."""
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.from_jax_params(cfg, _jax_tree(jllama.LlamaConfig.tiny()))
    tokens = torch.from_numpy(_tokens(2, 32, cfg.vocab)).long()
    with torch.no_grad():
        ref = model(tokens)
        out = model(tokens, attn_impl=make_flash_attn(), remat=remat)
    assert torch.allclose(out, ref, atol=5e-2), (out - ref).abs().max()
