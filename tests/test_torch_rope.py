"""RoPE's kernel (``ops/core.py`` ``rope_qk``, ``ops/csrc/rope.cu``).

On the CPU: the closed-form backward the kernel computes (the rotation by
−sin) against torch autograd through the plain chain ``apply_rope``, bit
for bit; a CPU path that stays the plain chain and launches nothing; the
input check the card path applies before any launch; and the table rows
a rank of a sequence split reads.

On the card (marked ``cuda``, skipped without one; this file imports no
JAX): the kernel's forward and backward against the eager chain at the
benchmark cells' shapes, bit for bit, DeepSeek-V2's strided ``q_pe`` and
``k_pe`` views and their strided gradients among them; bit-identical
reruns; and remat train steps of each family whose launch counts follow
from the model. The JAX package's rotation is compared in
``tests/test_torch_ops.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.models import deepseek_v2, llama, moe  # noqa: E402
from tpumon.workload_torch.ops import core  # noqa: E402
from tpumon.workload_torch.ops.flash_attention import make_flash_attn  # noqa: E402

NO_LAUNCHES = {"rms_norm_fwd": 0, "rms_norm_bwd": 0, "rope_fwd": 0, "rope_bwd": 0}


def _normal(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _table(D, rows, start=0):
    """Angles of positions start.. start + rows (large ones, so cos and sin
    take every sign)."""
    return core.rope_freqs(D, start + rows)[start:]


def _autograd_rope(x, freqs, dy):
    """(y, dx) of ``apply_rope`` under torch autograd."""
    x = x.clone().requires_grad_()
    y = core.apply_rope(x, freqs)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("heads", [1, 8, 32])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_closed_form_backward_is_autograd_through_the_chain_bit_for_bit(dtype, D, heads):
    """The backward the kernel computes, the forward by −sin, is autograd's
    gradient through the plain chain to the last bit: negation is exact
    and a two-term sum commutes."""
    S = 7
    x = _normal((2, S, heads, D), seed=D + heads, dtype=dtype)
    dy = _normal((2, S, heads, D), seed=D * heads + 1, dtype=dtype)
    freqs = _table(D, S, start=900)
    y, want_dx = _autograd_rope(x, freqs, dy)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    assert torch.equal(core.rope_rotate(x, cos, sin), y)
    dx = core.rope_rotate(dy, cos, -sin)
    assert dx.dtype == dtype
    assert torch.equal(dx, want_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rope_qk_on_the_cpu_is_apply_rope_on_each_and_launches_nothing(dtype):
    B, S, D = 2, 6, 32
    q = _normal((B, S, 4, D), seed=1, dtype=dtype)
    k = _normal((B, S, 2, D), seed=2, dtype=dtype)
    dq = _normal((B, S, 4, D), seed=3, dtype=dtype)
    dk = _normal((B, S, 2, D), seed=4, dtype=dtype)
    freqs = _table(D, 3 * S)  # more rows than positions: rows :S serve
    core.reset_launches()
    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    q_rot, k_rot = core.rope_qk(qa, ka, freqs)
    torch.autograd.backward((q_rot, k_rot), (dq, dk))
    want_q, want_dq = _autograd_rope(q, freqs[:S], dq)
    want_k, want_dk = _autograd_rope(k, freqs[:S], dk)
    assert torch.equal(q_rot.detach(), want_q) and torch.equal(k_rot.detach(), want_k)
    assert torch.equal(qa.grad, want_dq) and torch.equal(ka.grad, want_dk)
    assert core.launches == NO_LAUNCHES


def _sp_model(D, S, coord):
    """What ``llama.rank_freqs`` reads of a model: its head width and
    longest sequence, and a mesh that splits the sequence in two."""
    cfg = SimpleNamespace(head_dim=D, max_seq=2 * S)
    return SimpleNamespace(cfg=cfg, mesh=SimpleNamespace(sp=2, coords={"seq": coord}))


@pytest.mark.parametrize("coord", [0, 1])
def test_a_table_sliced_at_an_sp_offset_gives_the_rows_of_those_positions(coord):
    """Under sp a rank holds positions coord·S .. coord·S + S − 1 of the
    sequence, in either ring layout, and ``rank_freqs`` hands RoPE those
    rows: its rotation equals the whole sequence's on the same positions."""
    B, S, D = 2, 8, 16
    q = _normal((B, 2 * S, 4, D), seed=5, dtype=torch.bfloat16)
    k = _normal((B, 2 * S, 1, D), seed=6, dtype=torch.bfloat16)
    table = llama.rank_freqs(_sp_model(D, S, coord), S, "cpu")
    assert torch.equal(table, core.rope_freqs(D, 2 * S)[coord * S:(coord + 1) * S])
    whole = core.rope_qk(q, k, core.rope_freqs(D, 2 * S))
    at = slice(coord * S, (coord + 1) * S)
    part = core.rope_qk(q[:, at], k[:, at], table)
    for got, want in zip(part, whole):
        assert torch.equal(got, want[:, at])


@pytest.mark.parametrize("D", range(16, 257, 16))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_check_takes_every_multiple_of_16_up_to_256(D, dtype):
    core.check_rope_inputs(torch.zeros(2, 5, 4, D, dtype=dtype),
                           torch.zeros(2, 5, 1, D, dtype=dtype), torch.zeros(5, D // 2))


@pytest.mark.parametrize("D", [0, 8, 24, 40, 100, 264, 272, 512])
def test_check_refuses_widths_the_kernel_does_not_take(D):
    msg = (f"head width {D} not compiled \\(takes multiples of 16 from 16 to 256: "
           "16, 32, 64 and 128 among them\\)")
    with pytest.raises(ValueError, match=msg):
        core.check_rope_inputs(torch.zeros(2, 5, 4, D, dtype=torch.bfloat16),
                               torch.zeros(2, 5, 1, D, dtype=torch.bfloat16),
                               torch.zeros(5, D // 2))


@pytest.mark.parametrize("q_dtype,k_dtype", [
    (torch.float16, torch.float16), (torch.float64, torch.float64),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_check_refuses_other_dtypes_of_q_and_k(q_dtype, k_dtype):
    with pytest.raises(TypeError, match="q and k must both be bfloat16 or float32"):
        core.check_rope_inputs(torch.zeros(1, 4, 2, 32, dtype=q_dtype),
                               torch.zeros(1, 4, 1, 32, dtype=k_dtype), torch.zeros(4, 16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_check_refuses_a_table_that_is_not_f32(dtype):
    with pytest.raises(TypeError, match="the table must be float32"):
        core.check_rope_inputs(torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32),
                               torch.zeros(4, 16, dtype=dtype))


@pytest.mark.parametrize("shape", [(4, 32), (4, 8), (3, 16), (16,), (1, 4, 16)],
                         ids=["width D", "narrower", "too few rows", "flat", "3-d"])
def test_check_refuses_a_table_of_another_width_or_too_few_rows(shape):
    with pytest.raises(ValueError, match=r"the table must be \[>= 4, 16\]"):
        core.check_rope_inputs(torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32),
                               torch.zeros(shape))


@pytest.mark.parametrize("k_shape", [(2, 4, 1, 32), (1, 5, 1, 32), (1, 4, 1, 64), (1, 4, 32)],
                         ids=["batch", "seq", "width", "3-d"])
def test_check_refuses_q_and_k_of_other_batches_positions_or_widths(k_shape):
    with pytest.raises(ValueError, match="q and k must be \\[B, S, heads, D\\] of one"):
        core.check_rope_inputs(torch.zeros(1, 4, 2, 32), torch.zeros(k_shape),
                               torch.zeros(4, 16))


def test_kernel_wrappers_refuse_cpu_tensors_before_any_launch():
    q, k = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    cos, sin = torch.ones(4, 16), torch.zeros(4, 16)
    core.reset_launches()
    for wrapper in (core.rope_fwd, core.rope_bwd):
        with pytest.raises(ValueError, match="q must be on q's CUDA device, got cpu"):
            wrapper(q, k, cos, sin)
    assert core.launches == NO_LAUNCHES


@pytest.mark.parametrize("where", ["freqs", "k"])
def test_mixed_devices_are_refused_before_any_launch(where):
    tensors = {"q": torch.zeros(1, 4, 2, 32), "k": torch.zeros(1, 4, 1, 32),
               "freqs": torch.zeros(4, 16)}
    tensors[where] = tensors[where].to("meta")
    core.reset_launches()
    with pytest.raises(ValueError, match="q must be on q's CUDA device, got cpu"):
        core.rope_qk(tensors["q"], tensors["k"], tensors["freqs"])
    assert core.launches == NO_LAUNCHES


def test_the_wrappers_refuse_a_sin_unlike_cos():
    q, k = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match=r"sin must match cos \(torch.float32 \(4, 16\)\)"):
        core.rope_fwd(q, k, torch.ones(4, 16), torch.zeros(3, 16))


def test_strided_views_are_read_in_place_and_other_layouts_copied():
    """DeepSeek-V2's rope columns (a split of each head's q, a split of the
    latent product's columns) are rows the kernel reads in place; a
    transposed last dimension or a row off a 16-byte word is copied."""
    q = torch.zeros(2, 5, 4, 48, dtype=torch.bfloat16)
    q_pe = q.split([32, 16], dim=-1)[1]
    kv = torch.zeros(2, 5, 40, dtype=torch.bfloat16)
    k_pe = kv.split([24, 16], dim=-1)[1].reshape(2, 5, 1, 16)
    for view in (q_pe, k_pe):
        assert not view.is_contiguous()
        assert core._rows(view) is view
    odd = torch.zeros(2, 5, 4, 20, dtype=torch.bfloat16)[..., 4:]  # rows 40 bytes apart
    turned = torch.zeros(2, 5, 16, 4).transpose(2, 3)
    shifted = torch.zeros(2 * 5 * 4 * 16 + 1)[1:].view(2, 5, 4, 16)
    for view in (odd, turned, shifted):
        copy = core._rows(view)
        assert copy is not view and copy.is_contiguous() and torch.equal(copy, view)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _card_normal(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


#: name -> (B, S, q heads, k heads, D, dtype): the dense cells' micro-batch
#: at s4096 and s1024, Mixtral's, DeepSeek-V2-Lite's (strided views, see
#: _card_inputs), the tiny presets' widths, the widest head, a ragged
#: token count and f32 inputs.
CARD_CASES = {
    "mistral-s4096": (16, 4096, 32, 8, 128, torch.bfloat16),
    "mistral-s1024": (64, 1024, 32, 8, 128, torch.bfloat16),
    "mixtral": (4, 4096, 32, 8, 128, torch.bfloat16),
    "deepseek": (16, 4096, 16, 1, 64, torch.bfloat16),
    "tiny": (2, 64, 4, 2, 32, torch.bfloat16),
    "d16": (3, 33, 4, 1, 16, torch.bfloat16),
    "d256": (2, 77, 3, 1, 256, torch.bfloat16),
    "f32": (2, 1000, 8, 2, 128, torch.float32),
}


def _card_inputs(name, seed=0):
    """(q, k, dq, dk, freqs, leaves): at "deepseek" q and k are the rope
    columns of a [B, S, H, 192] q and of a [B, S, 576] product, and dq is
    a view of a [B, S, H, 192] gradient, as they reach the kernel in the
    model; ``leaves`` are the tensors to take gradients of."""
    dev = _card()
    B, S, H, KV, D, dtype = CARD_CASES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if name == "deepseek":
        qf = _card_normal((B, S, H, 192), gen, dtype).requires_grad_()
        kf = _card_normal((B, S, 576), gen, dtype).requires_grad_()
        q, k = qf[..., 128:], kf[..., 512:].reshape(B, S, 1, D)
        dq = _card_normal((B, S, H, 192), gen, dtype)[..., 128:]
        leaves = (qf, kf)
        freqs = core.yarn_freqs(D, S, 10000.0, 40.0, device=dev)
    else:
        q = _card_normal((B, S, H, D), gen, dtype).requires_grad_()
        k = _card_normal((B, S, KV, D), gen, dtype).requires_grad_()
        dq = _card_normal((B, S, H, D), gen, dtype)
        leaves = (q, k)
        freqs = core.rope_freqs(D, 2 * S, device=dev)
    dk = _card_normal(k.shape, gen, dtype)
    return q, k, dq, dk, freqs, leaves


def _eager(q, k, dq, dk, freqs, leaves):
    S = q.shape[1]
    outs = (core.apply_rope(q, freqs[:S]), core.apply_rope(k, freqs[:S]))
    grads = torch.autograd.grad(outs, leaves, (dq, dk))
    return [t.detach() for t in outs], grads


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_is_the_eager_chain_bit_for_bit_on_card(name):
    """Forward and backward, one launch each, equal the eager f32 chain
    and autograd through it on the card to the last bit; the strided
    views are read in place."""
    q, k, dq, dk, freqs, leaves = _card_inputs(name)
    if name == "deepseek":
        assert core._rows(q) is q and core._rows(k) is k and core._rows(dq) is dq
    core.reset_launches()
    outs = core.rope_qk(q, k, freqs)
    grads = torch.autograd.grad(outs, leaves, (dq, dk))
    torch.cuda.synchronize()
    assert core.launches == {**NO_LAUNCHES, "rope_fwd": 1, "rope_bwd": 1}
    want_outs, want_grads = _eager(q, k, dq, dk, freqs, leaves)
    for got, want in zip((*outs, *grads), (*want_outs, *want_grads)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_is_bit_identical_across_runs_on_card():
    q, k, dq, dk, freqs, _ = _card_inputs("mistral-s4096", seed=1)
    S = q.shape[1]
    cos, sin = torch.cos(freqs[:S]), torch.sin(freqs[:S])
    for wrapper, a, b in ((core.rope_fwd, q, k), (core.rope_bwd, dq, dk)):
        first, second = wrapper(a, b, cos, sin), wrapper(a, b, cos, sin)
        for x, y in zip(first, second):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_kernel_reads_the_table_rows_of_an_sp_offset_on_card():
    """Row i of the table serves position i of the tensor given: the rank's
    window of the table turns its tokens as the whole sequence's does."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    B, S, D = 2, 512, 128
    q = _card_normal((B, 2 * S, 32, D), gen, torch.bfloat16)
    k = _card_normal((B, 2 * S, 8, D), gen, torch.bfloat16)
    full = core.rope_freqs(D, 2 * S, device=dev)
    whole = core.rope_qk(q, k, full)
    for coord in (0, 1):
        at = slice(coord * S, (coord + 1) * S)
        table = llama.rank_freqs(_sp_model(D, S, coord), S, dev)
        for got, want in zip(core.rope_qk(q[:, at], k[:, at], table), whole):
            assert torch.equal(got, want[:, at])


@pytest.mark.cuda
def test_kernel_path_refuses_a_width_it_does_not_take_on_card():
    dev = _card()
    q = torch.zeros(1, 8, 2, 24, device=dev, dtype=torch.bfloat16)
    core.reset_launches()
    with pytest.raises(ValueError, match="head width 24 not compiled"):
        core.rope_qk(q, q, core.rope_freqs(24, 8, device=dev))
    assert core.launches == NO_LAUNCHES


FAMILIES = {
    "llama": (llama, llama.LlamaConfig.tiny, 32),
    "moe": (moe, moe.MoeConfig.tiny, 0),
    "deepseek_v2": (deepseek_v2, deepseek_v2.DeepseekV2Config.tiny, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_train_step_launches_one_rope_a_layer_pass_on_card(family):
    """One remat step of the tiny preset at grad_accum 2: each micro-batch
    turns q and k once a layer in the forward, once more in the recompute,
    and once a layer in the backward."""
    dev = _card()
    module, preset, loss_chunk = FAMILIES[family]
    gen = torch.Generator(device=dev).manual_seed(0)
    model = module.init_params(preset(), gen)
    opt = harness.build_optimizer(model.named_parameters(), model)
    micro = 2
    step = harness.make_train_step(model, opt, make_flash_attn(), grad_accum=micro,
                                   remat=True, loss_chunk=loss_chunk)
    tokens = torch.randint(0, model.cfg.vocab, (2 * micro, 65), device=dev,
                           generator=gen)
    core.reset_launches()
    loss, _ = step(tokens)
    torch.cuda.synchronize()
    L = model.cfg.n_layers
    assert (core.launches["rope_fwd"], core.launches["rope_bwd"]) == (micro * 2 * L,
                                                                      micro * L)
    assert torch.isfinite(loss).all()
