"""RMSNorm's kernel pair (``ops/core.py``, ``ops/csrc/rms_norm_*.cu``).

On the CPU: the closed-form backward the CUDA kernel computes
(``rms_norm_bwd_reference``) against torch autograd through the plain
forward, the input check the card path applies, and a CPU path that stays
the plain chain and launches nothing. Tolerances: f32 at 1e-6 of the
largest magnitude of each compared tensor (the two sides add a row's D
products in other orders); bf16 dx within one bf16 ulp of each element
(rtol 2⁻⁷), since both sides compute in f32 and round once.

On the card (marked ``cuda``, skipped without one; this file imports no
JAX): the kernels against the plain version at the cells' and the presets'
widths, bit-identical reruns, and remat train steps whose launch counts
follow from the model. The JAX package's gradient is compared in
``tests/test_torch_ops.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.models import llama, moe  # noqa: E402
from tpumon.workload_torch.ops import core  # noqa: E402
from tpumon.workload_torch.ops.flash_attention import make_flash_attn  # noqa: E402

WIDTHS = (128, 512, 4096)


def _inputs(rows, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*rows, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((*rows, D)).astype(np.float32))
    return x.to(dtype), w, dy.to(dtype)


def _autograd(x, w, dy):
    """(y, dx, dw) of the plain forward under torch autograd."""
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    y, _ = core.rms_norm_reference(x, w)
    y.backward(dy)
    return y.detach(), x.grad, w.grad


def _close_f32(got, want):
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * max(scale, 1.0))


@pytest.mark.parametrize("D", WIDTHS)
def test_closed_form_backward_matches_autograd_f32(D):
    x, w, dy = _inputs((3, 7), D, torch.float32, seed=D)
    _, rstd = core.rms_norm_reference(x, w)
    dx, dw = core.rms_norm_bwd_reference(x, w, rstd, dy)
    _, want_dx, want_dw = _autograd(x, w, dy)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert dw.shape == (D,)
    _close_f32(dx, want_dx)
    _close_f32(dw, want_dw)


@pytest.mark.parametrize("D", WIDTHS)
def test_closed_form_backward_matches_autograd_bf16(D):
    x, w, dy = _inputs((3, 7), D, torch.bfloat16, seed=D)
    _, rstd = core.rms_norm_reference(x, w)
    dx, dw = core.rms_norm_bwd_reference(x, w, rstd, dy)
    _, want_dx, want_dw = _autograd(x, w, dy)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), want_dx.float().numpy(),
                               rtol=2 ** -7, atol=0)
    _close_f32(dw, want_dw)


def test_reference_rstd_is_the_plain_scale():
    x, w, _ = _inputs((2, 5), 64, torch.bfloat16, seed=3)
    y, rstd = core.rms_norm_reference(x, w)
    x32 = x.float()
    want = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-5)
    assert rstd.dtype == torch.float32 and rstd.shape == (2, 5, 1)
    assert torch.equal(rstd, want)
    assert torch.equal(y, (x32 * want * w).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_the_plain_chain_and_launches_nothing(dtype):
    x, w, dy = _inputs((2, 5), 128, dtype, seed=4)
    core.reset_launches()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = core.rms_norm(xa, wa)
    y.backward(dy)
    want_y, want_dx, want_dw = _autograd(x, w, dy)
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(xa.grad, want_dx) and torch.equal(wa.grad, want_dw)
    assert core.launches == {"rms_norm_fwd": 0, "rms_norm_bwd": 0,
                             "rope_fwd": 0, "rope_bwd": 0}


@pytest.mark.parametrize("D", [8, 104, 128, 512, 1000, 2048, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_takes_every_multiple_of_8_up_to_8192(D, dtype):
    core.check_kernel_inputs(torch.zeros(3, D, dtype=dtype), torch.ones(D))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_check_refuses_a_weight_that_is_not_f32(dtype):
    with pytest.raises(TypeError, match="rms_norm kernel: weight must be float32"):
        core.check_kernel_inputs(torch.zeros(3, 128, dtype=torch.bfloat16),
                                 torch.ones(128, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_check_refuses_other_input_dtypes(dtype):
    with pytest.raises(TypeError, match="x must be bfloat16 or float32"):
        core.check_kernel_inputs(torch.zeros(3, 128, dtype=dtype), torch.ones(128))


@pytest.mark.parametrize("D", [0, 4, 100, 4100, 8200, 16384])
def test_check_refuses_widths_no_layout_takes(D):
    msg = (f"row width {D} not compiled \\(takes multiples of 8 from 8 to "
           "8192: 128, 512, 2048 and 4096 among them\\)")
    with pytest.raises(ValueError, match=msg):
        core.check_kernel_inputs(torch.zeros(3, D, dtype=torch.bfloat16),
                                 torch.ones(D))


def test_check_refuses_a_weight_of_another_width():
    with pytest.raises(ValueError, match=r"weight must be \[128\], got \(64,\)"):
        core.check_kernel_inputs(torch.zeros(3, 128), torch.ones(64))


def test_kernel_wrappers_refuse_cpu_tensors_before_any_launch():
    x, w, dy = _inputs((4,), 128, torch.bfloat16)
    core.reset_launches()
    with pytest.raises(ValueError, match="x must be on x's CUDA device, got cpu"):
        core.rms_norm_fwd(x, w, 1e-5)
    rstd = torch.ones(4, 1)
    with pytest.raises(ValueError, match="must be on x's CUDA device"):
        core.rms_norm_bwd(x, w, rstd, dy)
    assert core.launches == {"rms_norm_fwd": 0, "rms_norm_bwd": 0,
                             "rope_fwd": 0, "rope_bwd": 0}


@pytest.mark.parametrize("rstd", [torch.ones(4), torch.ones(4, 1, dtype=torch.bfloat16),
                                  torch.ones(3, 1)], ids=["flat", "bf16", "rows"])
def test_backward_wrapper_refuses_a_wrong_rstd(rstd):
    x, w, dy = _inputs((4,), 128, torch.bfloat16)
    with pytest.raises(ValueError, match=r"rstd must be float32 \(4, 1\)"):
        core.rms_norm_bwd(x, w, rstd, dy)


def test_backward_wrapper_refuses_a_dy_unlike_x():
    x, w, dy = _inputs((4,), 128, torch.bfloat16)
    with pytest.raises(ValueError, match="dy must match x"):
        core.rms_norm_bwd(x, w, torch.ones(4, 1), dy.float())


def test_mixed_devices_are_refused():
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="x must be on x's CUDA device, got cpu"):
        core.rms_norm(x, torch.ones(128, device="meta"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_inputs(rows, D, dtype, seed=0):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return (randn(rows, D).to(dtype), 1.0 + 0.1 * randn(D),
            randn(rows, D).to(dtype))


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


#: (rows, D, dtype): the dense cells' and Mixtral's micro-batch
#: ([65536, 4096], [16384, 4096]), the medium, small and tiny presets'
#: widths, the widest layout, a ragged width, and f32 inputs.
CARD_CASES = [
    (65536, 4096, torch.bfloat16),
    (16384, 4096, torch.bfloat16),
    (16384, 2048, torch.bfloat16),
    (8192, 512, torch.bfloat16),
    (256, 128, torch.bfloat16),
    (1000, 8192, torch.bfloat16),
    (333, 104, torch.bfloat16),
    (2048, 4096, torch.float32),
    (77, 1000, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D,dtype", CARD_CASES)
def test_kernel_pair_matches_the_plain_version_on_card(rows, D, dtype):
    """y within one bf16 ulp of the plain chain's (f32 inputs: 1e-6
    relative, a few f32 ulps, since rstd's row sum adds in another order),
    dx within relative L2 2e-3 (bf16; 1e-5 f32) of autograd through it, dw
    within relative L2 1e-5, rstd within 1e-6; one launch of each
    kernel."""
    x, w, dy = _card_inputs(rows, D, dtype)
    core.reset_launches()
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = core.rms_norm(xk, wk)
    y.backward(dy)
    torch.cuda.synchronize()
    assert core.launches == {"rms_norm_fwd": 1, "rms_norm_bwd": 1,
                             "rope_fwd": 0, "rope_bwd": 0}
    want_y, want_dx, want_dw = _autograd(x, w, dy)
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert y.dtype == dtype and xk.grad.dtype == dtype
    assert ((y.float() - want_y.float()).abs()
            <= ulp * want_y.float().abs()).all()
    assert _rel_l2(xk.grad, want_dx) <= (2e-3 if dtype == torch.bfloat16 else 1e-5)
    assert wk.grad.dtype == torch.float32
    assert _rel_l2(wk.grad, want_dw) <= 1e-5
    _, rstd = core.rms_norm_fwd(x, w, 1e-5)
    _, want_rstd = core.rms_norm_reference(x, w)
    assert rstd.shape == (rows, 1)
    assert _rel_l2(rstd, want_rstd) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D", [(65536, 4096), (1000, 512)])
def test_kernel_pair_is_bit_identical_across_runs_on_card(rows, D):
    """dw's partials add in a fixed order (no atomics): two calls on the
    same inputs agree bit for bit, as do the forwards."""
    x, w, dy = _card_inputs(rows, D, torch.bfloat16, seed=1)
    first = core.rms_norm_fwd(x, w, 1e-5)
    second = core.rms_norm_fwd(x, w, 1e-5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    rstd = first[1]
    dx1, dw1 = core.rms_norm_bwd(x, w, rstd, dy)
    dx2, dw2 = core.rms_norm_bwd(x, w, rstd, dy)
    assert torch.equal(dx1, dx2) and torch.equal(dw1, dw2)


@pytest.mark.cuda
def test_kernel_takes_a_non_contiguous_input_on_card():
    x, w, dy = _card_inputs(512, 256, torch.bfloat16, seed=2)
    xt = x.t().contiguous().t().requires_grad_()  # same values, strides (1, 512)
    assert not xt.is_contiguous()
    y = core.rms_norm(xt, w)
    y.backward(dy)
    want_y, want_dx, _ = _autograd(x, w, dy)
    assert ((y.float() - want_y.float()).abs() <= 2 ** -7 * want_y.float().abs()).all()
    assert _rel_l2(xt.grad, want_dx) <= 2e-3


@pytest.mark.cuda
def test_kernel_path_refuses_a_bf16_weight_on_card():
    x, w, _ = _card_inputs(4, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="weight must be float32"):
        core.rms_norm(x, w.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("is_moe", [False, True], ids=["llama", "moe"])
def test_remat_train_step_launches_what_the_model_implies_on_card(is_moe):
    """One remat step of the tiny preset at grad_accum 2: each micro-batch
    runs 2L block norms and the final norm forward, the 2L block norms
    again in the recompute, and 2L + 1 backwards; beside them RoPE's one
    launch a layer's pass (2L forwards, L backwards)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    if is_moe:
        model = moe.init_params(moe.MoeConfig.tiny(), gen)
    else:
        model = llama.init_params(llama.LlamaConfig.tiny(), gen)
    opt = harness.build_optimizer(model.named_parameters(), model)
    micro = 2
    step = harness.make_train_step(model, opt, make_flash_attn(),
                                   grad_accum=micro, remat=True,
                                   loss_chunk=0 if is_moe else 32)
    tokens = torch.randint(0, model.cfg.vocab, (2 * micro, 65), device=dev,
                           generator=gen)
    core.reset_launches()
    loss, _ = step(tokens)
    torch.cuda.synchronize()
    L = model.cfg.n_layers
    assert core.launches == {"rms_norm_fwd": micro * (4 * L + 1),
                             "rms_norm_bwd": micro * (2 * L + 1),
                             "rope_fwd": micro * 2 * L, "rope_bwd": micro * L}
    assert torch.isfinite(loss).all()
    for name, p in model.named_parameters():
        if name.endswith("norm"):
            assert p.grad is None or torch.isfinite(p.grad).all(), name
