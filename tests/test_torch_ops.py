"""Port parity: the torch core ops against tpumon/workload/ops/core.py.

Same numpy inputs (fixed seed) through both; f32 throughout, atol 1e-6
(one f32 ulp is 6e-8 near 1, so this allows a few ulps of summation-order
and transcendental-implementation difference).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpumon.workload.ops import core as jcore  # noqa: E402
from tpumon.workload_torch.ops import core as tcore  # noqa: E402

ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 128)])
def test_rms_norm_matches_reference(shape):
    rng = _rng()
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = np.asarray(jcore.rms_norm(x, w))
    out = tcore.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("D", [128, 512, 4096])
def test_rms_norm_closed_form_backward_matches_jax_grad(D):
    """The closed form the CUDA backward computes (``rms_norm_bwd_reference``
    from the plain forward's rstd) against ``jax.vjp`` of the reference's
    ``rms_norm``: f32, ATOL times the largest magnitude of each gradient
    (the two sides add a row's D products in other orders)."""
    rng = _rng(D)
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    dy = rng.standard_normal((3, 7, D)).astype(np.float32)
    _, vjp = jax.vjp(jcore.rms_norm, x, w)
    want_dx, want_dw = (np.asarray(g) for g in vjp(dy))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _, rstd = tcore.rms_norm_reference(xt, wt)
    dx, dw = tcore.rms_norm_bwd_reference(xt, wt, rstd, torch.from_numpy(dy))
    for got, want in ((dx, want_dx), (dw, want_dw)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=ATOL * np.abs(want).max())


def test_rms_norm_casts_back_to_input_dtype():
    x = torch.from_numpy(_rng(1).standard_normal((2, 4, 32)).astype(np.float32))
    out = tcore.rms_norm(x.to(torch.bfloat16), torch.ones(32))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("head_dim,max_seq", [(16, 128), (32, 128), (128, 4096)])
def test_rope_freqs_matches_reference(head_dim, max_seq):
    ref = np.asarray(jcore.rope_freqs(head_dim, max_seq))
    out = tcore.rope_freqs(head_dim, max_seq)
    assert tuple(out.shape) == (max_seq, head_dim // 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("offset", [0, 100])
def test_apply_rope_matches_reference(offset):
    """Split-halves rotation (not interleaved pairs), at positions near
    the start and deep into the table."""
    x = _rng(2).standard_normal((2, 8, 4, 32)).astype(np.float32)
    freqs = np.array(jcore.rope_freqs(32, 128))[offset:offset + 8]
    ref = np.asarray(jcore.apply_rope(x, freqs))
    out = tcore.apply_rope(torch.from_numpy(x), torch.from_numpy(freqs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
