"""Port parity: the torch flash attention against the Pallas kernels.

On the CPU the port's wrappers compute with their plain versions; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
The same numpy inputs (fixed seed) go through both, over the cases of
tests/test_flash_attention.py (MHA, GQA, MQA, S not a power of two; causal
and not) plus one non-causal Sk != S. Tolerances: O and lse atol 1e-5,
gradients atol 1e-4 (f32; the two sides only sum in other orders), one
bf16 case atol 2e-2 (bf16 output rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch.ops import flash_attention as fa  # noqa: E402


def _jax():
    """(jax, jnp, the reference's flash_attention_with_lse) for the parity
    halves; the card-only test at the bottom runs where jax is absent."""
    jax = pytest.importorskip("jax")
    from tpumon.workload.ops.flash_attention import flash_attention_with_lse

    return jax, jax.numpy, flash_attention_with_lse


def _inputs(B, S, Sk, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    g_out = rng.standard_normal((B, S, H, D)).astype(np.float32)
    g_lse = rng.standard_normal((B, H, S)).astype(np.float32)
    return q, k, v, g_out, g_lse


def _reference(q, k, v, g_out, g_lse, causal, bq, bk):
    """(O, lse) and the vjp of both outputs from the Pallas kernels."""
    jax, jnp, jax_flash_with_lse = _jax()

    def f(q, k, v):
        return jax_flash_with_lse(q, k, v, causal=causal, block_q=bq, block_k=bk)

    (out, lse), vjp = jax.vjp(f, q, k, v)
    grads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _port(q, k, v, g_out, g_lse, causal):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    torch.autograd.backward(
        (out, lse), (torch.from_numpy(g_out), torch.from_numpy(g_lse))
    )
    return out.detach().numpy(), lse.detach().numpy(), [
        t.grad.numpy() for t in (tq, tk, tv)
    ]


@pytest.mark.parametrize(
    "B,S,Sk,H,KV,D,bq,bk,causal",
    [
        (2, 64, 64, 4, 4, 16, 32, 32, True),    # MHA, multiple blocks
        (2, 64, 64, 4, 4, 16, 32, 32, False),
        (1, 64, 64, 4, 2, 16, 16, 32, True),    # GQA, uneven q/k blocks
        (1, 64, 64, 4, 2, 16, 16, 32, False),
        (2, 32, 32, 4, 1, 8, 128, 128, True),   # MQA, blocks clamp to S
        (2, 32, 32, 4, 1, 8, 128, 128, False),
        (1, 96, 96, 2, 2, 16, 32, 32, True),    # S not a power of two
        (1, 96, 96, 2, 2, 16, 32, 32, False),
        (1, 64, 96, 4, 2, 16, 32, 32, False),   # rectangular, Sk != S
    ],
)
def test_matches_pallas_kernels(B, S, Sk, H, KV, D, bq, bk, causal):
    q, k, v, g_out, g_lse = _inputs(B, S, Sk, H, KV, D)
    ref_out, ref_lse, ref_grads = _reference(q, k, v, g_out, g_lse, causal, bq, bk)
    out, lse, grads = _port(q, k, v, g_out, g_lse, causal)
    assert out.shape == (B, S, H, D) and lse.shape == (B, H, S)
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)


def test_bfloat16_matches_pallas_kernels():
    _, jnp, jax_flash_with_lse = _jax()
    q, k, v, _, _ = _inputs(2, 64, 64, 4, 2, 32, seed=1)
    to_bf16 = (lambda a: jnp.asarray(a, jnp.bfloat16))
    ref = jax_flash_with_lse(*map(to_bf16, (q, k, v)), block_q=32, block_k=32)[0]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=2e-2
    )


def test_rejects_bad_head_ratio():
    q, k, v, _, _ = _inputs(1, 32, 32, 4, 3, 8, seed=5)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(*map(torch.from_numpy, (q, k, v)))


def test_causal_needs_matching_lengths():
    q, k, v, _, _ = _inputs(1, 32, 48, 2, 2, 8)
    with pytest.raises(ValueError, match="causal=False"):
        fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)


def test_cpu_tensors_launch_no_kernel():
    """The plain versions serve CPU tensors; the launch counters move only
    where a wrapper launches its kernel."""
    q, k, v, g_out, g_lse = _inputs(1, 32, 32, 2, 1, 8)
    fa.reset_launches()
    _port(q, k, v, g_out, g_lse, causal=True)
    assert fa.launches == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


@pytest.mark.parametrize(
    "dtype,D,contiguous,error",
    [
        (torch.float32, 128, True, TypeError),    # kernels take bf16
        (torch.bfloat16, 96, True, ValueError),   # head dim not compiled
        (torch.bfloat16, 64, False, ValueError),  # strided input
    ],
)
def test_kernel_input_checks(dtype, D, contiguous, error):
    """What the CUDA wrappers refuse before any launch (checked on CPU
    tensors: the check is pure shape/dtype/layout logic)."""
    q = torch.zeros(1, 16, 2, D, dtype=dtype)
    if not contiguous:
        q = torch.zeros(1, 2, 16, D, dtype=dtype).transpose(1, 2)
    k = torch.zeros(1, 16, 1, D, dtype=dtype)
    with pytest.raises(error):
        fa._check_kernel_inputs({"q": q, "k": k, "v": k})


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,Sk,H,KV,D,causal",
    [(2, 256, 256, 8, 2, 128, True), (1, 200, 300, 4, 4, 64, False)],
)
def test_kernels_match_plain_versions_on_card(B, S, Sk, H, KV, D, causal):
    """Each CUDA kernel against its plain version on the card (bf16:
    O atol 2e-2, lse atol 1e-4, gradients relative L2 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = randn(B, S, H, D), randn(B, Sk, KV, D), randn(B, Sk, KV, D), randn(B, S, H, D)
    fa.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, causal)
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal)
    assert (o.float() - ref_o.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = fa.flash_delta(ref_o, do)
    got = [fa.flash_dq(q, k, v, do, ref_lse, delta, causal),
           *fa.flash_dkv(q, k, v, do, ref_lse, delta, causal)]
    want = [fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal),
            *fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal)]
    for a, b in zip(got, want):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-2
    assert fa.launches == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
