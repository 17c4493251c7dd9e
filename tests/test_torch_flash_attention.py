"""Port parity: the torch flash attention against the Pallas kernels.

On the CPU the port's wrappers compute with their plain versions; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
The same numpy inputs (fixed seed) go through both, over the cases of
tests/test_flash_attention.py (MHA, GQA, MQA, S not a power of two; causal
and not) plus one non-causal Sk != S, each side at the same requested
block_q/block_k. Tolerances: O and lse atol 1e-5, gradients atol 1e-4
(f32; the two sides only sum in other orders), one bf16 case atol 2e-2
(bf16 output rounding). The tile chooser (pick_block, default_blocks,
effective_blocks) is pure Python and is checked here too.
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


def _port(q, k, v, g_out, g_lse, causal, bq=None, bk=None):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                           block_q=bq, block_k=bk)
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
    out, lse, grads = _port(q, k, v, g_out, g_lse, causal, bq, bk)
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


@pytest.mark.parametrize("requested,tile", [
    (256, 128), (128, 128), (100, 64), (64, 64), (32, 64), (1, 64),
])
def test_pick_block_clamps_to_a_compiled_tile(requested, tile):
    """The largest compiled tile not above the request, at least 64 (the
    kernels mask ragged edges, so no divisor is needed)."""
    assert fa.pick_block(requested) == tile


@pytest.mark.parametrize("requested", [0, -64])
def test_pick_block_raises_below_one(requested):
    with pytest.raises(ValueError, match="below 1"):
        fa.pick_block(requested)


@pytest.mark.parametrize("kwargs", [{"block_q": 0}, {"block_k": -1}])
def test_entry_points_check_the_request_on_cpu(kwargs):
    """The plain versions serve CPU tensors but still check a request."""
    q, k, v, _, _ = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2, 1, 8))
    with pytest.raises(ValueError, match="below 1"):
        fa.flash_attention(q, k, v, **kwargs)
    with pytest.raises(ValueError, match="below 1"):
        fa.flash_fwd(q, k, v, True, **kwargs)


# (case, B, S, H, KV, D, flash_fwd, flash_dq, flash_dkv) at the shapes of
# chip_smoke.py's CASES: the grid at 128 rows against one wave of 132.
DEFAULTS = [
    ("main", 2, 4096, 16, 4, 128, (128, 128), (128, 64), (64, 128)),
    ("moe", 1, 4096, 8, 4, 64, (128, 128), (128, 64), (64, 64)),
    ("tp2", 1, 4096, 8, 2, 128, (128, 128), (128, 64), (64, 64)),
    ("long", 1, 16384, 4, 1, 128, (128, 128), (128, 64), (64, 64)),
    ("zz", 2, 1024, 8, 2, 128, (64, 64), (64, 64), (64, 64)),
    ("d32", 2, 32, 2, 1, 32, (64, 64), (64, 64), (64, 64)),
]


@pytest.mark.parametrize("case,B,S,H,KV,D,fwd,dq,dkv", DEFAULTS)
def test_default_blocks_take_64_rows_below_one_wave(case, B, S, H, KV, D,
                                                    fwd, dq, dkv):
    got = fa.default_blocks(B, H, KV, S, S, D, True)
    assert got == {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}, case


@pytest.mark.parametrize("D,block_q,block_k,want", [
    # flash_dkv streams its q rows at the register cap: 32 at D = 128.
    (128, None, None, {"flash_fwd": (128, 128), "flash_dq": (128, 64),
                       "flash_dkv": (32, 128)}),
    (64, None, None, {"flash_fwd": (128, 128), "flash_dq": (128, 64),
                      "flash_dkv": (64, 128)}),
    # flash_dq is not compiled at 128 x 128: its k tile clamps to 64.
    (128, 256, 256, {"flash_fwd": (128, 128), "flash_dq": (128, 64),
                     "flash_dkv": (32, 128)}),
    (128, 100, 32, {"flash_fwd": (64, 64), "flash_dq": (64, 64),
                    "flash_dkv": (32, 64)}),
    (64, 64, 128, {"flash_fwd": (64, 128), "flash_dq": (64, 128),
                   "flash_dkv": (64, 128)}),
    # head_dim 32 runs padded to 64, at 64's caps.
    (32, 128, 64, {"flash_fwd": (128, 64), "flash_dq": (128, 64),
                   "flash_dkv": (64, 64)}),
])
def test_effective_blocks(D, block_q, block_k, want):
    """What each kernel runs at the main path's shape for a request: the
    clamps, flash_dq's compiled set and flash_dkv's q cap."""
    got = fa.effective_blocks(2, 16, 4, 4096, 4096, D, True, block_q, block_k)
    assert got == want
    for name, pair in got.items():
        assert pair[1] in fa.TILES
        if name != "flash_dkv":
            assert pair in fa.COMPILED[name][fa.kernel_width(D)]


def test_one_request_sets_only_its_own_tile():
    """block_q alone keeps each kernel's default k tile, and back."""
    only_q = fa.effective_blocks(1, 8, 2, 4096, 4096, 128, True, block_q=64)
    only_k = fa.effective_blocks(1, 8, 2, 4096, 4096, 128, True, block_k=128)
    assert only_q == {"flash_fwd": (64, 128), "flash_dq": (64, 64),
                      "flash_dkv": (32, 64)}
    assert only_k == {"flash_fwd": (128, 128), "flash_dq": (128, 64),
                      "flash_dkv": (32, 128)}


@pytest.mark.parametrize("tiles", [(64, 64), (128, 64), (64, 128), (256, 1)])
def test_tile_requests_leave_the_cpu_math_unchanged(tiles):
    """Every request computes the same dense math on the CPU, forward and
    backward, bit for bit; and launches nothing."""
    q, k, v, g_out, g_lse = _inputs(1, 48, 48, 4, 2, 16, seed=7)
    fa.reset_launches()
    plain = _port(q, k, v, g_out, g_lse, True)
    tiled = _port(q, k, v, g_out, g_lse, True, *tiles)
    for a, b in zip((plain[0], plain[1], *plain[2]), (tiled[0], tiled[1], *tiled[2])):
        np.testing.assert_array_equal(a, b)
    assert fa.tile_launches == {}


def test_make_flash_attn_takes_tiles():
    q, k, v, _, _ = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 4, 2, 8))
    attn = fa.make_flash_attn(block_q=64, block_k=128)
    torch.testing.assert_close(attn(q, k, v), fa.flash_attention(q, k, v),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="below 1"):
        fa.make_flash_attn(block_k=0)(q, k, v)


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
    assert fa.tile_launches == {}


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
        fa._check_kernel_inputs({"q": q, "k": k, "v": k}, "flash_fwd")


@pytest.mark.parametrize("D,width", [(32, 64), (8, 64), (40, 64), (96, 128),
                                     (64, 64), (128, 128), (136, 192),
                                     (192, 192)])
def test_kernel_width_pads_up_to_the_next_compiled_head_dim(D, width):
    assert fa.kernel_width(D) == width


@pytest.mark.parametrize("D", [200, 256, 36, 0])
def test_kernel_width_refuses_what_no_padding_serves(D):
    """Above 192, or not a multiple of 8: raised, naming the widths."""
    with pytest.raises(ValueError, match=r"takes \(64, 128, 192\)"):
        fa.kernel_width(D)


@pytest.mark.parametrize("B,S,Sk,H,KV,D,causal", [
    (2, 32, 32, 2, 1, 32, True),   # a tp=2 rank of the tiny dryrun
    (2, 8, 8, 2, 1, 32, False),    # a zigzag stripe pair at sp=2
    (1, 48, 80, 4, 2, 96, False),  # pads to 128, Sk != S
])
def test_padding_to_the_kernel_width_is_exact(B, S, Sk, H, KV, D, causal):
    """The wrappers' padding path (``_on_width``: zero columns up to the
    compiled width, the true D's scale, outputs sliced) run on the plain
    versions, against the plain versions on the unpadded inputs: forward
    and backward at f32 rel 1e-6."""
    q, k, v, do, _ = (torch.from_numpy(a) for a in _inputs(B, S, Sk, H, KV, D, seed=3))
    assert fa.kernel_width(D) != D
    o, lse = fa._on_width("flash_fwd", fa.flash_fwd_reference, q, k, v,
                          causal=causal)
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, causal)
    delta = fa.flash_delta(want_o, do)
    dq = fa._on_width("flash_dq", fa.flash_dq_reference, q, k, v, do, want_lse,
                      delta, causal=causal)
    dk, dv = fa._on_width("flash_dkv", fa.flash_dkv_reference, q, k, v, do,
                          want_lse, delta, causal=causal)
    want = [want_o, want_lse, fa.flash_dq_reference(q, k, v, do, want_lse, delta, causal),
            *fa.flash_dkv_reference(q, k, v, do, want_lse, delta, causal)]
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse, dq, dk, dv), want):
        assert got.shape == ref.shape and got.is_contiguous(), name
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("D,Dv,entry,widths", [
    (192, 128, "flash_dkv_mla", (192, 128)),  # DeepSeek-V2's latent attention
    (192, 192, None, None),   # v wider than the table's 128 at 192: refused
    (192, 64, "flash_dkv_mla", (192, 128)),   # a narrower v: padded to 128
    (128, 128, "flash_dkv", (128, 128)), (64, 64, "flash_dkv", (64, 64)),
    (32, 32, "flash_dkv", (64, 64)),
])
def test_dkv_split_is_read_from_the_widths(D, Dv, entry, widths):
    """flash_dkv's C entry and the (q·k, v) widths it runs, read from
    ``WIDTHS`` at the compiled width of the caller's D: the kernel sees q,
    k, v and dO at those widths and the caller gets dK and dV back at its
    own; a v wider than the table's is refused before any run."""
    B, S, H, KV = 1, 16, 2, 1
    q, k = torch.zeros(B, S, H, D), torch.zeros(B, S, KV, D)
    v, do = torch.zeros(B, S, KV, Dv), torch.zeros(B, S, H, Dv)
    lse, delta = torch.zeros(B, H, S), torch.zeros(B, H, S)
    seen = []

    def run(q, k, v, do, lse, delta, causal, scale):
        seen.append((q.shape[3], k.shape[3], v.shape[3], do.shape[3]))
        return torch.zeros_like(k), torch.zeros_like(v)

    width = fa.kernel_width(D)
    if entry is None:
        with pytest.raises(ValueError, match=r"runs v up to 128 wide \(WIDTHS\)"):
            fa._on_width("flash_dkv", run, q, k, v, do, lse, delta, causal=True)
        assert seen == []
        return
    dk, dv = fa._on_width("flash_dkv", run, q, k, v, do, lse, delta, causal=True)
    assert fa.WIDTHS["flash_dkv"][width].entry == entry
    assert seen == [(widths[0], widths[0], widths[1], widths[1])]
    assert dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.parametrize("tiles", [(None, None), (64, 64), (128, 64), (128, 128),
                                   (64, 128), (256, 32)])
def test_effective_blocks_at_split_widths(tiles):
    """At q·k 192 flash_dkv (flash_dkv_mla, v 128) streams 64 q rows a
    stage at k tiles of 64, whatever the request; flash_fwd and flash_dq
    run a pair they are compiled for at 192, their q rows uncapped."""
    dims = (16, 16, 16, 4096, 4096, 192, True, *tiles)
    got = fa.effective_blocks(*dims)
    assert got["flash_dkv"] == (64, 64)
    for name in ("flash_fwd", "flash_dq"):
        assert got[name] in fa.COMPILED[name][192]
        assert fa.WIDTHS[name][192] == (192, name, 128)
    assert fa.WIDTHS["flash_dkv"][192] == (128, "flash_dkv_mla", 64)
    assert fa.COMPILED["flash_dkv"][192] == ((64, 64), (128, 64))


def _stub_launches(monkeypatch):
    """Replace the kernels' launch with a recorder of its arguments."""
    calls = []

    def record(name, D, device, effective, *args):
        calls.append({"name": name, "D": D, "effective": effective, "args": args})

    monkeypatch.setattr(fa, "_launch", record)
    return calls


@pytest.mark.parametrize("D,Dv,width,v_width", [
    (192, 128, 192, 128), (192, 192, 192, None), (192, 64, 192, 128),
    (128, 128, 128, 128), (64, 64, 64, 64), (32, 32, 64, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_route_hands_the_kernel_its_widths(monkeypatch, D, Dv, width, v_width,
                                               causal):
    """The card path, with the launch stubbed on CPU tensors: each (D, Dv)
    reaches the entry ``WIDTHS`` names at the kernel width (q·k 192:
    flash_dkv_mla, else flash_dkv) with q and k padded to the q·k width
    and v and dO to the table's v width (the same storage where they are
    already that wide, dV allocated at it), dK and dV cut back to D and
    Dv; at (192, 192) v is wider than the table's 128 and nothing
    launches."""
    calls = _stub_launches(monkeypatch)
    B, S, H, KV = 1, 80, 4, 2
    bf = torch.bfloat16
    q, k = torch.randn(B, S, H, D, dtype=bf), torch.randn(B, S, KV, D, dtype=bf)
    v, do = torch.randn(B, S, KV, Dv, dtype=bf), torch.randn(B, S, H, Dv, dtype=bf)
    lse, delta = torch.zeros(B, H, S), torch.zeros(B, H, S)
    args = (q, k, v, do, lse, delta)
    if v_width is None:
        with pytest.raises(ValueError, match="WIDTHS"):
            fa._on_width("flash_dkv", fa._dkv_kernel, *args, causal=causal)
        assert calls == []
        return
    dk, dv = fa._on_width("flash_dkv", fa._dkv_kernel, *args, causal=causal)
    assert dk.shape == k.shape and dv.shape == v.shape
    (call,) = calls
    assert call["name"] == "flash_dkv" and call["D"] == width
    assert fa.WIDTHS["flash_dkv"][width].entry == (
        "flash_dkv_mla" if width == 192 else "flash_dkv")
    ptrs, ints = call["args"][:8], call["args"][8:]
    assert (ptrs[0] == q.data_ptr() and ptrs[1] == k.data_ptr()) is (width == D)
    assert (ptrs[2] == v.data_ptr() and ptrs[3] == do.data_ptr()) is (v_width == Dv)
    assert ints[:7] == (B, H, KV, S, S, width, v_width)
    if width == 192:
        assert call["effective"] == (64, 64)
    assert ints[-2] == pytest.approx(1 / np.sqrt(D))
    assert ints[-1] == int(causal)


@pytest.mark.parametrize("Dv,do_width,ok", [(128, 128, True), (64, 64, False),
                                            (128, 192, False), (192, 192, False)])
def test_split_input_check(Dv, do_width, ok):
    """At q·k 192 flash_dkv's kernel takes v and dO 128 wide only (the
    wrapper pads a narrower v); flash_fwd and flash_dq take them as wide
    as q."""
    bf = torch.bfloat16
    named = {"q": torch.zeros(1, 16, 2, 192, dtype=bf),
             "k": torch.zeros(1, 16, 2, 192, dtype=bf),
             "v": torch.zeros(1, 16, 2, Dv, dtype=bf),
             "do": torch.zeros(1, 16, 2, do_width, dtype=bf),
             "lse": torch.zeros(1, 2, 16), "delta": torch.zeros(1, 2, 16)}
    if ok:
        fa._check_kernel_inputs(named, "flash_dkv")
        for kernel in ("flash_fwd", "flash_dq"):
            with pytest.raises(ValueError, match="192 wide"):
                fa._check_kernel_inputs(named, kernel)
    else:
        with pytest.raises(ValueError, match=r"flash_dkv at q·k width 192 takes v and dO 128 wide"):
            fa._check_kernel_inputs(named, "flash_dkv")


def _card_inputs(B, S, Sk, H, KV, D):
    """Seeded bf16 q, k, v, dO on the card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return randn(B, S, H, D), randn(B, Sk, KV, D), randn(B, Sk, KV, D), randn(B, S, H, D)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(bq, bk) for bq in fa.TILES for bk in fa.TILES])
@pytest.mark.parametrize(
    "B,S,Sk,H,KV,D,causal",
    [
        (2, 256, 256, 8, 2, 128, True),    # GQA, whole tiles
        (1, 200, 300, 4, 4, 64, False),    # MHA, Sk > S, ragged
        (1, 1000, 1000, 8, 2, 128, True),  # S not a multiple of the tiles
        (2, 48, 48, 4, 2, 64, True),       # S below one tile
        (1, 48, 80, 4, 1, 128, False),     # MQA, below one tile, Sk != S
        (2, 384, 384, 4, 4, 128, True),    # MHA
        (1, 300, 200, 8, 1, 64, False),    # MQA, Sk < S
        (1, 65, 65, 4, 2, 64, True),       # one past a 64-row k tile
        (2, 65, 65, 4, 1, 128, True),
        (2, 129, 129, 4, 2, 64, True),     # one past a 128-row q-block
        (1, 129, 129, 8, 2, 128, True),
        (2, 32, 32, 2, 1, 32, True),       # head_dim 32, padded to 64
        (2, 8, 8, 2, 1, 32, False),
        (1, 300, 300, 4, 4, 192, True),    # DeepSeek-V2's q·k width, ragged
        (2, 256, 256, 4, 4, 192, True),
        (1, 200, 300, 4, 2, 192, False),
        (2, 48, 48, 2, 2, 192, True),
    ],
)
def test_kernels_match_plain_versions_on_card(B, S, Sk, H, KV, D, causal, tiles):
    """Each CUDA kernel at each requested tile pair against its plain
    version on the card (bf16: O atol 2e-2, lse atol 1e-4, gradients
    relative L2 1e-2); the launches are counted under the tiles that
    effective_blocks names."""
    q, k, v, do = _card_inputs(B, S, Sk, H, KV, D)
    req = {"block_q": tiles[0], "block_k": tiles[1]}
    fa.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, causal, **req)
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal)
    assert (o.float() - ref_o.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = fa.flash_delta(ref_o, do)
    got = [fa.flash_dq(q, k, v, do, ref_lse, delta, causal, **req)]
    want = [fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal)]
    # At q·k 192 flash_dkv runs v 128 wide (WIDTHS): this v of 192 is
    # refused before any launch.
    dkv_runs = D != 192
    if dkv_runs:
        got += fa.flash_dkv(q, k, v, do, ref_lse, delta, causal, **req)
        want += fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal)
    else:
        with pytest.raises(ValueError, match="runs v up to 128 wide"):
            fa.flash_dkv(q, k, v, do, ref_lse, delta, causal, **req)
    for a, b in zip(got, want):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-2
    assert fa.launches == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": int(dkv_runs)}
    eff = fa.effective_blocks(B, H, KV, S, Sk, D, causal, *tiles)
    assert fa.tile_launches == {f"{name}[{a}x{b}]": 1 for name, (a, b) in eff.items()
                                if name != "flash_dkv" or dkv_runs}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_narrow_v_and_a_scale_on_card(causal):
    """DeepSeek-V2's attention through the public API on the card: q, k
    of width 192, v of 128 (padded to 192 for flash_fwd and flash_dq,
    sliced back; as it is for flash_dkv's one launch), the YaRN scale; O,
    lse and the three gradients against the plain versions on the
    unpadded inputs (the limits above)."""
    q, k, _, _ = _card_inputs(2, 384, 384, 4, 4, 192)
    v, do = (t[..., :128].contiguous() for t in _card_inputs(2, 384, 384, 4, 4, 192)[2:])
    scale = 0.1147
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = fa.flash_delta(ref_o, do)
    want = [fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal, scale),
            *fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal, scale)]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*leaves, causal=causal, scale=scale)
    assert o.shape == (2, 384, 4, 128)
    assert (o.float() - ref_o.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    fa.reset_launches()
    o.backward(do)
    for t, b in zip(leaves, want):
        assert t.grad.shape == b.shape
        rel = ((t.grad.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-2
    # dK and dV came from the one launch at the true widths, not from the
    # two launches of the padded route.
    dkv_keys = {key: n for key, n in fa.tile_launches.items()
                if key.startswith("flash_dkv[")}
    assert dkv_keys == {"flash_dkv[64x64,v128]": 1}
    assert fa.launches["flash_dkv"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(bq, bk) for bq in fa.TILES for bk in fa.TILES])
@pytest.mark.parametrize(
    "B,S,Sk,H,KV,causal",
    [
        (1, 300, 300, 4, 4, True),    # MHA, ragged
        (1, 300, 300, 4, 4, False),
        (2, 48, 48, 2, 2, True),      # below one tile
        (2, 256, 256, 8, 2, True),    # GQA, whole tiles
        (1, 200, 300, 8, 2, False),   # GQA, Sk > S
        (1, 300, 200, 4, 1, False),   # MQA, Sk < S
        (1, 129, 129, 4, 4, True),    # one past two 64-row tiles
    ],
)
def test_split_widths_match_plain_version_on_card(B, S, Sk, H, KV, causal, tiles):
    """flash_dkv at q·k 192 and v 128 (one launch, v and dO unpadded)
    against its plain version on the same unpadded inputs, the YaRN scale,
    at every tile request (gradients relative L2 1e-2); the launch is
    counted once, under the split-width key."""
    q, k, v, do = _card_inputs(B, S, Sk, H, KV, 192)
    v, do = v[..., :128].contiguous(), do[..., :128].contiguous()
    scale = 0.1147
    ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = fa.flash_delta(ref_o, do)
    fa.reset_launches()
    got = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal, scale=scale,
                       block_q=tiles[0], block_k=tiles[1])
    want = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal, scale)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 1e-2
    assert fa.tile_launches == {"flash_dkv[64x64,v128]": 1}
    first = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkv"])
@pytest.mark.parametrize("D", [64, 128, 192])
def test_backward_kernels_are_deterministic_on_card(kernel, D):
    """dQ, dK and dV are sums kept on chip and written once (no atomics),
    so two calls on the same inputs agree bit for bit. At q·k 192 flash_dkv
    refuses this v of 192 (its v width there is 128; the one launch's
    determinism at v 128 is checked above)."""
    q, k, v, do = _card_inputs(1, 640, 640, 8, 2, D)
    _, lse = fa.flash_fwd(q, k, v, True)
    o, _ = fa.flash_fwd_reference(q, k, v, True)
    delta = fa.flash_delta(o, do)
    fn = getattr(fa, kernel)
    if kernel == "flash_dkv" and D == 192:
        with pytest.raises(ValueError, match="runs v up to 128 wide"):
            fn(q, k, v, do, lse, delta, True)
        return
    first = fn(q, k, v, do, lse, delta, True)
    second = fn(q, k, v, do, lse, delta, True)
    if kernel == "flash_dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
