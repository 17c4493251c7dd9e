"""Ring attention: sequence parallelism over the mesh's ``seq`` axis.

The counterpart of ``tpumon/workload/parallel/ring.py``, with the
reference's names. The sequence is split over the ranks of the ``seq``
group; K/V blocks rotate around the ring (counted ``collective-permute``
calls, ``parallel.mesh.permute``) while each rank accumulates its
queries' attention, with an online softmax in f32 (``attn="xla"``) or
with the port's flash kernels per block and an exact log-sum-exp merge
between them (``attn="flash"``). The zigzag layout (rank d holds stripes
d and 2n−1−d of 2n) balances the causal work across the ring.

JAX differentiates ``ppermute`` collectively; torch's autograd runs each
rank's graph on its own, skips nodes with no path to the loss and picks
its own order among ready nodes. So every exchange is an autograd
Function whose backward runs on every rank in one fixed order:

- :class:`_RingHops` returns the local K/V block together with every
  block it receives, so it lies on every rank's gradient path even when
  the rank attends no arriving block (the contiguous causal ring's rank
  0). Its backward runs exactly the reverse hops, with zeros for the
  blocks the rank never attended, rotating dK/dV around the reverse
  ring. K and V travel stacked, one message a hop.
- :class:`_ToZigzag` redistributes q, k and v in one node, and
  :class:`_FromZigzag` brings the output back; each one's backward is
  the other's exchange (the inverse permutations of ``_zigzag_perms``).

The local math is plain autograd over the received blocks, the math the
reference differentiates, written as functions of (q, the blocks, d, n):
block i came from rank (d − i) mod n. One process can run them with no
communication (``tests/test_torch_ring.py``).
"""

from __future__ import annotations

import functools
import math

import torch

from tpumon.workload_torch.parallel import mesh as mesh_mod

# Finite stand-in for -inf: masked logits become exp(x - m) == 0 without
# ever forming inf - inf when an entire block is masked out.
_NEG_BIG = -1e30

AXIS = "seq"


def _block_attn(q32, k, v, mask, m, l, o, scale):
    """One online-softmax accumulation step against a single K/V block.

    q32 [B,S,H,D] f32; k/v [B,Skv,H,D]; mask [S,Skv] bool (True = attend);
    m/l [B,H,S] f32 running max/denominator; o [B,H,S,D] f32 accumulator.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k.float()) * scale
    s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_BIG))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)  # rescale factor for previous accumulators
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l, o


def _expand(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Grouped-query expansion of a received block (``jnp.repeat``)."""
    rep = heads // t.shape[2]
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


# ---------------------------------------------------------------------------
# Communication (autograd Functions; backward runs on every rank)
# ---------------------------------------------------------------------------


def _ring_perm(n: int) -> list[tuple[int, int]]:
    return [(j, (j + 1) % n) for j in range(n)]


class _RingHops(torch.autograd.Function):
    """(the local block, the block after 1 hop, …, after ``hops`` hops).
    Block i came from (d − i) mod n. Backward: the reverse hops."""

    @staticmethod
    def forward(ctx, kv, mesh, hops):
        ctx.mesh, ctx.hops = mesh, hops
        perm = _ring_perm(mesh.sp)
        blocks = [kv.clone()]
        for _ in range(hops):
            blocks.append(mesh_mod.permute(blocks[-1], mesh, AXIS, perm))
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        inverse = [(b, a) for a, b in _ring_perm(ctx.mesh.sp)]
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = mesh_mod.permute(acc, ctx.mesh, AXIS, inverse) + g
        return acc, None, None


def ring_hops(k, v, mesh, hops: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(k, v) of block i] for i = 0 … ``hops``: K and V move as one
    stacked message a hop."""
    blocks = _RingHops.apply(torch.stack([k, v]), mesh, hops)
    return [(b[0], b[1]) for b in blocks]


def _zigzag_perms(n: int) -> tuple[list, list, list, list]:
    """Static permute pair lists for contiguous↔zigzag redistribution.

    Stripe g (of 2n stripes) lives contiguously on rank g//2; zigzag
    places it on rank g (lo slot) when g < n, else rank 2n-1-g (hi
    slot). One permute delivers at most one tensor per rank, so the
    exchange rides two: ``fwd_even`` carries each rank's even stripe
    (its first half, stripe 2d), ``fwd_odd`` the odd one. Each is a
    permutation, and the inverses are the reversed pairs.
    """
    fwd_even = []
    fwd_odd = []
    for d in range(n):
        g_even, g_odd = 2 * d, 2 * d + 1
        fwd_even.append((d, g_even if g_even < n else 2 * n - 1 - g_even))
        fwd_odd.append((d, g_odd if g_odd < n else 2 * n - 1 - g_odd))
    inv_even = [(dst, src) for src, dst in fwd_even]
    inv_odd = [(dst, src) for src, dst in fwd_odd]
    return fwd_even, fwd_odd, inv_even, inv_odd


def _to_zigzag_raw(x, mesh):
    """Contiguous local block [B, 2s, ...] → zigzag block [stripe_d;
    stripe_{2n-1-d}]: two permutes."""
    n, d = mesh.sp, mesh.coords[AXIS]
    fwd_even, fwd_odd, _, _ = _zigzag_perms(n)
    s = x.shape[1] // 2
    recv_even = mesh_mod.permute(x[:, :s], mesh, AXIS, fwd_even)
    recv_odd = mesh_mod.permute(x[:, s:], mesh, AXIS, fwd_odd)
    # Rank d's lo slot holds stripe d — delivered by the even carrier iff
    # d is even; the hi slot holds stripe 2n-1-d, even iff d is odd.
    if d % 2 == 0:
        return torch.cat([recv_even, recv_odd], dim=1)
    return torch.cat([recv_odd, recv_even], dim=1)


def _from_zigzag_raw(x, mesh):
    """Inverse of :func:`_to_zigzag_raw` (zigzag block → contiguous)."""
    n, d = mesh.sp, mesh.coords[AXIS]
    _, _, inv_even, inv_odd = _zigzag_perms(n)
    s = x.shape[1] // 2
    lo, hi = x[:, :s], x[:, s:]
    # The even-stripe carrier needs this rank's even stripe: stripe d (lo
    # slot) when d is even, stripe 2n-1-d (hi slot) when d is odd.
    send_even, send_odd = (lo, hi) if d % 2 == 0 else (hi, lo)
    recv_first = mesh_mod.permute(send_even, mesh, AXIS, inv_even)
    recv_second = mesh_mod.permute(send_odd, mesh, AXIS, inv_odd)
    return torch.cat([recv_first, recv_second], dim=1)


class _ToZigzag(torch.autograd.Function):
    """q, k, v into the zigzag layout in one node (their permutes in
    that order); the backward brings the gradients back."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(_to_zigzag_raw(x, mesh) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(_from_zigzag_raw(g, ctx.mesh) for g in grads))


class _FromZigzag(torch.autograd.Function):
    """The output back to the contiguous layout; backward the inverse."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _from_zigzag_raw(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _to_zigzag_raw(g, ctx.mesh), None


def _to_zigzag(xs, mesh) -> tuple:
    """The tensors ``xs`` (each [B, 2s, ...], contiguous layout) in the
    zigzag layout."""
    return _ToZigzag.apply(mesh, *xs)


def _from_zigzag(x, mesh):
    """The zigzag-layout ``x`` back to the contiguous layout."""
    return _FromZigzag.apply(x, mesh)


# ---------------------------------------------------------------------------
# Local math on given blocks (no communication)
# ---------------------------------------------------------------------------


def _ring_attention_math(q, blocks, d: int, n: int, causal: bool = True):
    """The contiguous ring's accumulation over ``blocks`` [(k, v)], block
    i from rank (d − i) mod n: q [B,S,H,D] → [B,S,H,D] in q's dtype."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    q32 = q.float()
    pos = torch.arange(S, device=q.device)
    q_pos = d * S + pos  # global positions of the local queries
    m = torch.full((B, H, S), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for i, (k, v) in enumerate(blocks):
        src = (d - i) % n
        if causal:
            mask = q_pos[:, None] >= (src * S + pos)[None, :]
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        m, l, o = _block_attn(q32, _expand(k, H), _expand(v, H), mask, m, l, o, scale)
    out = o / l[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _zigzag_attention_math(q, blocks, d: int, n: int):
    """The zigzag ring's accumulation (causal): q [B, 2s, H, D] and the
    blocks in zigzag layout, block i from rank (d − i) mod n."""
    B, S2, H, D = q.shape
    s = S2 // 2
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q32 = q.float()
    pos = torch.arange(s, device=dev)
    q_pos = torch.cat([d * s + pos, (2 * n - 1 - d) * s + pos])

    # Step 0: the local block attends itself, causally, at global
    # positions (the only masked compute in the whole schedule).
    k, v = blocks[0]
    m = torch.full((B, H, S2), _NEG_BIG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S2), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, S2, D), dtype=torch.float32, device=dev)
    self_mask = q_pos[:, None] >= q_pos[None, :]
    m, l, o = _block_attn(q32, _expand(k, H), _expand(v, H), self_mask, m, l, o, scale)

    lo = [m[..., :s], l[..., :s], o[..., :s, :]]
    hi = [m[..., s:], l[..., s:], o[..., s:, :]]
    q_lo32, q_hi32 = q32[:, :s], q32[:, s:]
    full = torch.ones((s, s), dtype=torch.bool, device=dev)
    for i, (k, v) in enumerate(blocks[1:], start=1):
        older = (d - i) % n < d  # the sender's lo stripe is older than ours
        k_lo, k_hi = _expand(k[:, :s], H), _expand(k[:, s:], H)
        v_lo, v_hi = _expand(v[:, :s], H), _expand(v[:, s:], H)
        # Slot 1: (lo if older else hi) × sender's lo — always unmasked.
        if older:
            lo = list(_block_attn(q_lo32, k_lo, v_lo, full, *lo, scale))
        else:
            hi = list(_block_attn(q_hi32, k_lo, v_lo, full, *hi, scale))
        # Slot 2: hi × (sender's lo if older else sender's hi) — always
        # unmasked (an older sender's lo is older than our hi; a newer
        # sender's hi stripe 2n-1-src is still older than ours 2n-1-d).
        k2, v2 = (k_lo, v_lo) if older else (k_hi, v_hi)
        hi = list(_block_attn(q_hi32, k2, v2, full, *hi, scale))
    l_full = torch.cat([lo[1], hi[1]], dim=-1)
    o_full = torch.cat([lo[2], hi[2]], dim=-2)
    out = o_full / l_full[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _flash(q, k, v, causal, block_q=None, block_k=None):
    """The (q, k, v, causal) → (o f32, lse) kernel call both flash rings
    share (``flash_attention_with_lse``: the Hopper kernels on the card at
    the requested tiles, None for the H100 table; their plain versions for
    CPU tensors)."""
    from tpumon.workload_torch.ops.flash_attention import flash_attention_with_lse

    o, lse = flash_attention_with_lse(q, k, v, causal=causal, block_q=block_q,
                                      block_k=block_k)
    return o.float(), lse


def _merge_partials(o_a, lse_a, o_b, lse_b):
    """Merge two normalized flash partials over the same query stripe.

    ``o`` is model-layout [B, s, H, D] (float32), ``lse`` is [B, H, s].
    Exact softmax combination: the partial with the larger log-sum-exp
    dominates, the other is rescaled.
    """
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return o_a * w_a + o_b * w_b, lse


def _zigzag_flash_math(q, blocks, d: int, n: int, block_q=None, block_k=None):
    """The zigzag ring with a flash call per stripe pair: hop 0 as three
    statically masked calls (lo × lo causal, hi × hi causal, hi × lo
    full), then two unmasked calls a hop, merged by log-sum-exp."""
    flash = functools.partial(_flash, block_q=block_q, block_k=block_k)
    s = q.shape[1] // 2
    q_lo, q_hi = q[:, :s], q[:, s:]
    k, v = blocks[0]
    o_lo, lse_lo = flash(q_lo, k[:, :s], v[:, :s], True)
    o_hh, lse_hh = flash(q_hi, k[:, s:], v[:, s:], True)
    o_hl, lse_hl = flash(q_hi, k[:, :s], v[:, :s], False)
    o_hi, lse_hi = _merge_partials(o_hh, lse_hh, o_hl, lse_hl)
    for i, (k, v) in enumerate(blocks[1:], start=1):
        older = (d - i) % n < d
        k_lo, k_hi = k[:, :s], k[:, s:]
        v_lo, v_hi = v[:, :s], v[:, s:]
        # Slot 1: (lo if older else hi) × sender's lo.
        if older:
            o1, lse1 = flash(q_lo, k_lo, v_lo, False)
            o_lo, lse_lo = _merge_partials(o_lo, lse_lo, o1, lse1)
        else:
            o1, lse1 = flash(q_hi, k_lo, v_lo, False)
            o_hi, lse_hi = _merge_partials(o_hi, lse_hi, o1, lse1)
        # Slot 2: hi × (sender's lo if older else sender's hi).
        k2, v2 = (k_lo, v_lo) if older else (k_hi, v_hi)
        o2, lse2 = flash(q_hi, k2, v2, False)
        o_hi, lse_hi = _merge_partials(o_hi, lse_hi, o2, lse2)
    return torch.cat([o_lo, o_hi], dim=1).to(q.dtype)


def _ring_flash_math(q, blocks, d: int, n: int, causal: bool = True,
                     block_q=None, block_k=None):
    """The contiguous ring with a flash call per attended hop: the self
    block (causal or not), then each arriving block in full; under
    ``causal`` a block from a later rank (src > d) is skipped, as the
    reference's ``lax.cond`` skips it."""
    flash = functools.partial(_flash, block_q=block_q, block_k=block_k)
    k, v = blocks[0]
    o, lse = flash(q, k, v, causal)  # hop 0: the self block
    for i, (k, v) in enumerate(blocks[1:], start=1):
        if causal and (d - i) % n > d:
            continue
        o2, lse2 = flash(q, k, v, False)
        o, lse = _merge_partials(o, lse, o2, lse2)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Per-rank bodies (the reference's shard_map bodies)
# ---------------------------------------------------------------------------


def ring_attention_local(q, k, v, mesh, *, causal: bool = True):
    """This rank's contiguous ring: q [B, S_local, H, D], k/v [B, S_local,
    KV, D]. n hops: the last returns each block to its owner, as the
    reference's uniform loop body does."""
    n = mesh.sp
    blocks = ring_hops(k, v, mesh, n)[:n]
    return _ring_attention_math(q, blocks, mesh.coords[AXIS], n, causal)


def zigzag_ring_attention_local(q, k, v, mesh):
    """The causal ring over zigzag-laid-out shards (n − 1 hops): q
    [B, 2s, H, D], k/v [B, 2s, KV, D] in zigzag layout."""
    n = mesh.sp
    blocks = ring_hops(k, v, mesh, n - 1)
    return _zigzag_attention_math(q, blocks, mesh.coords[AXIS], n)


def zigzag_ring_flash_local(q, k, v, mesh, *, block_q: int | None = None,
                            block_k: int | None = None):
    """The zigzag ring with the flash kernels on every stripe pair (n − 1
    hops); q/k/v in zigzag layout. ``block_q``/``block_k`` reach every
    kernel call (None: the H100 table for the stripe pair's shape)."""
    n = mesh.sp
    blocks = ring_hops(k, v, mesh, n - 1)
    return _zigzag_flash_math(q, blocks, mesh.coords[AXIS], n, block_q, block_k)


def ring_flash_local(q, k, v, mesh, *, causal: bool = True,
                     block_q: int | None = None, block_k: int | None = None):
    """The contiguous ring with the flash kernels per attended hop (n − 1
    hops; every rank sends on every hop, attended or not);
    ``block_q``/``block_k`` as in :func:`zigzag_ring_flash_local`."""
    n = mesh.sp
    blocks = ring_hops(k, v, mesh, n - 1)
    return _ring_flash_math(q, blocks, mesh.coords[AXIS], n, causal, block_q,
                            block_k)


def make_ring_attn(mesh, *, causal: bool = True, zigzag: bool = False,
                   flash: bool = False, block_q: int | None = None,
                   block_k: int | None = None):
    """An ``attn_impl`` q, k, v → out over this rank's sequence shard.

    The model hands it the rank's heads already: under tp a rank holds
    H/tp q and KV/tp kv heads, and ``check_tp`` requires n_kv_heads % tp
    == 0, so the reference's K/V pre-expansion for a model axis that does
    not divide KV never applies here. ``zigzag=True`` (causal only)
    redistributes q, k and v into the zigzag layout before the ring and
    the output back after; the residual stream and its positions stay
    contiguous. ``flash=True`` runs the flash kernels per block, at
    ``block_q``/``block_k`` (None: the H100 table)."""
    if zigzag and not causal:
        raise ValueError(
            "zigzag layout only pays off for causal attention (non-causal "
            "ring attention has no masked compute to eliminate)"
        )
    tiles = {"block_q": block_q, "block_k": block_k}
    if zigzag:
        body = (functools.partial(zigzag_ring_flash_local, **tiles) if flash
                else zigzag_ring_attention_local)

        def attn(q, k, v):
            q, k, v = _to_zigzag((q, k, v), mesh)
            return _from_zigzag(body(q, k, v, mesh), mesh)
    elif flash:
        def attn(q, k, v):
            return ring_flash_local(q, k, v, mesh, causal=causal, **tiles)
    else:
        def attn(q, k, v):
            return ring_attention_local(q, k, v, mesh, causal=causal)
    return attn


def reference_attention(q, k, v, *, causal: bool = True):
    """Dense O(S²) attention, same layout — numerics oracle for tests."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand(k, H).float())
    s = s / math.sqrt(D)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _expand(v, H).float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Counts (collective_counters.py and chip_smoke.py read them)
# ---------------------------------------------------------------------------


def hops(n: int, zigzag: bool, flash: bool) -> int:
    """Ring hops of one attention call: n for the contiguous plain ring
    (its last hop returns the blocks home), n − 1 otherwise."""
    if n == 1:
        return 0
    return n - 1 if zigzag or flash else n


def permutes_per_call(n: int, zigzag: bool, flash: bool, coord: int) -> int:
    """Counted permutes of one attention call's forward on the rank at seq
    coordinate ``coord`` (its backward issues as many): the hops, and
    under zigzag two carriers for each of q, k, v and the output, less
    the carriers that map this rank to itself (local copies)."""
    calls = hops(n, zigzag, flash)
    if zigzag and n > 1:
        fwd_even, fwd_odd, _, _ = _zigzag_perms(n)
        moved = int(dict(fwd_even)[coord] != coord) + int(dict(fwd_odd)[coord] != coord)
        calls += 4 * moved
    return calls


def flash_calls_per_layer(n: int, zigzag: bool, coord: int, causal: bool = True) -> int:
    """Flash forward calls of one attention call on the rank at seq
    coordinate ``coord``: 2n + 1 on the zigzag ring (three for the self
    block, two a hop); on the contiguous causal ring 1 + coord (the self
    block and each older block), n when not causal."""
    if zigzag:
        return 2 * n + 1
    return 1 + coord if causal else n


__all__ = [
    "flash_calls_per_layer",
    "hops",
    "make_ring_attn",
    "permutes_per_call",
    "reference_attention",
    "ring_attention_local",
    "ring_flash_local",
    "ring_hops",
    "zigzag_ring_attention_local",
    "zigzag_ring_flash_local",
]
