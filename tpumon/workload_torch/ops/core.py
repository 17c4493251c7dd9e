"""Core ops of the workload model: RMSNorm, rotary embeddings (YaRN's
too) and the cast of an f32 master weight to the compute dtype.

Counterparts of ``tpumon/workload/ops/core.py``, computed in the same
dtypes (f32 inside, cast back to the input dtype). Each runs in its own
span (``workload.norm``, ``workload.rope``, ``workload.cast``; see
``spans.py``).

RMSNorm on the card is one hand-written CUDA kernel pair
(``ops/csrc/rms_norm_fwd.cu``, ``ops/csrc/rms_norm_bwd.cu``) behind one
autograd Function: the forward saves x, the weight and the f32 rstd, the
backward computes dx and dw from them (:func:`rms_norm_bwd_reference`
is its closed form). The JAX package has no kernel here: XLA fuses its
``rms_norm`` on the TPU. On the CPU ``rms_norm`` is the plain eager f32
chain (:func:`rms_norm_reference`) under autograd, as it always was; for
CUDA tensors it launches the kernels or raises (:func:`check_kernel_inputs`).

RoPE on the card is one hand-written CUDA kernel (``ops/csrc/rope.cu``)
behind one autograd Function (:func:`rope_qk`): one launch turns q and k
together, and the backward launches it again with sin negated, which is
the rotation's gradient bit for bit. The kernel rounds every product on
its own, then the difference or sum, then once to the input's dtype, so
it gives the plain chain's bits (:func:`rope_rotate`). On the CPU
``rope_qk`` is :func:`apply_rope` on each tensor, the plain chain under
autograd; for CUDA tensors it launches the kernel or raises
(:func:`check_rope_inputs`).
"""

from __future__ import annotations

import math

import torch

from tpumon.workload_torch.spans import traced

#: The widest row the kernels take; a row's width must be a multiple of 8
#: (``ops/csrc/rms_norm.cuh`` compiles a layout for every such width).
MAX_WIDTH = 8192

#: Dtypes of x (and y, dy, dx) the kernels take; the weight, dw and rstd
#: are f32.
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

#: The backward's CTAs a multiprocessor; each writes one [D] partial of dw.
#: The fastest of 1, 2, 4, 8, 16 and 32 at [65536, 4096] and [16384, 4096]
#: bf16 on an H100 (0.609 ms at 4, 0.675 at 2, 0.618 at 8: PERF.md).
BWD_CTAS_PER_SM = 4

#: The widest head the rope kernel takes; a head's width must be a multiple
#: of 16 (``ops/csrc/rope.cu``: a half-row is whole 16-byte vectors).
ROPE_MAX_WIDTH = 256

#: Kernel launches since the last :func:`reset_launches`, one count per
#: wrapper, raised only where the wrapper launches (``rms_norm_bwd``'s call
#: is two launches: the rows, then the column sums of dw).
launches: dict[str, int] = {"rms_norm_fwd": 0, "rms_norm_bwd": 0,
                            "rope_fwd": 0, "rope_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd): RMSNorm as eager f32 passes, y cast back to x's dtype, and
    rstd = rsqrt(mean(x²) + eps) f32 of shape ``x.shape[:-1] + (1,)``."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * weight).to(x.dtype), scale


def rms_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                           rstd: torch.Tensor, dy: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw f32 [D]): RMSNorm's backward in closed form from
    the forward's rstd r, as ``rms_norm_bwd`` computes it: g = dy·w,
    c = Σ g·x over the row, dx = r·g − x·(r³·c/D), dw = Σ over rows of
    dy·(x·r)."""
    D = x.shape[-1]
    x32, dy32 = x.float(), dy.float()
    r = rstd.float()
    g = dy32 * weight
    c = (g * x32).sum(dim=-1, keepdim=True)
    dx = r * g - x32 * (r * r * r * c * (1.0 / D))
    dw = (dy32 * (x32 * r)).reshape(-1, D).sum(dim=0)
    return dx.to(x.dtype), dw


def check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor) -> None:
    """What the kernels take, whatever the device: x in bf16 or f32 with a
    row width that is a multiple of 8 up to :data:`MAX_WIDTH`, the weight
    f32 [D]. Raises TypeError or ValueError naming what is wrong."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"rms_norm kernel: x must be bfloat16 or float32, got {x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"rms_norm kernel: weight must be float32, got {weight.dtype}")
    D = x.shape[-1] if x.dim() else 0
    if D % 8 or not 8 <= D <= MAX_WIDTH:
        raise ValueError(
            f"rms_norm kernel: row width {D} not compiled (takes multiples of "
            f"8 from 8 to {MAX_WIDTH}: 128, 512, 2048 and 4096 among them)"
        )
    if tuple(weight.shape) != (D,):
        raise ValueError(
            f"rms_norm kernel: weight must be [{D}], got {tuple(weight.shape)}"
        )


def _launch(name: str, device: torch.device, *args, count: str | None = None) -> None:
    """Launch kernel ``name`` with its C entry's ``args`` and count it under
    ``count`` (its own name by default)."""
    from tpumon.workload_torch.ops._build import load

    fn = getattr(load(name), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: error {err} (a cudaError_t, or 20001 for "
            "a width the kernel does not take)"
        )
    launches[count or name] += 1


def _check_devices(kernel: str, **named: torch.Tensor) -> None:
    """Every tensor on the first one's CUDA device."""
    first, device = next(iter(named)), next(iter(named.values())).device
    for name, t in named.items():
        if device.type != "cuda" or t.device != device:
            raise ValueError(f"{kernel} kernel: {name} must be on {first}'s CUDA "
                             f"device, got {t.device} ({first} on {device})")


def _check_pointers(**named: torch.Tensor) -> None:
    """What the kernels' pointers need: every tensor on x's CUDA device,
    contiguous and 16-byte aligned."""
    _check_devices("rms_norm", **named)
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"rms_norm kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"rms_norm kernel: {name} must be 16-byte aligned")


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd [..., 1] f32) from kernel ``rms_norm_fwd``; x contiguous on
    the card, checked by :func:`check_kernel_inputs`."""
    check_kernel_inputs(x, weight)
    _check_pointers(x=x, weight=weight)
    D = x.shape[-1]
    y = torch.empty_like(x)
    rstd = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    _launch("rms_norm_fwd", x.device, x.data_ptr(), weight.data_ptr(),
            y.data_ptr(), rstd.data_ptr(), x.numel() // D, D,
            int(x.dtype == torch.float32), eps)
    return y, rstd


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw f32 [D]) from kernel ``rms_norm_bwd`` (a grid of
    :data:`BWD_CTAS_PER_SM` CTAs a multiprocessor, each writing one partial
    of dw, then their column sums); x and dy contiguous on the card."""
    check_kernel_inputs(x, weight)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(
            f"rms_norm kernel: dy must match x ({x.dtype} {tuple(x.shape)}), "
            f"got {dy.dtype} {tuple(dy.shape)}"
        )
    if rstd.dtype != torch.float32 or rstd.shape != (*x.shape[:-1], 1):
        raise ValueError(
            f"rms_norm kernel: rstd must be float32 {(*x.shape[:-1], 1)}, got "
            f"{rstd.dtype} {tuple(rstd.shape)}"
        )
    _check_pointers(x=x, dy=dy, weight=weight, rstd=rstd)
    D = x.shape[-1]
    rows = x.numel() // D
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(rows, sms * BWD_CTAS_PER_SM))
    dx = torch.empty_like(x)
    part = torch.empty((grid, D), dtype=torch.float32, device=x.device)
    dw = torch.empty((D,), dtype=torch.float32, device=x.device)
    _launch("rms_norm_bwd", x.device, x.data_ptr(), dy.data_ptr(),
            weight.data_ptr(), rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dw.data_ptr(), rows, D, int(x.dtype == torch.float32), grid)
    return dx, dw


class _RmsNorm(torch.autograd.Function):
    """RMSNorm on the kernel pair; saves x, the weight and rstd only."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        x = x.contiguous()
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, dy.contiguous())
        return dx, dw, None


@traced("norm")
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 accumulation, cast back to the input dtype: the
    kernel pair for tensors on the card, :func:`rms_norm_reference` under
    autograd for tensors on the CPU."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)[0]
    return _RmsNorm.apply(x, weight, eps)


def rope_freqs(
    head_dim: int, max_seq: int, theta: float = 10000.0, device=None
) -> torch.Tensor:
    """Rotary-embedding angles [max_seq, head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (exponent / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention temperature for a context ``factor`` times the
    original (``yarn_get_mscale`` of DeepSeek-V2's modeling code):
    0.1·mscale·ln(factor) + 1, or 1 where factor ≤ 1."""
    if factor <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, max_seq: int, theta: float = 10000.0,
               factor: float = 1.0, original_max: int = 4096,
               beta_fast: float = 32.0, beta_slow: float = 1.0,
               device=None) -> torch.Tensor:
    """YaRN's rotary angles [max_seq, dim // 2] f32, after DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``: each pair's frequency blends the
    original θ^(−2i/dim) (pairs that turn more than ``beta_fast`` times
    over ``original_max`` positions) with it divided by ``factor`` (pairs
    that turn fewer than ``beta_slow`` times), linearly in between. With
    ``factor`` 1 they are :func:`rope_freqs`'s."""

    def pair_of(turns: float) -> float:
        # The pair index whose wavelength fits ``turns`` times in original_max.
        return (dim * math.log(original_max / (turns * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(pair_of(beta_fast)), 0)
    high = min(math.ceil(pair_of(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / (theta ** (exponent / dim))
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low)
    ramp = ramp.clamp(0.0, 1.0)
    inv = extra / factor * ramp + extra * (1.0 - ramp)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] turned by the tables cos and sin [S, D//2] (f32) as
    eager f32 passes, cast back to x's dtype: split halves x1, x2 give
    x1·cos − x2·sin and x1·sin + x2·cos. By −sin it is the rotation's
    gradient (what :func:`rope_bwd` computes)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate channel halves (split-halves, not interleaved pairs); x is
    [B, S, H, D], freqs [S, D//2]: :func:`rope_rotate` by the angles'
    cos and sin."""
    return rope_rotate(x, torch.cos(freqs), torch.sin(freqs))


def check_rope_inputs(q: torch.Tensor, k: torch.Tensor, table: torch.Tensor) -> None:
    """What the rope kernel takes, whatever the device: q [B, S, H, D] and
    k [B, S, KV, D] of one dtype, bf16 or f32, D a multiple of 16 from 16
    to :data:`ROPE_MAX_WIDTH`, and an f32 table (the angles, or their cos
    or sin) of at least S rows of D/2. Raises TypeError or ValueError
    naming what is wrong."""
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype:
        raise TypeError("rope kernel: q and k must both be bfloat16 or float32, "
                        f"got {q.dtype} and {k.dtype}")
    if table.dtype != torch.float32:
        raise TypeError(f"rope kernel: the table must be float32, got {table.dtype}")
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError("rope kernel: q and k must be [B, S, heads, D] of one B, S "
                         f"and D, got {tuple(q.shape)} and {tuple(k.shape)}")
    S, D = q.shape[1], q.shape[3]
    if D % 16 or not 16 <= D <= ROPE_MAX_WIDTH:
        raise ValueError(
            f"rope kernel: head width {D} not compiled (takes multiples of 16 "
            f"from 16 to {ROPE_MAX_WIDTH}: 16, 32, 64 and 128 among them)"
        )
    if table.dim() != 2 or table.shape[1] != D // 2 or table.shape[0] < S:
        raise ValueError(f"rope kernel: the table must be [>= {S}, {D // 2}], "
                         f"got {tuple(table.shape)}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the rope kernel reads ``t`` in place: its last dimension
    contiguous, its base and every stride whole 16-byte words."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0
                    for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is where the rope kernel reads it in place (strided
    views such as DeepSeek's q_pe), else a contiguous copy (a fresh,
    aligned one: ``contiguous()`` keeps a contiguous view off a word)."""
    return t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _rope(q, k, cos, sin, backward: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The one place the kernel's inputs are checked, then one launch."""
    check_rope_inputs(q, k, cos)
    if sin.shape != cos.shape or sin.dtype != cos.dtype:
        raise ValueError(f"rope kernel: sin must match cos ({cos.dtype} "
                         f"{tuple(cos.shape)}), got {sin.dtype} {tuple(sin.shape)}")
    _check_devices("rope", q=q, k=k, cos=cos, sin=sin)
    for name, t in (("cos", cos), ("sin", sin)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rope kernel: {name} must be contiguous and 16-byte aligned")
    q, k = _rows(q), _rows(k)
    B, S, H, D = q.shape
    q_out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    k_out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    _launch("rope", q.device, q.data_ptr(), k.data_ptr(), q_out.data_ptr(),
            k_out.data_ptr(), cos.data_ptr(), sin.data_ptr(), B, S, H,
            k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
            int(q.dtype == torch.float32), int(backward),
            count="rope_bwd" if backward else "rope_fwd")
    return q_out, k_out


def rope_fwd(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, k) turned by cos and sin [>= S, D/2] f32 (row i at position i),
    contiguous, from one launch of kernel ``rope``; q and k on the card,
    checked by :func:`check_rope_inputs`, each read in place where
    :func:`_rows_aligned` (else from a contiguous copy, :func:`_rows`)."""
    return _rope(q, k, cos, sin, backward=False)


def rope_bwd(dq: torch.Tensor, dk: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of q and k from theirs after the rotation: one launch
    of kernel ``rope`` by −sin (:func:`rope_rotate`'s closed form)."""
    return _rope(dq, dk, cos, sin, backward=True)


class _Rope(torch.autograd.Function):
    """q and k turned in one launch; saves the cos/sin pair only (the
    rotation is linear, so its backward needs no input)."""

    @staticmethod
    def forward(ctx, q, k, freqs):
        table = freqs[:q.shape[1]]
        cos, sin = torch.cos(table), torch.sin(table)
        ctx.save_for_backward(cos, sin)
        return rope_fwd(q, k, cos, sin)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        return (*rope_bwd(dq, dk, cos, sin), None)


@traced("rope")
def rope_qk(q: torch.Tensor, k: torch.Tensor, freqs: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D] and k [B, S, KV, D] turned by the angles ``freqs``
    [>= S, D//2] (row i at position i): one launch of the rope kernel for
    both on the card (and one for both gradients), :func:`apply_rope` on
    each of them on the CPU."""
    if all(t.device.type == "cpu" for t in (q, k, freqs)):
        S = q.shape[1]
        return apply_rope(q, freqs[:S]), apply_rope(k, freqs[:S])
    return _Rope.apply(q, k, freqs)


@traced("cast")
def cast(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An f32 master weight in the compute ``dtype``, for one product."""
    return weight.to(dtype)
