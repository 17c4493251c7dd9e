"""Core ops of the workload model: RMSNorm, rotary embeddings and the
cast of an f32 master weight to the compute dtype.

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
"""

from __future__ import annotations

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

#: Kernel launches since the last :func:`reset_launches`, one count per
#: wrapper, raised only where the wrapper launches (``rms_norm_bwd``'s call
#: is two launches: the rows, then the column sums of dw).
launches: dict[str, int] = {"rms_norm_fwd": 0, "rms_norm_bwd": 0}


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


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` with its C entry's ``args`` and count it."""
    from tpumon.workload_torch.ops._build import load

    fn = getattr(load(name), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: error {err} (a cudaError_t, or 20001 for "
            "a row width no layout takes)"
        )
    launches[name] += 1


def _check_pointers(**named: torch.Tensor) -> None:
    """What the kernels' pointers need: every tensor on x's CUDA device,
    contiguous and 16-byte aligned."""
    device = named["x"].device
    for name, t in named.items():
        if device.type != "cuda" or t.device != device:
            raise ValueError(f"rms_norm kernel: {name} must be on x's CUDA "
                             f"device, got {t.device} (x on {device})")
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


@traced("rope")
def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate channel halves (split-halves, not interleaved pairs); x is
    [B, S, H, D], freqs [S, D//2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@traced("cast")
def cast(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An f32 master weight in the compute ``dtype``, for one product."""
    return weight.to(dtype)
