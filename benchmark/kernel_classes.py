"""Device kernels by class, from their names and the benchmark's spans.

Copied from ``chip_smoke.py``'s split and frozen here: the flash kernels
by their C++ symbols, cuBLAS/CUTLASS products (``nvjet``, ``gemm``,
``xmma``, ``cutlass``), NCCL, copies and fills, aten's elementwise,
reduction, softmax and foreach kernels, sorts and scans (cumsum). A kernel launched inside the benchmark's attention
spans (``bench.attn_fwd``, ``bench.attn_bwd``) is attention whatever its
name, so the backward's Δ pre-pass counts with the flash kernels.
Anything else is ``other``, and a traced run names it.
"""

from __future__ import annotations

#: The flash kernels' symbols as a trace names them.
FLASH_SYMBOLS = ("fwd::fwd_kernel", "dq::dq_kernel", "dkv::dkv_kernel")

#: The benchmark's spans around the port's attention core.
ATTN_SPANS = ("bench.attn_fwd", "bench.attn_bwd")

#: aten's elementwise, reduction, softmax, concatenation, indexing and
#: foreach (optimizer) kernels.
ELEMENTWISE = ("elementwise", "reduce_kernel", "multi_tensor_apply",
               "SoftMax", "softmax_warp", "CatArrayBatchedCopy",
               "indexing_backward", "index_elementwise", "scatter_gather")

#: CUB's sorts and scans and aten's scan kernels (cumsum).
SCAN = ("cub::", "_scan_")


def classify(name: str, span: str | None = None) -> str:
    """The class of kernel ``name``, launched inside benchmark span
    ``span`` (None: outside any)."""
    lower = name.lower()
    if span in ATTN_SPANS or any(s in name for s in FLASH_SYMBOLS):
        return "attention"
    if "nccl" in lower:
        return "nccl"
    if "nvjet" in name or "gemm" in lower or "xmma" in name or "cutlass" in lower:
        return "matmul"
    if lower.startswith(("memcpy", "memset")):
        return "memory"
    if any(s in name for s in ELEMENTWISE):
        return "elementwise"
    if any(s in name for s in SCAN):
        return "scan"
    return "other"
