"""Device ms a step in kernels that are neither products (cuBLAS,
CUTLASS), attention (the flash kernels and what the attention spans
launch) nor NCCL."""

PRODUCTS = ("matmul", "attention", "nccl")


def read(rec):
    trace = rec["trace"]
    if not trace or not trace["kernels"]:
        return None
    seconds = sum(s for cls, s in trace["by_class_s"].items() if cls not in PRODUCTS)
    return 1e3 * seconds / trace["steps"]
