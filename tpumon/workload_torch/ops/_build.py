"""Build and load the hand-written CUDA kernels of ``ops/csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/lib<name>.so`` under the
package, and loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds, not minutes). Every source is compiled in its own ``nvcc``
process and all of them start together.

The build happens at first use, never at import. A failed build raises:
nothing falls back to a plain version on the card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"

#: Kernel name -> ctypes argument types of its C entry (same name).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES: dict[str, list] = {
    # q, k, v, o, lse, B, H, KV, S, Sk, D, block_q, block_k, scale, causal,
    # window, sinks (null for none), stream
    "flash_fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _I, _P, _P],
    # q, k, v, dO, lse, delta, dq, B, H, KV, S, Sk, D, block_q, block_k,
    # scale, causal, window, stream
    "flash_dq": [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k, v, dO, lse, delta, dk, dv, B, H, KV, S, Sk, D, Dv, block_q,
    # block_k, scale, causal, window, stream (flash_dkv: Dv = D at 64 and
    # 128; flash_dkv_mla: D 192, Dv 128)
    "flash_dkv": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _P],
    "flash_dkv_mla": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _P],
    # x, w, y, rstd, rows, D, is_f32, eps, stream
    "rms_norm_fwd": [_P] * 4 + [_I] * 3 + [_F, _P],
    # x, dy, w, rstd, dx, part, dw, rows, D, is_f32, grid, stream
    "rms_norm_bwd": [_P] * 7 + [_I] * 4 + [_P],
    # q, k, q_out, k_out, cos, sin, B, S, Hq, Hk, D, q's and k's batch,
    # token and head strides, is_f32, negate, stream
    "rope": [_P] * 6 + [_I] * 5 + [_L] * 6 + [_I] * 2 + [_P],
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # loaded libraries, under _lock


def nvcc() -> str:
    """Path of the CUDA compiler, or a RuntimeError naming what is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the port's "
        "kernels are built from ops/csrc/*.cu on the machine with the card"
    )


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not out.exists():
        return True
    built = out.stat().st_mtime
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(d.stat().st_mtime > built for d in deps)


def build(names=tuple(SIGNATURES), timeout_s: float = 600.0) -> dict[str, dict]:
    """Compile every stale kernel of ``names``, one ``nvcc`` per source,
    all started together. Returns name -> {"seconds", "ptxas"} for the
    kernels it compiled (``ptxas`` is the register/shared-memory report).
    Raises RuntimeError with the compiler's output if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    report: dict[str, dict] = {}
    failures = []
    for name, (tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out after {timeout_s:.0f} s")
            continue
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
        report[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln for ln in out.splitlines()
                      if "ptxas" in ln or "spill" in ln],
        }
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
