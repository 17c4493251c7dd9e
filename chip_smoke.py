#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card, end to end.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases env,build,kernels --reps 3
    python3 chip_smoke.py --phases env,build,moe,checkpoint

Phases (any failure exits non-zero; no phase's exception is swallowed):

1. env        torch/CUDA versions, device name and capability, nvidia-smi's
              name and power limit, nvcc --version.
2. build      build every kernel of ops/csrc/*.cu (the three flash
              kernels and RMSNorm's pair) and print the build seconds and
              ptxas' register/shared-memory report for every
              instantiation (head dim x tile pair, dtype x row layout); fails on
              any spilled register, ignored setmaxnreg or serialized
              wgmma (ptxas' "(C7512)"/"(C7520)" lines) in any of them.
3. kernels    each kernel against its plain PyTorch version on the card,
              at the main path's attention shape (medium microbatch: B=2,
              S=4096, H=16, KV=4, D=128, causal), at the MoE path's (B=1,
              S=4096, H=8, KV=4, D=64, causal), at one mesh rank's (B=1,
              S=4096, H=8, KV=2, D=128, causal), at non-causal Sk != S and
              ragged D=64 cases, at a long causal case (S=16384) where
              the JAX package takes its streamed kernels, at the tile
              edges (S=4000, S=48, MHA), and at the ring path's zigzag
              stripes (B=2, S=Sk=1024, H=8, KV=2, D=128, non-causal and
              causal), at the dryrun's head_dim 32 (B=2, H=2, KV=1:
              S=32 causal, and S=Sk=8 non-causal), and at DeepSeek-V2's
              latent attention (four rows of the deepseek-v2-lite.s4096
              micro-batch: B=4, S=4096, H=KV=16, q·k width 192, v width
              128, causal; flash_dkv there is the one launch of
              flash_dkv_mla.cu on v and dO at 128, and its rows name the
              launch's tile_launches key and its share of the bound).
              --cases picks some of them. Every kernel runs at
              every tile pair it is compiled for (ops/flash_attention.py
              COMPILED: block_q, block_k in TILES = 64, 128), the chooser's
              default among them, each held to the plain version's
              outputs, computed once a case. Prints one JSON line per
              kernel, case and tile pair: errors beside their limits, the
              kernel's time (CUDA events, median), the bound (the least
              time for the same work at the card's peaks) and whether the
              pair is the default; the plain version's and the library
              call's times (where one computes the same function) ride
              on the default's line. Then one line per case naming each
              kernel's default and fastest pair, and one for the
              backward as a whole (default tiles) against SDPA's.
3b. norm      RMSNorm's kernel pair (ops/core.py rms_norm_fwd and
              rms_norm_bwd) against the plain version on the card at
              NORM_CASES (bf16): y within one bf16 ulp, dx relative L2
              <= 2e-3, dw <= 1e-5; one JSON line a case with each
              kernel's time (CUDA events, median), its byte bound at the
              card's peak, the plain chain's time (forward, and
              autograd's backward through it) and torch's rms_norm's
              (bf16 weight), which the port never calls.
4. main       tpumon.workload_torch.harness.main on the medium preset
              (--seq 4096 --batch 8 --grad-accum 4 --attn flash --remat
              --loss-chunk 1024 --steps 10 --phase-stats --serve) with the
              launch counters zeroed just before and read just after (they
              must equal the counts the run implies); the metrics page is
              scraped while the run is live and parsed with the lifecycle
              probe; losses must be finite.
5. moe        the same checks on the MoE path: --model moe --preset small
              --seq 4096 --batch 8 --grad-accum 8 --attn flash --remat
              --steps 10 --phase-stats --serve.
5b. deepseek  the same checks on DeepSeek-V2's path, twice: at its tiny
              preset (--seq 1024 --batch 8 --grad-accum 2: flash at a
              padded width, every expert held), then at the
              deepseek-v2-lite.s4096 cell's shape (--preset v2-lite-share
              --seq 4096 --batch 16, without --phase-stats, whose copy
              of the optimizer state does not fit: 27 layers, experts 0-7
              of 64 held);
              every flash call at the kernel width of the q·k width (64
              for the tiny 48, 192), and the dispatch's counter (models
              .moe.dropless_counts): one host read a MoE layer's pass,
              rows for the held experts only, every (token, choice) pair
              given to an expert where all are held, at most that many
              where a share is.
6. checkpoint the MoE argv with --checkpoint-dir (no --serve or
              --phase-stats): an uninterrupted 4-step run saving every 2
              steps; a 2-step run into a second directory, then a 4-step
              run there that resumes at step 2 (saving every step, so its
              live page shows a save before the run ends). The resumed
              losses must equal the uninterrupted run's at rel 1e-6 (the
              line also says whether they are bit for bit equal), and the
              resumed run's page must show the save and restore spans and
              a step counter that counts on from 2.
7. bench      tpumon.workload_torch.bench_attention.main at --batch 2
              --heads 16 --kv-heads 4 --head-dim 128 --seq 4096, then the
              same with --sweep-blocks (one row per distinct tile pair);
              prints their rows; fails if a flash row has an error.
8. profile    the main and the MoE argv for 3 steps each, without --serve
              and --phase-stats, with the timed steps under
              torch.profiler (CUDA activity): one JSON line per path with
              the 15 device kernels that take the most time per step, the
              three flash kernels' share of the step, and the device's
              idle share over the profiled steps (1 - union of
              device-activity intervals / wall time). It measures only; a
              failure in it fails the run.
9. mesh       the main argv at --dp 2 --tp 2 --zero1 (2 windows of 1 step,
              --phase-stats, --grad-norm, --hlo-raw-dump) through
              harness.main, which starts the four ranks itself (over gloo
              when they share a card, nccl when each has its own). Fails
              unless the backend is the rule's, every rank's losses are
              finite, the first step's loss and grad norm match the
              single-device step on the same weights and tokens on this
              card (|Δ| <= 5e-3, rel <= 0.02), each rank's launches and
              counted collectives equal what the run implies (the
              formula in collective_counters.py), and rank 0's page
              carries the collective families, a wait fraction in [0, 1]
              and dp=2, tp=2. Prints the window step, steps/s, tokens/s,
              MFU, each rank's peak memory and their sum,
              the collectives per op and step (rank 0's raw dump), the
              wait fraction and the wall time; MFU is over the distinct
              cards the ranks use.
10. ring      the dense argv without --loss-chunk (the reference refuses
              it with sp) at --tp 2 --sp 2 --sp-layout zigzag: the same
              run and checks as mesh (the single-device step also without
              --loss-chunk), with each rank's launches and counts from its
              own seq coordinate (parallel/ring.py), sp=2 on the page and
              the permutes (op="collective-permute") among its families.
11. expert    the MoE argv at --grad-accum 4 (a data rank's 4 rows, one a
              microbatch as on the moe path) with --dp 2 --ep 2: the
              expert banks split over expert, the experts' outputs summed
              by an all-reduce over expert (models/moe.py). The same run
              and checks as mesh, against the single-device MoE step at
              --grad-accum 4, with ep=2 on the page.
12. pipe      the dense argv without --grad-accum and --loss-chunk (the
              reference refuses both with pp) at --pp 2 --tp 2
              --interleave 2 --microbatches 8: the layers as a pipeline
              over two stages on the circular schedule (each stage holds
              2 chunks of 3 layers; 8 microbatches of one row, 17 ticks a
              step; parallel/pipeline.py), each stage body's attention on
              the flash kernels at the tp2 case's shape. The same run and
              checks as mesh, against the single-device step on the same
              batch without --loss-chunk, with the launches of 17 ticks ×
              3 layers a step, pp=2 on the page and the stage hops
              (op="collective-permute") among its families.
13. hosts     the mesh phase's argv as a job of two hosts on this machine:
              two harness processes with --coordinator 127.0.0.1:<free
              port> --num-processes 2 --process-id 0/1, each starting two
              of the four ranks (on this card, over gloo). Fails unless
              both exit 0 and log "process i/2, 2 local / 4 global",
              every rank's losses equal the mesh phase's at rel 1e-6 (the
              line says whether bit for bit), counts and launches are the
              formula's on every rank and rank 0's page parses. Prints
              the window step, tokens/s, wait fraction and each rank's
              peak memory.
14. dryrun    tpumon.workload_torch.entry.dryrun_multichip(8): eight ranks
              sharing the card over gloo run the reference's 13 cells
              (__graft_entry__.py), each held to the single-device dense
              step (|Δloss| <= 5e-3, grad-norm rel <= 0.02); one JSON line
              per cell with rank 0's flash launches, which must be
              non-zero in the four flash cells (head_dim 32, padded to 64)
              and zero elsewhere.
15. entry     entry()'s forward on the card (finite, [2, 32, 512]),
              probe_compiled_kernel() (validated, naming the card) and
              gpu_chip_count() (torch's count, "gpu").
16. drill     the dense argv with --serve in a harness process of its own,
              sent SIGTERM once its first window is on the page: the page
              must read tpu_step_terminating 1 within the grace window (3
              s) and the process must exit 143.

Every path phase (main, moe, checkpoint, mesh, ring, expert, pipe,
hosts, dryrun, entry, drill) also reports rank 0's flash launches by
tile pair (``tile_launches``).

Then it prints the nvidia-smi line, one {"kernels": [...]} JSON line (with
each kernel's compiled tile pairs) and, as the last line, {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_KERNEL = "tpumon/workload/ops/flash_attention.py"

#: Hopper kernel → (source, TPU kernels it replaces as file:line).
KERNELS = {
    "flash_fwd": (
        "tpumon/workload_torch/ops/csrc/flash_fwd.cu",
        [f"{REPO_KERNEL}:199", f"{REPO_KERNEL}:233"],
    ),
    "flash_dq": (
        "tpumon/workload_torch/ops/csrc/flash_dq.cu",
        [f"{REPO_KERNEL}:407", f"{REPO_KERNEL}:441"],
    ),
    "flash_dkv": (
        "tpumon/workload_torch/ops/csrc/flash_dkv.cu",
        [f"{REPO_KERNEL}:476"],
    ),
}

#: (name, B, S, Sk, H, KV, D, causal). "main" is the medium microbatch of
#: the main path, "moe" the moe-small microbatch of the MoE path and
#: "tp2" one rank's microbatch of the mesh path (medium at tp = 2);
#: "long" is in the range where the JAX package streams; "ragged4000",
#: "small48" and "mha" hit the tile edges of the wgmma kernels (64- and 128-row
#: q- and k-blocks, 64-row q tiles in dK/dV): S not a multiple of 128, S
#: below one tile, and MHA (KV = H). "zz" and "zzc" are one stripe pair of
#: the ring path (medium at tp=2×sp=2 zigzag, microbatch B=2: 1024-row
#: stripes): the full pairs of every hop and the causal self pairs. "d32"
#: is one rank's attention in the dryrun's flash cells (the tiny preset's
#: head_dim 32, which the wrappers pad to the compiled 64: a tp=2 rank at
#: seq 32) and "d32zz" a zigzag stripe pair there at sp=2. "mla" is one
#: micro-batch of the deepseek-v2-lite.s4096 cell's latent attention: q·k
#: width 192, v width 128 (its ninth entry; the others' v is as wide as
#: q), which flash_fwd and flash_dq pad to 192 and flash_dkv takes as it
#: is (``WIDTHS``).
CASES = [
    ("main", 2, 4096, 4096, 16, 4, 128, True),
    ("moe", 1, 4096, 4096, 8, 4, 64, True),
    ("tp2", 1, 4096, 4096, 8, 2, 128, True),
    ("rect", 1, 2000, 3000, 16, 4, 128, False),
    ("ragged64", 2, 1000, 1000, 8, 4, 64, True),
    ("long", 1, 16384, 16384, 4, 1, 128, True),
    ("ragged4000", 1, 4000, 4000, 16, 4, 128, True),
    ("small48", 2, 48, 48, 4, 2, 64, True),
    ("mha", 2, 2048, 2048, 8, 8, 128, True),
    ("zz", 2, 1024, 1024, 8, 2, 128, False),
    ("zzc", 2, 1024, 1024, 8, 2, 128, True),
    ("d32", 2, 32, 32, 2, 1, 32, True),
    ("d32zz", 2, 8, 8, 2, 1, 32, False),
    ("mla", 4, 4096, 4096, 16, 16, 192, True, 128),
]

#: Limits: O and lse max-abs; dQ/dK/dV relative L2 (bf16 wgmma products
#: with f32 accumulation against dense f32 math). O carries bf16 output
#: rounding (values near 1 round by up to 2^-8); lse is f32 throughout;
#: the gradients round P and dS to bf16 (about 2.6e-3 relative L2 on an
#: H100, so 1e-2 leaves a margin of ~4x).
LIMITS = {"o": 2e-2, "lse": 1e-4, "grad_rel_l2": 1e-2}

#: The model and shape of each path (the repo's on-chip configurations,
#: BASELINE.md), then the run: 10 steps after the warm-up, windows of 5
#: steps (two phase probes), and the serve page.
DENSE_TRAIN = [
    "--preset", "medium", "--seq", "4096", "--batch", "8",
    "--grad-accum", "4", "--attn", "flash", "--remat", "--loss-chunk", "1024",
]
MOE_TRAIN = [
    "--model", "moe", "--preset", "small", "--seq", "4096", "--batch", "8",
    "--grad-accum", "8", "--attn", "flash", "--remat",
]
STEPS, STATS_EVERY = 10, 5
RUN_ARGS = ["--steps", str(STEPS), "--stats-every", str(STATS_EVERY),
            "--phase-stats", "--serve"]
MAIN_ARGV = DENSE_TRAIN + RUN_ARGS
MOE_ARGV = MOE_TRAIN + RUN_ARGS
DEEPSEEK_TRAIN = [
    "--model", "deepseek_v2", "--preset", "tiny", "--seq", "1024", "--batch", "8",
    "--grad-accum", "2", "--attn", "flash", "--remat",
]
DEEPSEEK_ARGV = DEEPSEEK_TRAIN + RUN_ARGS
#: The deepseek-v2-lite.s4096 cell's model and micro-batch (16 × 1), with
#: no phase probe: the probe's copy of the AdamW state (22 GB) does not fit
#: beside the share's 44 GB of state and its activations.
DEEPSEEK_SHARE_ARGV = [
    "--model", "deepseek_v2", "--preset", "v2-lite-share", "--seq", "4096",
    "--batch", "16", "--attn", "flash", "--remat",
    *(a for a in RUN_ARGS if a != "--phase-stats"),
]

#: The mesh path: the dense train step at dp=2 × tp=2 with ZeRO-1, two
#: windows of one step (each with a phase probe), the grad norm every step
#: for the parity check, and the raw collective dump.
MESH_TRAIN = [*DENSE_TRAIN, "--dp", "2", "--tp", "2", "--zero1"]
MESH_STEPS, MESH_STATS_EVERY = 2, 1
MESH_ARGV = [*MESH_TRAIN, "--steps", str(MESH_STEPS), "--stats-every",
             str(MESH_STATS_EVERY), "--phase-stats", "--grad-norm"]
#: The ring path: the dense train step at tp=2 × sp=2 on the zigzag ring
#: (without --loss-chunk, which the reference refuses under sp), run and
#: checked as the mesh path.
RING_TRAIN = [*(a for a in DENSE_TRAIN if a not in ("--loss-chunk", "1024")),
              "--tp", "2", "--sp", "2", "--sp-layout", "zigzag"]
RING_ARGV = [*RING_TRAIN, "--steps", str(MESH_STEPS), "--stats-every",
             str(MESH_STATS_EVERY), "--phase-stats", "--grad-norm"]
#: The expert path: the MoE train step at dp=2 × ep=2, run and checked as
#: the mesh path; --grad-accum 4 so that each microbatch is one of a data
#: rank's 4 rows.
EXPERT_TRAIN = [*MOE_TRAIN[:MOE_TRAIN.index("--grad-accum")], "--grad-accum", "4",
                *MOE_TRAIN[MOE_TRAIN.index("--grad-accum") + 2:], "--dp", "2", "--ep", "2"]
EXPERT_ARGV = [*EXPERT_TRAIN, "--steps", str(MESH_STEPS), "--stats-every",
               str(MESH_STATS_EVERY), "--phase-stats", "--grad-norm"]
#: The pipeline path: the dense train step at pp=2 × tp=2 on the circular
#: schedule (2 chunks a stage, 8 microbatches of one row), without
#: --grad-accum and --loss-chunk (the reference refuses both with pp),
#: run and checked as the mesh path.
PIPE_TRAIN = [*(a for a in DENSE_TRAIN
                if a not in ("--grad-accum", "4", "--loss-chunk", "1024")),
              "--pp", "2", "--tp", "2", "--interleave", "2", "--microbatches", "8"]
PIPE_ARGV = [*PIPE_TRAIN, "--steps", str(MESH_STEPS), "--stats-every",
             str(MESH_STATS_EVERY), "--phase-stats", "--grad-norm"]
#: The dryrun's dense-parity tolerances (__graft_entry__.py).
PARITY = {"loss_abs": 5e-3, "grad_norm_rel": 0.02}

#: The hosts phase: the mesh argv as two hosts (processes) of two ranks;
#: seconds each host (and the drill's harness) gets.
HOSTS_TIMEOUT_S = 900
#: The dryrun phase: the reference's cells at n = 8, in its order, and the
#: cells whose attention runs on the flash kernels (head_dim 32).
DRYRUN_N = 8
DRYRUN_CELLS = ["1", "1b", "1c", "1d", "2", "2b", "2c", "2c-flash", "2d", "3",
                "4", "5", "6"]
DRYRUN_FLASH = {"1c", "1d", "2c-flash", "5"}
#: The drill: the dense argv with the serve page, run until SIGTERM; the
#: grace window it holds the flag up before exiting 143.
DRILL_ARGV = [*DENSE_TRAIN, "--steps", "1000", "--stats-every", str(STATS_EVERY),
              "--serve"]
DRILL_GRACE_S = 3.0

BENCH_ARGV = ["--batch", "2", "--heads", "16", "--kv-heads", "4",
              "--head-dim", "128", "--seq", "4096"]

#: Steps the profile phase traces (after the harness's warm-up step).
PROFILE_STEPS = 3

#: Each flash wrapper's device kernel, as its C++ name in ops/csrc appears
#: in a profiler trace.
KERNEL_SYMBOLS = {"flash_fwd": "fwd::fwd_kernel", "flash_dq": "dq::dq_kernel",
                  "flash_dkv": "dkv::dkv_kernel"}


def kernel_class(name: str) -> str:
    """The profile's coarse split of device time: the flash kernels,
    cuBLAS matrix products, aten's elementwise and reduction kernels."""
    if any(symbol in name for symbol in KERNEL_SYMBOLS.values()):
        return "flash"
    if "nvjet" in name or "gemm" in name.lower() or "xmma" in name:
        return "matmul"
    if "elementwise" in name or "reduce_kernel" in name:
        return "elementwise"
    return "other"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_env(torch) -> None:
    cap = torch.cuda.get_device_capability(0)
    print(
        f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {cap[0]}.{cap[1]} count {torch.cuda.device_count()}",
        flush=True,
    )
    if cap < (9, 0):
        fail(f"capability {cap} is below Hopper (9, 0)")
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    from tpumon.workload_torch.ops._build import nvcc

    out = subprocess.run(
        [nvcc(), "--version"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip().splitlines()
    print(f"nvcc: {out[-1] if out else '?'}", flush=True)


def instantiation(mangled: str) -> str:
    """``kernel<args>`` from a mangled entry name in ptxas' report, e.g.
    ``_ZN3fwd10fwd_kernelILi128ELi64ELi128EEEv...`` → ``fwd_kernel<128,
    64, 128>`` (D, then the tile pair; flash_dkv: D, part, k rows, q
    rows; flash_dkv_mla: q·k width, v width, k rows, q rows)."""
    match = re.search(r"([A-Za-z_]+_kernel(?:_[a-z]+)?)I((?:Li\d+E)+)E", mangled)
    if not match:
        return mangled
    args = re.findall(r"Li(\d+)E", match.group(2))
    return f"{match.group(1)}<{', '.join(args)}>"


def phase_build() -> dict:
    """Build every kernel and fail if ptxas reports spilled registers in
    any instantiation, ignored a setmaxnreg or serialized a wgmma. Prints
    each instantiation's report; returns the build seconds and the
    instantiations."""
    from tpumon.workload_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.2f} s ({len(report)} compiled)", flush=True)
    bad, seen = [], []
    for name, info in report.items():
        print(f"build: {name} {info['seconds']:.2f} s", flush=True)
        entry = name
        for line in info["ptxas"]:
            print(f"  {line.strip()}", flush=True)
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = instantiation(found.group(1))
                seen.append(entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and (int(spill.group(1)) or int(spill.group(2))):
                bad.append(f"{entry}: {line.strip()}")
            # "(C7512) ... wgmma.mma_async instructions are serialized"
            # (or C7520, the same loss from another cause): a wgmma kernel
            # lost its pipelining.
            if any(s in line for s in ("setmaxnreg ignored", "(C7512)",
                                       "instructions are serialized")):
                bad.append(f"{entry}: {line.strip()}")
    emit({"phase": "build", "seconds": seconds, "instantiations": seen})
    if bad:
        fail("ptxas: " + "; ".join(bad))
    return {"seconds": seconds, "instantiations": seen}


def time_samples(torch, fn, reps: int) -> list[float]:
    """Milliseconds of ``fn`` in each of ``reps`` runs, each between two
    CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs
    (:func:`time_samples`)."""
    return statistics.median(time_samples(torch, fn, reps))


def library_time(torch, fn, reps: int) -> float | None:
    """:func:`time_ms` of a library call, or None where the library
    refuses the shape (SDPA at a v width below the q·k width, on some
    backends)."""
    try:
        return time_ms(torch, fn, reps)
    except RuntimeError as exc:
        print(f"library call refused: {str(exc).splitlines()[0][:200]}", flush=True)
        return None


def bound(B, S, Sk, H, KV, D, causal, kernel, peak_flops, peak_bytes, Dv=None):
    """(bound_ms, bound_by): the larger of the products' operations at
    the bf16 tensor peak and the bytes the function must move (each input
    read once, each output written once) at the HBM rate, at the true
    widths (q, k, dQ, dK at D; v, O, dO, dV at Dv). Under causal only the
    live (q, k) pairs of this input count."""
    Dv = D if Dv is None else Dv
    pairs = S * (S + 1) // 2 if causal else S * Sk
    q_bytes, k_bytes, row_bytes = B * S * H * D * 2, B * Sk * KV * D * 2, B * H * S * 4
    o_bytes, v_bytes = B * S * H * Dv * 2, B * Sk * KV * Dv * 2
    if kernel == "flash_fwd":  # S = qKᵀ, O = PV
        ops = 2 * B * H * pairs * (D + Dv)
        moved = q_bytes + k_bytes + v_bytes + o_bytes + row_bytes
    elif kernel == "flash_dq":  # S, dP = dO Vᵀ, dQ = dS K
        ops = 2 * B * H * pairs * (2 * D + Dv)
        moved = 2 * q_bytes + k_bytes + v_bytes + o_bytes + 2 * row_bytes
    else:  # S, dP, dV = Pᵀ dO, dK = dSᵀ Q
        ops = 2 * B * H * pairs * (2 * D + 2 * Dv)
        moved = q_bytes + o_bytes + 2 * k_bytes + 2 * v_bytes + 2 * row_bytes
    t_ops, t_bytes = ops / peak_flops * 1e3, moved / peak_bytes * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tile_requests(fa, name: str, shape: tuple) -> dict:
    """Kernel ``name``'s distinct effective tiles at ``shape`` (B, S, Sk,
    H, KV, D, causal) → the first (block_q, block_k) request over
    ``fa.TILES``² that runs them: every tile pair the kernel is compiled
    for at this width, the chooser's default among them."""
    B, S, Sk, H, KV, D, causal = shape
    out: dict = {}
    for bq in fa.TILES:
        for bk in fa.TILES:
            eff = fa.effective_blocks(B, H, KV, S, Sk, D, causal, bq, bk)[name]
            out.setdefault(eff, (bq, bk))
    return out


def phase_kernels(torch, reps: int, seed: int, cases=None) -> dict:
    import torch.nn.functional as F

    from tpumon.workload_torch import flops
    from tpumon.workload_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    peak_flops = flops.peak_flops_per_device(dev)
    peak_bytes = flops.peak_hbm_bytes_per_device(dev)
    if peak_flops is None or peak_bytes is None:
        fail(f"no published peaks for {torch.cuda.get_device_name(0)!r} "
             "in tpumon/workload_torch/flops.py")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results: dict = {}
    failed = []
    for case, B, S, Sk, H, KV, D, causal, *v_width in CASES:
        if cases is not None and case not in cases:
            continue
        Dv = v_width[0] if v_width else D

        def randn(*shape):
            return torch.randn(
                shape, generator=gen, device=dev, dtype=torch.float32
            ).to(torch.bfloat16)

        q, k, v, do = randn(B, S, H, D), randn(B, Sk, KV, D), randn(B, Sk, KV, Dv), randn(B, S, H, Dv)
        shape = {"B": B, "S": S, "Sk": Sk, "H": H, "KV": KV, "D": D,
                 "Dv": Dv, "causal": causal}
        default = fa.effective_blocks(B, H, KV, S, Sk, D, causal)

        # The plain outputs, once a case. Each backward kernel gets the
        # same inputs as its plain version: the plain forward's lse and Δ,
        # so its error is its own.
        ref_o, ref_lse = fa.flash_fwd_reference(q, k, v, causal)
        delta = fa.flash_delta(ref_o, do)
        ref_dq = fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal)
        ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal)
        torch.cuda.synchronize()

        def rel_l2(a, b):
            b = b.float()
            return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()

        def max_abs(a, b):
            return (a.float() - b.float()).abs().max().item()

        def errors(name, tiles):
            """(errors, limits, worst max-abs) of one kernel at ``tiles``."""
            if name == "flash_fwd":
                o, lse = fa.flash_fwd(q, k, v, causal, **tiles)
                err_o, err_lse = max_abs(o, ref_o), (lse - ref_lse).abs().max().item()
                return ({"o_max_abs": err_o, "lse_max_abs": err_lse},
                        {"o_max_abs": LIMITS["o"], "lse_max_abs": LIMITS["lse"]},
                        max(err_o, err_lse))
            if name == "flash_dq":
                dq = fa.flash_dq(q, k, v, do, ref_lse, delta, causal, **tiles)
                return ({"dq_rel_l2": rel_l2(dq, ref_dq)},
                        {"dq_rel_l2": LIMITS["grad_rel_l2"]}, max_abs(dq, ref_dq))
            dk, dv = fa.flash_dkv(q, k, v, do, ref_lse, delta, causal, **tiles)
            return ({"dk_rel_l2": rel_l2(dk, ref_dk), "dv_rel_l2": rel_l2(dv, ref_dv)},
                    {"dk_rel_l2": LIMITS["grad_rel_l2"],
                     "dv_rel_l2": LIMITS["grad_rel_l2"]},
                    max(max_abs(dk, ref_dk), max_abs(dv, ref_dv)))

        calls = {
            "flash_fwd": (lambda t: fa.flash_fwd(q, k, v, causal, **t),
                          lambda: fa.flash_fwd_reference(q, k, v, causal)),
            "flash_dq": (lambda t: fa.flash_dq(q, k, v, do, ref_lse, delta, causal, **t),
                         lambda: fa.flash_dq_reference(q, k, v, do, ref_lse, delta, causal)),
            "flash_dkv": (lambda t: fa.flash_dkv(q, k, v, do, ref_lse, delta, causal, **t),
                          lambda: fa.flash_dkv_reference(q, k, v, do, ref_lse, delta, causal)),
        }
        # Library yardstick for the forward: SDPA on the same inputs in
        # its [B, H, S, D] layout, K/V expanded to H heads outside the
        # timed region. No single library call computes dQ or dK/dV alone.
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        library = {"flash_fwd": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)}
        summary = {}
        for name in KERNELS:
            kernel_fn, plain_fn = calls[name]
            plain_ms = time_ms(torch, plain_fn, reps)
            lib = library.get(name)
            library_ms = library_time(torch, lib, reps) if lib else None
            bound_ms, bound_by = bound(B, S, Sk, H, KV, D, causal, name,
                                       peak_flops, peak_bytes, Dv)
            by_tiles = {}
            for eff, (bq, bk) in tile_requests(fa, name, (B, S, Sk, H, KV, D, causal)).items():
                tiles = {"block_q": bq, "block_k": bk}
                fa.reset_launches()
                got, limit, worst_abs = errors(name, tiles)
                launch_key = next(iter(fa.tile_launches), None)
                samples = time_samples(torch, lambda: kernel_fn(tiles), reps)
                ms = statistics.median(samples)
                ok = all(got[key] <= limit[key] for key in got)
                if not ok:
                    failed.append(f"{name}@{case}[{eff[0]}x{eff[1]}]: {got} over {limit}")
                is_default = eff == default[name]
                row = {
                    "case": case, "kernel": name, "shape": shape,
                    "tiles": list(eff), "requested": [bq, bk],
                    "default": is_default, "err": got, "limit": limit,
                    "max_abs_err": worst_abs, "passed": ok, "ms": ms,
                    "ms_min": min(samples), "ms_max": max(samples),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / ms, "launch_key": launch_key,
                    "reps": reps,
                }
                if is_default:
                    row.update(plain_ms=plain_ms, library_ms=library_ms)
                emit(row)
                by_tiles[eff] = row
            if default[name] not in by_tiles:
                fail(f"{name}@{case}: the default tiles {default[name]} are "
                     f"not among the compiled ones {sorted(by_tiles)}")
            fastest = min(by_tiles, key=lambda eff: by_tiles[eff]["ms"])
            row = dict(by_tiles[default[name]])
            row["tile_ms"] = {f"{a}x{b}": r["ms"] for (a, b), r in by_tiles.items()}
            row["passed"] = all(r["passed"] for r in by_tiles.values())
            results.setdefault(name, {})[case] = row
            # Within the spread: the default's fastest run is no slower
            # than the fastest pair's slowest.
            summary[name] = {
                "default": list(default[name]), "default_ms": row["ms"],
                "fastest": list(fastest), "fastest_ms": by_tiles[fastest]["ms"],
                "default_over_fastest": row["ms"] / by_tiles[fastest]["ms"],
                "within_spread": row["ms_min"] <= by_tiles[fastest]["ms_max"],
            }
        emit({"case": case, "tile_choice": summary})

        # The backward as a whole at the default tiles: the Δ pre-pass,
        # flash_dq and flash_dkv, beside the library's backward (SDPA
        # forward + backward minus its forward, on the K/V expanded to H
        # heads). No single library call computes dQ or dK/dV alone, so
        # the kernels' rows keep null.
        o, lse = fa.flash_fwd(q, k, v, causal)

        def backward():
            d = fa.flash_delta(o, do)
            fa.flash_dq(q, k, v, do, lse, d, causal)
            fa.flash_dkv(q, k, v, do, lse, d, causal)

        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        dot = do.transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(out, (qg, kg, vg), dot)

        bwd_ms = time_ms(torch, backward, reps)
        fwd_bwd_ms = library_time(torch, sdpa_fwd_bwd, reps)
        sdpa_fwd_ms = results["flash_fwd"][case]["library_ms"]
        emit({"case": case, "backward": {
            "ms": bwd_ms,
            "library_ms": (None if fwd_bwd_ms is None or sdpa_fwd_ms is None
                           else fwd_bwd_ms - sdpa_fwd_ms),
            "sdpa_fwd_bwd_ms": fwd_bwd_ms, "sdpa_fwd_ms": sdpa_fwd_ms,
            "kernels": ["delta (torch)", "flash_dq", "flash_dkv"],
            "tiles": {name: list(default[name]) for name in KERNELS}},
            "reps": reps})
        del qg, kg, vg, dot
        del q, k, v, do, o, lse, ref_o, ref_lse, delta, ref_dq
        del ref_dk, ref_dv, qt, kt, vt
        torch.cuda.empty_cache()
    if failed:
        fail("kernels disagree with their plain versions: " + "; ".join(failed))
    return results


#: (name, rows, D) of RMSNorm calls: a micro-batch of the dense cells
#: (65,536 tokens of Mistral's 4096), of Mixtral's cell (16,384 tokens),
#: and of the main path (the medium preset's 2 x 4096 tokens of 2048).
NORM_CASES = [("dense", 65536, 4096), ("mixtral", 16384, 4096),
              ("main", 8192, 2048)]


def phase_norm(torch, reps: int, seed: int) -> None:
    from tpumon.workload_torch import flops
    from tpumon.workload_torch.ops import core

    dev = torch.device("cuda", 0)
    peak_bytes = flops.peak_hbm_bytes_per_device(dev)
    if peak_bytes is None:
        fail(f"no published peak for {torch.cuda.get_device_name(0)!r}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    failed = []
    for case, rows, D in NORM_CASES:
        x = torch.randn(rows, D, generator=gen, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
        dy = torch.randn(rows, D, generator=gen, device=dev).to(torch.bfloat16)
        y, rstd = core.rms_norm_fwd(x, w, 1e-5)
        dx, dw = core.rms_norm_bwd(x, w, rstd, dy)
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        yp, _ = core.rms_norm_reference(xp, wp)
        dxp, dwp = torch.autograd.grad(yp, (xp, wp), dy, retain_graph=True)
        ulps = ((y.float() - yp.float()).abs()
                / (2 ** -7 * yp.float().abs()).clamp_min(1e-30)).max().item()
        errors = {"y_max_ulps": ulps,
                  "dx_rel_l2": ((dx.float() - dxp.float()).norm() / dxp.float().norm()).item(),
                  "dw_rel_l2": ((dw - dwp).norm() / dwp.norm()).item()}
        limits = {"y_max_ulps": 1.0, "dx_rel_l2": 2e-3, "dw_rel_l2": 1e-5}
        passed = all(errors[k] <= limits[k] for k in limits)
        if not passed:
            failed.append(f"{case}: {errors}")
        # The library call for the same function (the port never calls
        # it): torch's rms_norm, whose weight has x's dtype.
        wl = w.to(x.dtype).requires_grad_()
        yl = torch.nn.functional.rms_norm(xp, (D,), wl, 1e-5)
        emit({
            "phase": "norm", "case": case, "rows": rows, "D": D, "dtype": "bf16",
            "errors": errors, "limits": limits, "passed": passed,
            "fwd_ms": time_ms(torch, lambda: core.rms_norm_fwd(x, w, 1e-5), reps),
            "bwd_ms": time_ms(torch, lambda: core.rms_norm_bwd(x, w, rstd, dy), reps),
            "plain_fwd_ms": time_ms(torch, lambda: core.rms_norm_reference(x, w), reps),
            "plain_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
                yp, (xp, wp), dy, retain_graph=True), reps),
            "library_fwd_ms": time_ms(torch, lambda: torch.nn.functional.rms_norm(
                x, (D,), wl, 1e-5), reps),
            "library_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
                yl, (xp, wl), dy, retain_graph=True), reps),
            # bytes: x read and y written; x and dy read and dx written
            "fwd_bound_ms": 1e3 * 2 * rows * D * 2 / peak_bytes,
            "bwd_bound_ms": 1e3 * 3 * rows * D * 2 / peak_bytes,
            "reps": reps,
        })
        del x, w, dy, y, rstd, dx, dw, xp, wp, yp, dxp, dwp, wl, yl
        torch.cuda.empty_cache()
    if failed:
        fail("RMSNorm kernels disagree with the plain version: " + "; ".join(failed))


class _LossRecords(logging.Handler):
    """Collects the harness's final log record, whose args carry the
    first and last losses and the steps/s."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("loss "):
            self.records.append(record)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Scraper:
    """Scrapes the harness's page on a free port every 0.5 s while the
    ``with`` block runs, keeping each page that holds ``want``."""

    def __init__(self, want: str) -> None:
        self.port = _free_port()
        self.want = want
        self.pages: list[str] = []
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="chip-smoke-scrape", daemon=True)

    def _loop(self) -> None:
        url = f"http://127.0.0.1:{self.port}/metrics"
        while not self._done.is_set():
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    text = resp.read().decode()
                if self.want in text:
                    self.pages.append(text)
            except OSError:
                pass  # the server is not up yet, or already closed
            self._done.wait(0.5)

    def __enter__(self) -> "_Scraper":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join(timeout=30)

    def snapshots(self) -> list[dict]:
        from tpumon.lifecycle.probe import step_snapshot_from_text

        return [step_snapshot_from_text(p) for p in self.pages]


@contextlib.contextmanager
def _capture_runs(harness):
    """Collects the RunResult of every harness.run that harness.main makes
    inside the ``with`` block."""
    run, results = harness.run, []

    def recording_run(*args, **kwargs):
        results.append(run(*args, **kwargs))
        return results[-1]

    harness.run = recording_run
    try:
        yield results
    finally:
        harness.run = run


def _release(torch) -> None:
    """Free what a finished phase left in the caching allocator."""
    gc.collect()
    torch.cuda.empty_cache()


def expected_launches(n_layers: int, grad_accum: int, steps: int = STEPS,
                      stats_every: int = STATS_EVERY, calls: int = 1,
                      probes: bool = True) -> dict:
    """The launches a path's run implies (on each rank of a mesh, where
    ``grad_accum`` microbatches split the rank's rows): each layer's
    attention makes ``calls`` flash calls (one off the ring; on the ring,
    ``ring.flash_calls_per_layer`` of the rank), each of which runs the
    forward twice under --remat (the pass and its recompute) and each
    backward kernel once, per microbatch; ``steps`` + 1 steps (the
    warm-up and the timed ones) of ``grad_accum`` microbatches, plus one
    phase probe a window on one microbatch (a forward, then a forward and
    backward) where ``probes``."""
    probes, L = steps // stats_every if probes else 0, n_layers * calls
    steps += 1
    bwd = steps * grad_accum * L + probes * L
    return {"flash_fwd": steps * grad_accum * 2 * L + probes * 3 * L,
            "flash_dq": bwd, "flash_dkv": bwd}


def drive_path(torch, name: str, argv: list[str]) -> dict:
    """harness.main on one path with the launch counters zeroed just
    before and read just after; the live page is scraped and parsed with
    the lifecycle probe, the losses must be finite, and the counts must be
    the ones the run implies. The model, batch, seq and grad_accum are the
    ones ``argv`` names, read through the harness's own parser."""
    from tpumon.workload_torch import flops, harness
    from tpumon.workload_torch.models import moe
    from tpumon.workload_torch.ops import flash_attention as fa

    args = harness.build_parser().parse_args(argv)
    cfg, grad_accum = harness.model_config(args), args.grad_accum
    batch, seq = args.batch, args.seq
    records = _LossRecords()
    log = logging.getLogger("tpumon.workload_torch.harness")
    log.addHandler(records)
    # The width each kernel call runs at: its inputs' check sees them padded.
    widths: dict[int, int] = {}
    check_inputs = fa._check_kernel_inputs

    def counting_check(named, *args):
        check_inputs(named, *args)
        D = named["q"].shape[3]
        widths[D] = widths.get(D, 0) + 1

    _release(torch)
    with _Scraper("tpu_step_duration_seconds") as scraper:
        argv = [*argv, "--metrics-port", str(scraper.port)]
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        moe.reset_dropless_counts()
        fa._check_kernel_inputs = counting_check
        t0 = time.perf_counter()
        try:
            rc = harness.main(argv)
        finally:
            wall = time.perf_counter() - t0
            fa._check_kernel_inputs = check_inputs
            counts = dict(fa.launches)
            tile_counts = dict(fa.tile_launches)
            dropless = dict(moe.dropless_counts)
            log.removeHandler(records)
    peak_mem = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"{name}: harness.main returned {rc}")
    if not records.records:
        fail(f"{name}: harness.main logged no final loss line")
    rec = records.records[-1]
    first, last, steps_per_sec = rec.args[0], rec.args[1], rec.args[2]
    if not all(math.isfinite(x) for x in (first, last)):
        fail(f"{name}: non-finite loss: {first} -> {last}")
    if not scraper.pages:
        fail(f"{name}: never scraped a page with tpu_step_* from the live run")
    snaps = scraper.snapshots()
    snap = snaps[-1]
    # tpu_step_* (counter, duration, terminating, phases) and tpu_serve_*
    # (rate, queue, batch, TTFT, SLO) as the lifecycle plane reads them.
    probes = "--phase-stats" in argv
    missing = [key for key in (
        "step", "step_seconds", "terminating", *(("phases",) if probes else ()),
        "loss", "serve_requests_per_second", "serve_queue_depth",
        "serve_batch_size", "serve_ttft_seconds", "serve_slo_attainment_ratio",
    ) if key not in snap]
    if missing:
        fail(f"{name}: snapshot keys missing from the scraped page: {missing}")
    window_losses = sorted({(s["step"], s["loss"]) for s in snaps if "loss" in s})
    if not all(math.isfinite(loss) for _, loss in window_losses):
        fail(f"{name}: non-finite window loss on the page: {window_losses}")
    idle = [kernel for kernel, n in counts.items() if n <= 0]
    if idle:
        fail(f"{name}: kernels never launched on the path: {idle}")
    expected = expected_launches(cfg.n_layers, grad_accum, probes=probes)
    if counts != expected:
        fail(f"{name}: launch counts {counts} differ from the expected {expected}")
    by_kernel = {kernel: sum(n for key, n in tile_counts.items()
                             if key.startswith(f"{kernel}["))
                 for kernel in counts}
    if by_kernel != counts:
        fail(f"{name}: launches by tiles {tile_counts} do not add up to {counts}")
    if hasattr(cfg, "n_moe_layers"):
        width = fa.kernel_width(cfg.qk_head_dim)
        if widths != {width: sum(counts.values())}:
            fail(f"{name}: flash calls by width {widths}, not all "
                 f"{sum(counts.values())} at {width}")
        # A MoE layer's pass reads the counts once, as a layer's pass
        # launches flash_fwd once; each read covers a micro-batch's pairs,
        # all of them when every expert is held.
        reads = expected["flash_fwd"] // cfg.n_layers * cfg.n_moe_layers
        pairs = reads * batch // grad_accum * seq * cfg.top_k
        held = list(range(cfg.expert_start, cfg.expert_start + cfg.held))
        given = sum(dropless["rows"].values())
        if (dropless["host_reads"] != reads or sorted(dropless["rows"]) != held
                or not 0 < given <= pairs
                or (cfg.held == cfg.n_routed_experts and given != pairs)):
            fail(f"{name}: dropless counts {dropless} differ from {reads} host "
                 f"reads and rows for experts {held[0]}-{held[-1]} "
                 f"({pairs} pairs)")
    L = cfg.n_layers
    result = {
        "phase": name, "argv": argv, "loss_first": first, "loss_last": last,
        "window_losses": window_losses, "steps_per_sec": steps_per_sec,
        "tokens_per_sec": steps_per_sec * batch * seq,
        "model_flops_per_step": flops.train_flops_per_step(cfg, batch, seq),
        "mfu": flops.mfu(cfg, batch, seq, steps_per_sec, torch.device("cuda", 0)),
        "max_memory_allocated": peak_mem, "launches": counts,
        "tile_launches": tile_counts, "launches_expected": expected,
        "launches_per_step": {"flash_fwd": grad_accum * 2 * L,
                              "flash_dq": grad_accum * L,
                              "flash_dkv": grad_accum * L},
        "wall_s": wall, "snapshot": snap, "dropless_counts": dropless,
        "flash_calls_by_width": widths,
    }
    emit(result)
    return result


def phase_main(torch) -> dict:
    return drive_path(torch, "main", MAIN_ARGV)


def phase_moe(torch) -> dict:
    return drive_path(torch, "moe", MOE_ARGV)


def phase_deepseek(torch) -> list[dict]:
    return [drive_path(torch, "deepseek", DEEPSEEK_ARGV),
            drive_path(torch, "deepseek-share", DEEPSEEK_SHARE_ARGV)]


def phase_checkpoint(torch) -> dict:
    """Stop and resume the MoE path; see the module docstring."""
    from tpumon.workload_torch import harness
    from tpumon.workload_torch.checkpoint import STATE_FILE, CheckpointStore
    from tpumon.workload_torch.ops import flash_attention as fa

    def argv(steps: int, every: int, directory: str) -> list[str]:
        return [*MOE_TRAIN, "--steps", str(steps), "--checkpoint-every",
                str(every), "--checkpoint-dir", directory]

    _release(torch)
    # Inside the checkout (the checkpoints are ~1.8 GB a step at
    # moe-small), and removed when the phase ends.
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_ckpt_") as tmp:
        full_dir, resume_dir = os.path.join(tmp, "full"), os.path.join(tmp, "resume")
        t0 = time.perf_counter()
        fa.reset_launches()
        with _capture_runs(harness) as runs:
            if harness.main(argv(4, 2, full_dir)) != 0:
                fail("checkpoint: the uninterrupted run failed")
            state_bytes = os.path.getsize(os.path.join(full_dir, "4", STATE_FILE))
            shutil.rmtree(full_dir)  # only its losses are needed
            if harness.main(argv(2, 2, resume_dir)) != 0:
                fail("checkpoint: the 2-step run failed")
            with _Scraper("tpu_step_counter") as scraper:
                rc = harness.main([*argv(4, 1, resume_dir),
                                   "--metrics-port", str(scraper.port)])
            if rc != 0:
                fail("checkpoint: the resumed run failed")
        kept = CheckpointStore(resume_dir).steps()
        wall = time.perf_counter() - t0
        tile_counts = dict(fa.tile_launches)
    full, part, cont = runs
    if full.start_step != 0 or len(full.losses) != 4:
        fail(f"checkpoint: uninterrupted run {full.start_step} / {full.losses}")
    if not all(math.isfinite(x) for x in full.losses):
        fail(f"checkpoint: non-finite loss {full.losses}")

    def same(a: list, b: list) -> bool:
        return len(a) == len(b) and all(
            math.isclose(x, y, rel_tol=1e-6) for x, y in zip(a, b))

    if not same(part.losses, full.losses[:2]):
        fail(f"checkpoint: 2-step run {part.losses} != {full.losses[:2]}")
    if cont.start_step != 2 or not same(cont.losses, full.losses[2:]):
        fail(f"checkpoint: resumed at {cont.start_step} with {cont.losses}, "
             f"the uninterrupted run had {full.losses[2:]}")
    if kept != [3, 4]:
        fail(f"checkpoint: kept steps {kept}, not the 2 newest [3, 4]")
    # Pages scraped after the restore: their step counter must count on
    # from the restored step 2 (3, 4), not restart at 0.
    restored = [s for s in scraper.snapshots()
                if "restore" in s.get("checkpoints", {})]
    spans = [s for s in restored if "save" in s["checkpoints"]]
    if not spans:
        fail("checkpoint: no live page of the resumed run showed both "
             "the save and the restore span")
    steps_seen = sorted({int(s["step"]) for s in restored})
    if steps_seen[0] < 2 or steps_seen[-1] <= 2:
        fail(f"checkpoint: after the restore the page's step counter read "
             f"{steps_seen}, not steps counting on from 2")
    result = {
        "phase": "checkpoint", "argv": argv(4, 2, "<dir>"),
        "losses": full.losses, "part_losses": part.losses,
        "resumed_losses": cont.losses, "start_step": cont.start_step,
        "bitwise_equal": cont.losses == full.losses[2:]
        and part.losses == full.losses[:2],
        "steps_on_page": steps_seen, "checkpoints": spans[-1]["checkpoints"],
        "state_bytes": state_bytes, "kept_steps": kept,
        "steps_per_sec": {"full": full.steps_per_sec, "resumed": cont.steps_per_sec},
        "tile_launches": tile_counts, "wall_s": wall,
    }
    emit(result)
    return result


def phase_bench(torch) -> list[dict]:
    """The attention bench at ``main``'s shape, then its tiling sweep
    there (``--sweep-blocks``: a row per distinct tile pair)."""
    from tpumon.workload_torch import bench_attention

    rows = []
    for argv in (BENCH_ARGV, [*BENCH_ARGV, "--sweep-blocks"]):
        _release(torch)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench_attention.main(argv)
        if rc != 0:
            fail(f"bench: bench_attention.main({argv}) returned {rc}")
        got = [json.loads(line) for line in out.getvalue().splitlines()]
        for row in got:
            emit({"phase": "bench", "argv": argv, **row})
        flash = [r for r in got if r["impl"] == "flash"]
        if not flash or any("error" in r for r in flash):
            fail(f"bench: a flash row failed: {flash}")
        rows += got
    return rows


def profile_summary(spans, wall_s: float, steps: int, top: int = 15) -> dict:
    """Per-step breakdown of a trace. ``spans`` are (name, start_us, end_us)
    of every device activity in ``steps`` steps that took ``wall_s`` on the
    host's clock; the idle share is 1 - (union of the spans / wall)."""
    per_name: dict[str, list] = {}
    busy_us, run_start, run_end = 0.0, None, None
    for name, start, end in sorted(spans, key=lambda s: s[1]):
        entry = per_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += end - start
        if run_end is None or start > run_end:
            if run_end is not None:
                busy_us += run_end - run_start
            run_start, run_end = start, end
        else:
            run_end = max(run_end, end)
    if run_end is not None:
        busy_us += run_end - run_start
    step_ms = wall_s * 1e3 / steps
    flash_ms = {
        kernel: sum(t for name, (_, t) in per_name.items() if symbol in name)
        / 1e3 / steps
        for kernel, symbol in KERNEL_SYMBOLS.items()
    }
    by_class: dict[str, float] = {}
    for name, (_, t) in per_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + t / 1e3 / steps
    ranked = sorted(per_name.items(), key=lambda item: -item[1][1])[:top]
    return {
        "steps": steps, "step_ms": step_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "ms_per_step_by_class": by_class,
        "top_kernels": [{"name": name[:200], "calls_per_step": calls / steps,
                         "ms_per_step": t / 1e3 / steps}
                        for name, (calls, t) in ranked],
        "flash_ms_per_step": flash_ms,
        "flash_share_of_step": sum(flash_ms.values()) / step_ms,
    }


def phase_profile(torch, path: str, train_argv: list[str]) -> dict:
    """Trace the timed steps of one path's argv (3 steps, no serve page,
    no phase probe). The trace brackets the timed steps: the train step
    the harness builds is wrapped to synchronise and start the profiler
    before the first timed step, and to synchronise and stop it after the
    last; the steps themselves run unchanged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumon.workload_torch import harness

    _release(torch)
    argv = [*train_argv, "--steps", str(PROFILE_STEPS)]
    prof = profile(activities=[ProfilerActivity.CUDA])
    make_train_step = harness.make_train_step
    calls = 0
    window: dict[str, float] = {}

    def traced_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def traced_step(tokens):
            nonlocal calls
            calls += 1
            if calls == 2:  # the first step after the warm-up
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            out = step(tokens)
            if calls == 1 + PROFILE_STEPS:
                torch.cuda.synchronize()
                window["t1"] = time.perf_counter()
                prof.stop()
            return out

        return traced_step

    harness.make_train_step = traced_make_train_step
    try:
        rc = harness.main(argv)
    finally:
        harness.make_train_step = make_train_step
    if rc != 0:
        fail(f"profile {path}: harness.main returned {rc}")
    if "t1" not in window:
        fail(f"profile {path}: the harness ran {calls} steps, not 1 + {PROFILE_STEPS}")
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        fail(f"profile {path}: the trace holds no device activity")
    result = {"phase": "profile", "path": path, "argv": argv,
              **profile_summary(spans, window["t1"] - window["t0"],
                                PROFILE_STEPS)}
    missing = [k for k, ms in result["flash_ms_per_step"].items() if ms <= 0]
    if missing:
        fail(f"profile {path}: no device time for {missing} in the trace")
    emit(result)
    return result


class _RankReports(logging.Handler):
    """Collects the per-rank reports the launching process of a mesh logs
    ("rank %d report %s", the report as JSON)."""

    def __init__(self) -> None:
        super().__init__()
        self.reports: dict[int, dict] = {}

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("rank %d report"):
            self.reports[record.args[0]] = json.loads(record.args[1])


def _raw_segments(lines: list[dict], per_step: dict, per_probe: dict,
                  steps: int, stats_every: int) -> list[tuple[str, list]]:
    """Split rank 0's raw collective dump (one line per call, in call
    order) into the warm-up, each timed step and each phase probe, by
    their counts."""
    def size(counts):
        return sum(counts.values())

    order = [("warmup", size(per_step))]
    for i in range(1, steps + 1):
        order.append((f"step{i}", size(per_step)))
        if i % stats_every == 0 or i == steps:
            order.append((f"probe{i}", size(per_probe)))
    out, at = [], 0
    for name, n in order:
        out.append((name, lines[at:at + n]))
        at += n
    if at != len(lines):
        fail(f"the raw dump holds {len(lines)} calls, the formula {at}")
    return out


def mesh_plan(argv_run: list[str]):
    """A mesh argv, parsed, and what its run implies on each rank:
    (args, cfg, world, want_of), where ``want_of(seq coordinate)`` gives
    the collectives per step and per probe, the run's counts and the run's
    launches (the formula in collective_counters.py, parallel/ring.py)."""
    from tpumon.workload_torch import harness
    from tpumon.workload_torch.collective_counters import (
        expected_per_probe,
        expected_per_step,
    )
    from tpumon.workload_torch.parallel.pipeline import ticks
    from tpumon.workload_torch.parallel.ring import flash_calls_per_layer

    args = harness.build_parser().parse_args(argv_run)
    cfg = harness.round_layers(harness.model_config(args), args.pp, args.interleave)
    dp, tp, sp, pp, ep = args.dp, args.tp, args.sp, args.pp, args.ep
    world = dp * tp * sp * pp * ep
    zigzag = args.sp_layout == "zigzag"
    pipe = (dict(pp=pp, microbatches=args.microbatches, interleave=args.interleave)
            if pp > 1 else {})
    shape = dict(n_layers=cfg.n_layers, dp=dp, tp=tp, remat=args.remat,
                 loss_chunk=args.loss_chunk, seq=args.seq, zero1=args.zero1,
                 sp=sp, sp_layout=args.sp_layout, attn=args.attn, ep=ep,
                 moe=args.model == "moe", **pipe)
    probes = MESH_STEPS // MESH_STATS_EVERY
    # Layer calls of one microbatch, and microbatches a step: under pp
    # every tick runs its chunk of lpg layers, bubbles included.
    if pp > 1:
        layer_calls = (ticks(args.microbatches, pp, args.interleave)
                       * cfg.n_layers // (pp * args.interleave))
    else:
        layer_calls = cfg.n_layers

    def want_of(coord: int):
        per_step = expected_per_step(grad_accum=args.grad_accum,
                                     grad_norm=args.grad_norm, seq_coord=coord,
                                     **shape)
        per_probe = expected_per_probe(seq_coord=coord, **shape)
        counts = {op: (MESH_STEPS + 1) * per_step[op] + probes * per_probe[op]
                  for op in per_step if per_step[op] or per_probe[op]}
        calls = flash_calls_per_layer(sp, zigzag, coord) if sp > 1 else 1
        launches = expected_launches(layer_calls, args.grad_accum,
                                     MESH_STEPS, MESH_STATS_EVERY, calls)
        return per_step, per_probe, counts, launches

    return args, cfg, world, want_of


def check_rank_reports(ranks: dict, want_of, backend: str) -> list[str]:
    """What is wrong in the ranks' reports: a backend other than the
    rule's, non-finite or unequal losses, launches or counted collectives
    other than the formula's for the rank's seq coordinate."""
    bad = []
    for rank, rep in sorted(ranks.items()):
        _, _, want_counts, want_launches = want_of(rep["coords"]["seq"])
        if rep["backend"] != backend:
            bad.append(f"rank {rank} backend {rep['backend']}, the rule names {backend}")
        if not all(math.isfinite(x) for x in rep["losses"] + rep["grad_norms"]):
            bad.append(f"rank {rank} non-finite {rep['losses']} {rep['grad_norms']}")
        if rep["losses"] != ranks[0]["losses"]:
            bad.append(f"rank {rank} losses {rep['losses']} != rank 0's "
                       f"{ranks[0]['losses']}")
        if rep["launches"] != want_launches:
            bad.append(f"rank {rank} launches {rep['launches']} != {want_launches}")
        if rep["collectives"]["counts"] != want_counts:
            bad.append(f"rank {rank} collectives {rep['collectives']['counts']} "
                       f"!= {want_counts}")
    return bad


def drive_mesh(torch, name: str, argv_run: list[str]) -> dict:
    """One mesh path through harness.main (it starts the ranks itself),
    with the page scraped and parsed, each rank's launches and
    collectives held to what the run implies from the rank's own seq
    coordinate (under pp, the same on every stage), and the first step's
    loss and grad norm held to the single-device step on the same weights
    and tokens on this card."""
    from prometheus_client.parser import text_string_to_metric_families

    from tpumon.workload_torch import flops, harness
    from tpumon.workload_torch.ops import flash_attention as fa

    args, cfg, world, want_of = mesh_plan(argv_run)
    dp, tp, sp, pp, ep = args.dp, args.tp, args.sp, args.pp, args.ep
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"

    # The single-device step on the same seed's weights and tokens.
    _release(torch)
    t0 = time.perf_counter()
    single = harness.run(
        cfg, steps=0, batch=args.batch, seq=args.seq, grad_accum=args.grad_accum,
        remat=args.remat, loss_chunk=args.loss_chunk, attn=args.attn,
        with_grad_norm=True, device="cuda",
    )
    single_s = time.perf_counter() - t0
    single_loss, single_gnorm = single.losses[0], single.grad_norms[0]
    del single
    _release(torch)

    reports = _RankReports()
    log = logging.getLogger("tpumon.workload_torch.harness")
    log.addHandler(reports)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=f".chip_smoke_{name}_") as tmp, \
            _Scraper("tpu_step_collective_wait_fraction") as scraper:
        raw_path = os.path.join(tmp, "collectives.jsonl")
        argv = [*argv_run, "--metrics-port", str(scraper.port),
                "--hlo-raw-dump", raw_path]
        fa.reset_launches()
        t0 = time.perf_counter()
        try:
            rc = harness.main(argv)
        finally:
            wall = time.perf_counter() - t0
            log.removeHandler(reports)
        with open(raw_path) as f:
            raw = [json.loads(line) for line in f]
    if rc != 0:
        fail(f"{name}: harness.main returned {rc}")
    ranks = reports.reports
    if sorted(ranks) != list(range(world)):
        fail(f"{name}: reports from ranks {sorted(ranks)}, not 0..{world - 1}")

    bad = check_rank_reports(ranks, want_of, backend)
    first = ranks[0]
    loss_gap = abs(first["losses"][0] - single_loss)
    gnorm_rel = abs(first["grad_norms"][0] - single_gnorm) / single_gnorm
    if loss_gap > PARITY["loss_abs"] or gnorm_rel > PARITY["grad_norm_rel"]:
        bad.append(f"parity: loss {first['losses'][0]} vs {single_loss} "
                   f"(|Δ| {loss_gap:.3g}), grad norm {first['grad_norms'][0]} vs "
                   f"{single_gnorm} (rel {gnorm_rel:.3g}) over {PARITY}")
    if bad:
        fail(f"{name}: " + "; ".join(bad))

    if not scraper.pages:
        fail(f"{name}: never scraped rank 0's page with the wait fraction")
    page = scraper.pages[-1]
    snap = scraper.snapshots()[-1]
    families = {f.name: f for f in text_string_to_metric_families(page)}
    missing = [fam for fam in (
        "workload_collective_ops", "workload_collective_op_latency_microseconds",
        "workload_collective_op_latency_samples", "workload_collective_op_bytes",
        "workload_hlo_log_events") if fam not in families]
    if missing:
        fail(f"{name}: families missing from rank 0's page: {missing}")
    ops_on_page = {sample.labels["op"] for sample in
                   families["workload_collective_ops"].samples}
    if (sp > 1 or pp > 1) and "collective-permute" not in ops_on_page:
        fail(f"{name}: rank 0's page counts no collective-permute: {ops_on_page}")
    wait = snap.get("collective_wait_fraction")
    if wait is None or not 0.0 <= wait <= 1.0:
        fail(f"{name}: collective wait fraction {wait} not in [0, 1]")
    axes = snap.get("axes", {})
    if tuple(axes.get(a) for a in ("dp", "tp", "sp", "pp", "ep")) != (dp, tp, sp, pp, ep):
        fail(f"{name}: the page's axes read {axes}")

    # Per op and timed step, from rank 0's raw dump (call order).
    per_step, per_probe, _, want_launches = want_of(first["coords"]["seq"])
    segments = _raw_segments(raw, per_step, per_probe, MESH_STEPS, MESH_STATS_EVERY)
    timed = [lines for seg, lines in segments if seg.startswith("step")]
    per_op: dict[str, dict] = {}
    for lines in timed:
        for line in lines:
            row = per_op.setdefault(line["op"], {"calls": 0, "bytes": 0, "us": 0.0})
            row["calls"] += 1
            row["bytes"] += line["bytes"]
            row["us"] += line["us"]
    per_op = {op: {k: v / len(timed) for k, v in row.items()}
              for op, row in per_op.items()}
    # The same calls grouped by payload: the gradient bucket, the layers'
    # activation all-reduces, the loss's small ones, the ring's permutes,
    # the experts' combine and gradients.
    by_size: dict[tuple, list] = {}
    for lines in timed:
        for line in lines:
            row = by_size.setdefault((line["op"], line["bytes"]), [0, 0.0])
            row[0] += 1
            row[1] += line["us"]
    by_size_rows = sorted(
        ({"op": op, "bytes": nbytes, "calls_per_step": n / len(timed),
          "us_per_step": us / len(timed)}
         for (op, nbytes), (n, us) in by_size.items()),
        key=lambda r: -r["us_per_step"])
    step_s = snap["step_seconds"]
    # Rank r runs on card r % count; ranks that share a card share its peak.
    cards = [torch.device("cuda", r % torch.cuda.device_count()) for r in range(world)]
    peaks = {rank: rep["peak_memory_bytes"] for rank, rep in sorted(ranks.items())}
    batch, seq = args.batch, args.seq
    result = {
        "phase": name, "argv": argv_run, "backend": backend,
        "ranks_share_card": torch.cuda.device_count() < world,
        "window_step_s": step_s, "steps_per_sec": 1.0 / step_s,
        "tokens_per_sec": batch * seq / step_s,
        "cards": len(set(cards)),
        "mfu": flops.mfu(cfg, batch, seq, 1.0 / step_s, cards),
        "loop_steps_per_sec": first["steps_per_sec"],
        "loss_first": first["losses"][0], "loss_last": first["losses"][-1],
        "losses": first["losses"], "grad_norm_first": first["grad_norms"][0],
        "single_loss": single_loss, "single_grad_norm": single_gnorm,
        "parity": {"loss_abs": loss_gap, "grad_norm_rel": gnorm_rel,
                   "limits": PARITY},
        "single_device_s": single_s,
        "peak_memory_bytes": peaks, "peak_memory_sum": sum(peaks.values()),
        "moment_bytes": {rank: rep["moment_bytes"] for rank, rep in sorted(ranks.items())},
        "launches": first["launches"], "tile_launches": first["tile_launches"],
        "launches_expected": want_launches,
        "launches_by_rank": {rank: rep["launches"] for rank, rep in sorted(ranks.items())},
        "collectives": first["collectives"], "collectives_per_step": per_step,
        "collectives_per_probe": per_probe, "per_op_per_step": per_op,
        "per_payload_per_step": by_size_rows,
        "collective_wait_fraction": wait, "phases": snap.get("phases"),
        "wall_s": wall,
    }
    emit(result)
    return result


def phase_mesh(torch) -> dict:
    """The dense train step at dp=2 × tp=2 with ZeRO-1."""
    return drive_mesh(torch, "mesh", MESH_ARGV)


def phase_ring(torch) -> dict:
    """The dense train step at tp=2 × sp=2 on the zigzag ring."""
    return drive_mesh(torch, "ring", RING_ARGV)


def phase_expert(torch) -> dict:
    """The MoE train step at dp=2 × ep=2."""
    return drive_mesh(torch, "expert", EXPERT_ARGV)


def phase_pipe(torch) -> dict:
    """The dense train step at pp=2 × tp=2 on the circular schedule."""
    return drive_mesh(torch, "pipe", PIPE_ARGV)


def _harness_process(argv: list[str], log_path: str, env: dict | None = None):
    """``python -m tpumon.workload_torch.harness argv`` in a session of its
    own (so that it and its ranks can be stopped together), its output
    going to ``log_path``."""
    with open(log_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "tpumon.workload_torch.harness", *argv],
            cwd=ROOT, env={**os.environ, **(env or {})}, stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True)


def _stop(proc) -> None:
    """SIGKILL a harness process started by :func:`_harness_process` and
    every process of its session, if it is still running."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def phase_hosts(torch, mesh_run: dict) -> dict:
    """The mesh phase's argv as a job of two hosts on this machine: two
    harness processes with --coordinator at a free port, --num-processes
    2 and --process-id 0 and 1, each starting two of the four ranks (all
    on this card, over gloo). Both must exit 0 and log their share; every
    rank's losses must equal the single launch's (the mesh phase, rel
    1e-6); counts and launches must be the formula's on every rank; rank
    0's page must parse."""
    args, cfg, world, want_of = mesh_plan(MESH_ARGV)
    local = world // 2
    backend = "nccl" if torch.cuda.device_count() >= local else "gloo"
    coordinator = f"127.0.0.1:{_free_port()}"
    _release(torch)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_hosts_") as tmp, \
            _Scraper("tpu_step_collective_wait_fraction") as scraper:
        logs = [os.path.join(tmp, f"host{i}.log") for i in range(2)]
        procs = []
        t0 = time.perf_counter()
        try:
            for i, path in enumerate(logs):
                procs.append(_harness_process(
                    [*MESH_ARGV, "--metrics-port", str(scraper.port),
                     "--coordinator", coordinator, "--num-processes", "2",
                     "--process-id", str(i)], path))
            codes = [p.wait(timeout=HOSTS_TIMEOUT_S) for p in procs]
        finally:
            wall = time.perf_counter() - t0
            for p in procs:
                _stop(p)
        texts = [_tail(path, 10**7) for path in logs]
    for i, (code, text) in enumerate(zip(codes, texts)):
        if code != 0:
            fail(f"hosts: process {i} exited with {code}: {text[-3000:]}")
        if f"distributed: process {i}/2, {local} local / {world} global ranks" not in text:
            fail(f"hosts: process {i} did not log its share: {text[-3000:]}")
    ranks, by_host = {}, []
    for text in texts:
        got = {int(m.group(1)): json.loads(m.group(2))
               for m in re.finditer(r"rank (\d+) report (\{.*\})", text)}
        by_host.append(sorted(got))
        ranks.update(got)
    if by_host != [[0, 1], [2, 3]]:
        fail(f"hosts: reports by host {by_host}, not [[0, 1], [2, 3]]")
    bad = check_rank_reports(ranks, want_of, backend)
    want = mesh_run["losses"]
    for rank, rep in sorted(ranks.items()):
        if len(rep["losses"]) != len(want) or not all(
                math.isclose(a, b, rel_tol=1e-6) for a, b in zip(rep["losses"], want)):
            bad.append(f"rank {rank} losses {rep['losses']} != the single "
                       f"launch's {want} (rel 1e-6)")
    if bad:
        fail("hosts: " + "; ".join(bad))
    if not scraper.pages:
        fail("hosts: never scraped rank 0's page with the wait fraction")
    snap = scraper.snapshots()[-1]
    wait = snap.get("collective_wait_fraction")
    if wait is None or not 0.0 <= wait <= 1.0:
        fail(f"hosts: collective wait fraction {wait} not in [0, 1]")
    step_s = snap["step_seconds"]
    result = {
        "phase": "hosts", "argv": MESH_ARGV, "processes": 2, "backend": backend,
        "window_step_s": step_s, "tokens_per_sec": args.batch * args.seq / step_s,
        "collective_wait_fraction": wait, "losses": ranks[0]["losses"],
        "single_launch_losses": want,
        "bitwise_equal": all(rep["losses"] == want for rep in ranks.values()),
        "peak_memory_bytes": {r: rep["peak_memory_bytes"] for r, rep in sorted(ranks.items())},
        "launches": ranks[0]["launches"],
        "tile_launches": ranks[0]["tile_launches"],
        "launches_by_rank": {r: rep["launches"] for r, rep in sorted(ranks.items())},
        "collectives": ranks[0]["collectives"]["counts"], "wall_s": wall,
    }
    emit(result)
    return result


def phase_dryrun(torch) -> list[dict]:
    """``dryrun_multichip(8)`` on the card: eight ranks sharing it over
    gloo run the reference's 13 cells, each held to the dense step (it
    raises otherwise); the flash cells run the kernels at the tiny
    preset's head_dim 32 (padded to 64), so rank 0 must have launched all
    three in each of them, and none in the others."""
    from tpumon.workload_torch import entry

    _release(torch)
    t0 = time.perf_counter()
    rows = entry.dryrun_multichip(DRYRUN_N)
    wall = time.perf_counter() - t0
    names = [row["cell"] for row in rows]
    if names != DRYRUN_CELLS:
        fail(f"dryrun: cells {names}, the reference's are {DRYRUN_CELLS}")
    bad = []
    for row in rows:
        emit({"phase": "dryrun", **row})
        launched = [n for n in row["launches_rank0"].values() if n > 0]
        if row["cell"] in DRYRUN_FLASH and len(launched) != 3:
            bad.append(f"{row['cell']}: rank 0 launched {row['launches_rank0']}")
        if sum(row["tile_launches_rank0"].values()) != sum(row["launches_rank0"].values()):
            bad.append(f"{row['cell']}: tile launches {row['tile_launches_rank0']} "
                       f"do not add up to {row['launches_rank0']}")
        if row["cell"] not in DRYRUN_FLASH and launched:
            bad.append(f"{row['cell']} has no flash, yet launched {row['launches_rank0']}")
    if bad:
        fail("dryrun: " + "; ".join(bad))
    emit({"phase": "dryrun", "n": DRYRUN_N, "cells": names, "wall_s": wall,
          "max_loss_abs": max(r["loss_abs"] for r in rows),
          "max_grad_norm_rel": max(r["grad_norm_rel"] for r in rows)})
    return rows


def phase_entry(torch) -> dict:
    """``entry()``'s forward on the card, the kernel probe and the card
    count."""
    from tpumon.workload_torch import entry
    from tpumon.workload_torch.ops import flash_attention as fa

    _release(torch)
    fa.reset_launches()
    fn, example = entry.entry()
    with torch.no_grad():
        out = fn(*example)
    torch.cuda.synchronize()
    tile_counts = dict(fa.tile_launches)
    if tuple(out.shape) != (2, 32, 512) or not torch.isfinite(out).all().item():
        fail(f"entry: output {tuple(out.shape)}, finite "
             f"{torch.isfinite(out).all().item()}")
    t0 = time.perf_counter()
    probe = entry.probe_compiled_kernel()
    probe_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    if not probe["validated"] or name not in probe["detail"]:
        fail(f"entry: the kernel probe gave {probe}")
    count = entry.gpu_chip_count()
    if count != (torch.cuda.device_count(), "gpu"):
        fail(f"entry: gpu_chip_count() is {count}, torch counts "
             f"{torch.cuda.device_count()}")
    result = {"phase": "entry", "shape": list(out.shape), "dtype": str(out.dtype),
              "tile_launches": tile_counts, "probe": probe, "probe_s": probe_s,
              "gpu_chip_count": list(count)}
    emit(result)
    return result


def _page(port: int) -> str | None:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as resp:
            return resp.read().decode()
    except OSError:
        return None


def phase_drill(torch) -> dict:
    """The preemption drill on the main path: the dense argv with --serve
    and its page, in a process of its own; SIGTERM once the first window
    is on the page. The page must read tpu_step_terminating 0 before and
    1 within the grace window, and the process must exit 143."""
    from tpumon.lifecycle.probe import step_snapshot_from_text

    port = _free_port()
    _release(torch)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_drill_") as tmp:
        path = os.path.join(tmp, "drill.log")
        proc = _harness_process(
            [*DRILL_ARGV, "--metrics-port", str(port)], path,
            env={"TPUMON_STEP_TERM_GRACE_S": str(DRILL_GRACE_S)})
        try:
            deadline = time.monotonic() + HOSTS_TIMEOUT_S
            before = None
            while before is None and time.monotonic() < deadline:
                if proc.poll() is not None:
                    fail(f"drill: the harness exited {proc.returncode} before "
                         f"its first window: {_tail(path)}")
                page = _page(port)
                if page and "tpu_step_duration_seconds" in page:
                    before = step_snapshot_from_text(page)
                time.sleep(0.2)
            if before is None:
                fail("drill: no window on the page")
            t_term = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            flagged_at = None
            while flagged_at is None and time.monotonic() - t_term < DRILL_GRACE_S + 5:
                page = _page(port)
                if page is None:
                    break
                if step_snapshot_from_text(page).get("terminating"):
                    flagged_at = time.monotonic() - t_term
                time.sleep(0.1)
            rc = proc.wait(timeout=DRILL_GRACE_S + 60)
            exit_s = time.monotonic() - t_term
        finally:
            _stop(proc)
            log_tail = _tail(path)
    # The harness logs its launches by tiles as it exits after the grace.
    logged = re.findall(r"flash launches .* by tiles (\{.*\})", log_tail)
    if before.get("terminating"):
        fail("drill: the page read terminating before the SIGTERM")
    if flagged_at is None or flagged_at >= DRILL_GRACE_S:
        fail(f"drill: the flag read 1 at {flagged_at} s, not within the "
             f"{DRILL_GRACE_S} s grace: {log_tail}")
    if rc != 143:
        fail(f"drill: exit code {rc}, not 143: {log_tail}")
    if not logged:
        fail(f"drill: the harness logged no flash launches at its exit: {log_tail}")
    result = {"phase": "drill", "argv": DRILL_ARGV, "grace_s": DRILL_GRACE_S,
              "step_before": before.get("step"),
              "step_seconds_before": before.get("step_seconds"),
              "flagged_after_s": flagged_at, "exit_code": rc, "exit_after_s": exit_s,
              "tile_launches": json.loads(logged[-1])}
    emit(result)
    return result


PHASES = ("env,build,kernels,norm,main,moe,deepseek,checkpoint,bench,profile,mesh,"
          "ring,expert,pipe,hosts,dryrun,entry,drill")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=PHASES,
                        help=f"comma-separated subset of {PHASES}")
    parser.add_argument("--reps", type=int, default=10,
                        help="timed runs per kernel (median reported)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cases", default=None,
                        help="comma-separated subset of the kernels phase's "
                        "CASES (default: all)")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES.split(","))
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    if "hosts" in phases and "mesh" not in phases:
        parser.error("the hosts phase holds its losses to the mesh phase's: "
                     "run both")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    # Imported after the card check: the port must be in this checkout.
    import tpumon.workload_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if "env" in phases:
        phase_env(torch)
    build = phase_build() if "build" in phases else {}
    cases = None if args.cases is None else set(args.cases.split(","))
    kernels = (phase_kernels(torch, args.reps, args.seed, cases)
               if "kernels" in phases else {})
    if "norm" in phases:
        phase_norm(torch, args.reps, args.seed)
    main_run = phase_main(torch) if "main" in phases else {}
    moe_run = phase_moe(torch) if "moe" in phases else {}
    if "deepseek" in phases:
        phase_deepseek(torch)
    if "checkpoint" in phases:
        phase_checkpoint(torch)
    if "bench" in phases:
        phase_bench(torch)
    if "profile" in phases:
        phase_profile(torch, "main", DENSE_TRAIN)
        phase_profile(torch, "moe", MOE_TRAIN)
    mesh_run = phase_mesh(torch) if "mesh" in phases else {}
    ring_run = phase_ring(torch) if "ring" in phases else {}
    expert_run = phase_expert(torch) if "expert" in phases else {}
    pipe_run = phase_pipe(torch) if "pipe" in phases else {}
    hosts_run = phase_hosts(torch, mesh_run) if "hosts" in phases else {}
    dryrun_rows = phase_dryrun(torch) if "dryrun" in phases else []
    if "entry" in phases:
        phase_entry(torch)
    if "drill" in phases:
        phase_drill(torch)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)

    from tpumon.workload_torch.ops import flash_attention as fa

    line = []
    for name, (source, replaces) in KERNELS.items():
        row = kernels.get(name, {}).get("main", {})
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[0], "replaces_all": replaces,
            "launches": main_run.get("launches", {}).get(name, 0),
            "launches_moe": moe_run.get("launches", {}).get(name, 0),
            "launches_mesh_rank0": mesh_run.get("launches", {}).get(name, 0),
            "launches_ring_rank0": ring_run.get("launches", {}).get(name, 0),
            "launches_expert_rank0": expert_run.get("launches", {}).get(name, 0),
            "launches_pipe_rank0": pipe_run.get("launches", {}).get(name, 0),
            "launches_hosts_rank0": hosts_run.get("launches", {}).get(name, 0),
            "launches_dryrun_rank0": sum(row["launches_rank0"][name]
                                         for row in dryrun_rows),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": row.get("library_ms"),
            **{f"{case}_case": {key: kernels.get(name, {}).get(case, {}).get(key)
                                for key in keys} for case in ("moe", "tp2", "zz", "zzc", "d32", "d32zz", "mla")},
            "tiles": row.get("tiles"),
            "compiled_tiles": {str(D): [list(p) for p in pairs]
                               for D, pairs in fa.COMPILED[name].items()},
            "tile_ms_by_case": {case: r.get("tile_ms")
                                for case, r in kernels.get(name, {}).items()},
            "build_s": build.get("seconds"),
            "passed": all(r["passed"] for r in kernels.get(name, {}).values())
            if name in kernels else None,
        })
    print(nvidia_smi_line(), flush=True)  # the card's name and power limit
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
