"""Entry points of the port: a forward to run, the composition dryrun,
the kernel probe and the card count.

The counterparts of the reference's entry points outside its package:

- :func:`entry` ← ``__graft_entry__.entry``: the tiny Llama forward and
  its example arguments;
- :func:`dryrun_multichip` ← ``__graft_entry__.dryrun_multichip``: the
  composition matrix, one train step of each cell the rank count allows
  over a mesh, each checked against the single-device dense step;
- :func:`probe_compiled_kernel` ← ``bench.py::probe_compiled_kernel``:
  the flash kernels forward and backward on the card, in a subprocess
  with a hard timeout;
- :func:`gpu_chip_count` ← ``tpumon/discovery/topology.py::_jax_chip_count``:
  the card count from ``torch.cuda``, bounded by a timeout.

Each runs on the card unless the caller passes ``platform="cpu"``.

CLI:  python -m tpumon.workload_torch.entry [--platform cpu] [--n 8]
      (``entry()``, then ``dryrun_multichip(n)``)
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import subprocess
import sys
import tempfile
import threading

import torch

from tpumon.workload_torch.models.llama import LlamaConfig, init_params
from tpumon.workload_torch.models.moe import MoeConfig
from tpumon.workload_torch.platform import PLATFORMS, resolve_device

log = logging.getLogger(__name__)

#: The repository's root, where the probe's subprocess finds the package.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def entry(platform: str = "cuda"):
    """(fn, example_args): the tiny Llama forward, ``fn(model, tokens)``
    → logits [2, 32, vocab] f32, with the seeded model and
    ``zeros((2, 32), int64)`` tokens on the platform's device."""
    device = resolve_device(platform)
    cfg = LlamaConfig.tiny()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    tokens = torch.zeros((2, 32), dtype=torch.int64, device=device)

    def fn(model, tokens):
        return model(tokens)

    return fn, (model, tokens)


# ---------------------------------------------------------------------------
# The dryrun matrix
# ---------------------------------------------------------------------------

#: The reference's bounds on a cell against the dense step: bf16 products
#: on both sides, |Δloss| observed ≤ 7e-4, so 5e-3 is ~10× the noise;
#: the grad norm relative, with the same margin.
LOSS_TOL = 0.005
GRAD_RTOL = 0.02
#: Every cell's sequence length.
SEQ = 32


@dataclasses.dataclass
class Cell:
    """One composition of the matrix: its name (the reference's
    numbering), the label its check reports, the config, the mesh, the
    run's keywords, and the ranks it takes (the first ``ranks`` of the
    world)."""

    name: str
    what: str
    cfg: object
    mesh: dict
    kwargs: dict
    line: str

    @property
    def ranks(self) -> int:
        return math.prod(self.mesh.values())

    @property
    def batch(self) -> int:
        return 2 * self.mesh["dp"]


def dryrun_cells(n: int) -> list[Cell]:
    """The cells of ``__graft_entry__.dryrun_multichip(n)``, chosen by its
    rules from ``n``, in its order, with its configurations, batches
    (2·dp), microbatches, layouts and attention paths."""
    cells = []

    def add(name, what, cfg, line, dp=1, tp=1, sp=1, pp=1, ep=1, **kwargs):
        cells.append(Cell(name, what, cfg,
                          dict(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep), kwargs, line))

    # 1. dp×tp×sp: the widest tp that divides the kv heads, then sp=2 if
    # the rest allows; the leftover ranks go to dp.
    cfg = LlamaConfig.tiny()
    tp = next((c for c in (4, 2) if n % c == 0 and cfg.n_kv_heads % c == 0), 1)
    sp = 2 if n % (tp * 2) == 0 and n > tp else 1
    dp = n // (tp * sp)
    mesh = dict(dp=dp, tp=tp, sp=sp)
    add("1", "dp×tp×sp", cfg, f"dryrun dp={dp} tp={tp} sp={sp} over {n} ranks",
        **mesh)
    if sp > 1:
        add("1b", "dp×tp×sp zigzag", cfg,
            f"dryrun dp={dp} tp={tp} sp={sp} layout=zigzag", **mesh,
            sp_layout="zigzag")
        add("1c", "dp×tp×sp zigzag flash", cfg,
            f"dryrun dp={dp} tp={tp} sp={sp} layout=zigzag attn=flash", **mesh,
            sp_layout="zigzag", attn="flash")
        add("1d", "dp×tp×sp flash", cfg,
            f"dryrun dp={dp} tp={tp} sp={sp} layout=contiguous attn=flash",
            **mesh, attn="flash")

    # 2. dp×pp×tp: GPipe with Megatron shards inside each stage body.
    pcfg = LlamaConfig(n_layers=4)
    pp = next((c for c in (4, 2) if n % c == 0), 1)
    if pp > 1:
        ptp = 2 if n % (pp * 2) == 0 and pcfg.n_kv_heads % 2 == 0 else 1
        dp = n // (pp * ptp)
        add("2", "dp×pp×tp", pcfg, f"dryrun dp={dp} pp={pp} tp={ptp}",
            dp=dp, tp=ptp, pp=pp, microbatches=2)

    # 2b/2c/2c-flash. dp×pp×sp: the circular schedule with the ring in
    # the stage bodies, then GPipe with the zigzag ring, then with flash.
    if n % 8 == 0:
        dp = n // 4
        mesh = dict(dp=dp, sp=2, pp=2)
        add("2b", "dp×pp×sp interleaved", pcfg,
            f"dryrun dp={dp} pp=2 sp=2 interleave=2", **mesh,
            microbatches=2, interleave=2)
        add("2c", "dp×pp×sp zigzag", pcfg,
            f"dryrun dp={dp} pp=2 sp=2 layout=zigzag", **mesh,
            microbatches=2, sp_layout="zigzag")
        add("2c-flash", "dp×pp×sp zigzag flash", pcfg,
            f"dryrun dp={dp} pp=2 sp=2 layout=zigzag attn=flash", **mesh,
            microbatches=2, sp_layout="zigzag", attn="flash")

    # 2d. dp×pp×ep×tp: MoE through the pipeline.
    if n % 8 == 0:
        dp = n // 8
        add("2d", "dp×pp×ep×tp moe", MoeConfig.tiny(),
            f"dryrun dp={dp} pp=2 ep=2 tp=2 (moe)", dp=dp, tp=2, pp=2, ep=2,
            microbatches=2)

    # 3. dp×ep×tp, then 4. dp×ep×sp.
    mcfg = MoeConfig.tiny()
    ep = next((c for c in (4, 2) if n % c == 0 and mcfg.n_experts % c == 0), 1)
    if ep > 1:
        etp = 2 if n % (ep * 2) == 0 and mcfg.n_kv_heads % 2 == 0 else 1
        dp = n // (ep * etp)
        add("3", "dp×ep×tp", mcfg, f"dryrun dp={dp} ep={ep} tp={etp} (moe)",
            dp=dp, tp=etp, ep=ep)
        esp = 2 if n % (ep * 2) == 0 else 1
        if esp > 1:
            dp = n // (ep * esp)
            add("4", "dp×ep×sp", mcfg, f"dryrun dp={dp} ep={ep} sp={esp} (moe)",
                dp=dp, sp=esp, ep=ep)

    # 5. dp×tp with flash, on at most 4 ranks; 6. the same with ZeRO-1.
    ftp = next((c for c in (2,) if n % c == 0 and cfg.n_kv_heads % c == 0), 1)
    fdp = min(2, n // ftp)
    add("5", "dp×tp flash", cfg, f"dryrun dp={fdp} tp={ftp} attn=flash",
        dp=fdp, tp=ftp, attn="flash")
    if fdp > 1:
        add("6", "dp×tp zero1", cfg, f"dryrun dp={fdp} tp={ftp} zero1",
            dp=fdp, tp=ftp, zero1=True)
    return cells


def run_cells(rank: int, world: int, cells: list[Cell], platform: str) -> list:
    """Every cell on this rank (a ``launch.spawn`` target): one train step
    (after the warm-up) over the cell's mesh on the world's first
    ``cell.ranks`` ranks, with the grad norm. The other ranks create the
    cell's groups and sit it out (None). Returns, per cell, the last loss,
    the grad norm and the rank's kernel launches."""
    from tpumon.workload_torch import harness
    from tpumon.workload_torch.ops import flash_attention as fa
    from tpumon.workload_torch.parallel import mesh as mesh_mod

    device = mesh_mod.rank_device(platform, rank)
    out = []
    for cell in cells:
        m = cell.mesh
        mesh = mesh_mod.make_mesh(m["dp"], m["tp"], m["sp"], m["pp"], m["ep"],
                                  device=device, ranks=range(cell.ranks))
        if mesh is None:
            out.append(None)
            continue
        fa.reset_launches()
        result = harness.run(cell.cfg, steps=1, batch=cell.batch, seq=SEQ,
                             mesh=mesh, with_grad_norm=True, **cell.kwargs)
        out.append({"loss": result.losses[-1], "grad_norm": result.grad_norm,
                    "launches": dict(fa.launches)})
    return out


def check_cell(cell: Cell, loss: float, grad_norm: float, dense_loss: float,
               dense_grad_norm: float) -> tuple[float, float]:
    """(|Δloss|, grad-norm rel) of a cell's step against the dense step's;
    raises RuntimeError when the loss is not finite or either is over its
    bound (:data:`LOSS_TOL`, :data:`GRAD_RTOL`)."""
    if not (loss == loss and abs(loss) < 1e6):
        raise RuntimeError(f"{cell.what} produced non-finite loss: {loss}")
    delta = abs(loss - dense_loss)
    if delta > LOSS_TOL:
        raise RuntimeError(
            f"{cell.what} loss {loss:.4f} diverges from dense "
            f"{dense_loss:.4f} (|Δ|={delta:.4f} > {LOSS_TOL})")
    grad_rel = abs(grad_norm - dense_grad_norm) / max(abs(dense_grad_norm), 1e-12)
    if not grad_rel <= GRAD_RTOL:
        raise RuntimeError(
            f"{cell.what} grad-norm {grad_norm:.5f} diverges from dense "
            f"{dense_grad_norm:.5f} (rel={grad_rel:.5f} > {GRAD_RTOL})")
    return delta, grad_rel


def dryrun_multichip(n: int, platform: str = "cuda", *,
                     timeout_s: float = 900.0) -> list[dict]:
    """The composition matrix on ``n`` ranks (:func:`dryrun_cells`).

    The ranks start once (``launch.spawn``: on the CPU, or sharing the
    cards round-robin, over gloo or, with a card a rank, nccl) and run
    every cell as one job. Each cell's one-step loss and grad norm are
    then held against the single-device dense step on the same seed
    (plain attention, as the reference's ``dense_ref``): |Δloss| ≤
    :data:`LOSS_TOL` and grad-norm rel ≤ :data:`GRAD_RTOL`, or it raises.
    Prints the reference's line for every cell and its closing line;
    returns one dict per cell (name, loss, |Δ|, grad-norm rel, rank 0's
    kernel launches)."""
    from tpumon.workload_torch import harness
    from tpumon.workload_torch.parallel import launch

    device = resolve_device(platform)
    if device.type == "cuda":
        from tpumon.workload_torch.ops import _build

        _build.build()  # once, before the ranks start
    cells = dryrun_cells(n)
    with tempfile.TemporaryDirectory(prefix="tpumon-dryrun-") as tmp:
        ranks = launch.spawn(run_cells, n, os.path.join(tmp, "rendezvous"),
                             (cells, platform), timeout_s=timeout_s,
                             platform=platform)
    dense: dict = {}
    rows, ran = [], []
    for cell, got in zip(cells, ranks[0]):
        key = (cell.cfg, cell.batch)
        if key not in dense:
            dense[key] = harness.run(cell.cfg, steps=1, batch=cell.batch,
                                     seq=SEQ, with_grad_norm=True,
                                     device=device)
        ref = dense[key]
        loss = got["loss"]
        delta, grad_rel = check_cell(cell, loss, got["grad_norm"],
                                     ref.losses[-1], ref.grad_norm)
        ran.append(cell.what)
        print(f"{cell.line}: loss={loss:.4f} Δdense={delta:.4f} ∇rel={grad_rel:.5f}",
              flush=True)
        rows.append({"cell": cell.name, "what": cell.what, "mesh": cell.mesh,
                     "ranks": cell.ranks, "loss": loss,
                     "dense_loss": ref.losses[-1], "loss_abs": delta,
                     "grad_norm": got["grad_norm"], "dense_grad_norm": ref.grad_norm,
                     "grad_norm_rel": grad_rel, "launches_rank0": got["launches"]})
    print(f"dryrun_multichip OK: {', '.join(ran)} exercised on {n} ranks — "
          "every composition's loss AND gradient norm dense-parity-checked",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# The kernel probe and the card count
# ---------------------------------------------------------------------------

#: Run in a subprocess on the card: the reference probe's shape (GQA at
#: seq 4096), forward and backward through the flash kernels. The values
#: come back to the host, so "validated" means the kernels ran; the
#: launch counts keep a plain-version path from counting.
_KERNEL_PROBE_CODE = """
import math, torch
from tpumon.workload_torch.ops import flash_attention as fa
from tpumon.workload_torch.platform import resolve_device
dev = resolve_device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
q, k, v = randn(1, 4096, 4, 128), randn(1, 4096, 2, 128), randn(1, 4096, 2, 128)
fa.reset_launches()
val = fa.flash_attention(q, k, v).float().sum()
val.backward()
val = val.item()
assert math.isfinite(val), "non-finite kernel output"
for g in (q.grad, k.grad, v.grad):
    gs = g.float().abs().sum().item()
    assert math.isfinite(gs) and gs > 0, f"bad gradient: {gs}"
assert fa.launches == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}, fa.launches
print(f"KERNEL_OK {torch.cuda.get_device_name(dev)}")
"""


def probe_compiled_kernel(timeout_s: float = 300.0) -> dict:
    """Run the flash kernels on the card, in a subprocess with a hard
    timeout (a wedged device must not wedge the caller). Returns
    {"validated": bool, "detail": str}: the card's name, or the last line
    of the failure (no card included), or the timeout.
    TPUMON_BENCH_KERNEL_PROBE=0 skips it (not validated)."""
    if os.environ.get("TPUMON_BENCH_KERNEL_PROBE", "1") == "0":
        return {"validated": False, "detail": "probe disabled by env"}
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _KERNEL_PROBE_CODE], capture_output=True,
            text=True, timeout=timeout_s, cwd=ROOT,
        )
    except subprocess.TimeoutExpired:
        return {"validated": False,
                "detail": f"probe timed out after {timeout_s:.0f}s"}
    if proc.returncode == 0 and "KERNEL_OK" in proc.stdout:
        kind = proc.stdout.strip().split("KERNEL_OK", 1)[1].strip()
        return {"validated": True, "detail": f"flash kernels executed on {kind}"}
    tail = (proc.stderr or proc.stdout).strip().split("\n")
    return {"validated": False, "detail": tail[-1][:200] if tail else "probe failed"}


#: Seconds :func:`gpu_chip_count` waits for the card count.
CHIP_COUNT_TIMEOUT_S = 15.0


class ChipCounter:
    """The card count from ``torch.cuda``, probed once in one daemon
    thread shared by every call; a call that outwaits ``timeout_s`` gets
    (0, "none") at once, and later calls pick up the count if the probe
    ever finishes."""

    def __init__(self, count=torch.cuda.device_count) -> None:
        self._count = count
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._result: list[tuple[int, str]] = []

    def _probe(self) -> None:
        try:
            n = self._count()
            self._result.append((n, "gpu") if n > 0 else (0, "none"))
        except Exception as exc:
            log.debug("CUDA enumeration unavailable: %s", exc)
            self._result.append((0, "none"))

    def __call__(self, timeout_s: float = CHIP_COUNT_TIMEOUT_S) -> tuple[int, str]:
        with self._lock:
            if self._result:
                return self._result[0]
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._probe, name="tpumon-cuda-discover", daemon=True)
                self._thread.start()
            thread = self._thread
        thread.join(timeout=timeout_s)
        if not self._result:
            log.warning("CUDA device enumeration timed out after %.0fs; "
                        "continuing with zero cards", timeout_s)
            return 0, "none"
        return self._result[0]


_chip_counter = ChipCounter()


def gpu_chip_count(timeout_s: float = CHIP_COUNT_TIMEOUT_S) -> tuple[int, str]:
    """(cards, "gpu"), or (0, "none") when there is no card or the count
    did not come within ``timeout_s`` (:class:`ChipCounter`)."""
    return _chip_counter(timeout_s)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tpumon-workload-torch-entry")
    parser.add_argument("--platform", choices=PLATFORMS, default="cuda")
    parser.add_argument("--n", type=int, default=8,
                        help="ranks of the dryrun matrix")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    fn, example = entry(args.platform)
    with torch.no_grad():
        out = fn(*example)
    print("entry OK:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(args.n, args.platform)
    return 0


__all__ = [
    "CHIP_COUNT_TIMEOUT_S",
    "Cell",
    "ChipCounter",
    "check_cell",
    "GRAD_RTOL",
    "LOSS_TOL",
    "dryrun_cells",
    "dryrun_multichip",
    "entry",
    "gpu_chip_count",
    "probe_compiled_kernel",
    "run_cells",
]


if __name__ == "__main__":
    sys.exit(main())
