"""What the mesh tests run on every rank (``launch.spawn`` targets).

Each function runs inside one rank of a CPU gloo group and returns plain
Python and numpy values for the test to compare; the tests start them
here, in the package, because ``spawn`` imports its target by name in a
fresh interpreter.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumon.workload_torch import harness
from tpumon.workload_torch.models import moe as moe_mod
from tpumon.workload_torch.ops import flash_attention as fa
from tpumon.workload_torch.parallel import mesh as mesh_mod
from tpumon.workload_torch.stats import WorkloadStats


#: The flash wrappers whose calls a job counts.
FLASH_WRAPPERS = ("flash_fwd", "flash_dq", "flash_dkv")


def run_jobs(rank: int, world: int, jobs: list[dict]) -> list[dict]:
    """``harness.run`` once per job on a fresh dp×pp×ep×sp×tp mesh: each
    job is ``{"cfg", "dp", "tp", "kwargs"}`` and optionally ``"sp"``,
    ``"pp"`` and ``"ep"``, and the pipeline's ``"microbatches"`` and
    ``"interleave"`` (``kwargs`` go to ``run``, device cpu, ``sp_layout``
    among them), plus ``"stats": True`` to pass a fresh ``WorkloadStats`` (the
    windowed loop) and ``"routes": True`` to record every MoE layer's
    dispatch tensors (the rank's rows); ``{"pair": True}`` runs
    :func:`copy_reduce_pair`, ``{"gather_route": True}``
    :func:`gather_route`.
    Returns each job's losses, grad norms, moment bytes by parameter,
    collective counts and bytes, the calls of each flash wrapper (on the
    CPU they run the kernels' plain versions and launch nothing) and the
    rank's mesh coordinates, and the routes when asked."""
    out = []
    for job in jobs:
        if job.get("pair"):
            out.append(copy_reduce_pair(rank, world))
            continue
        if job.get("gather_route"):
            out.append(gather_route(rank, world))
            continue
        mesh = mesh_mod.make_mesh(job["dp"], job["tp"], job.get("sp", 1),
                                  job.get("pp", 1), job.get("ep", 1),
                                  device=torch.device("cpu"))
        routes: list[np.ndarray] = []
        route_tokens = moe_mod.route_tokens
        if job.get("routes"):
            def recording(*args):
                dispatch, combine, probs = route_tokens(*args)
                routes.append(dispatch.detach().numpy().copy())
                return dispatch, combine, probs

            moe_mod.route_tokens = recording
        calls = dict.fromkeys(FLASH_WRAPPERS, 0)
        wrappers = {name: getattr(fa, name) for name in FLASH_WRAPPERS}

        def counting(name):
            def call(*args, **kw):
                calls[name] += 1
                return wrappers[name](*args, **kw)
            return call

        kwargs = dict(job["kwargs"])
        for key in ("microbatches", "interleave"):
            if key in job:
                kwargs[key] = job[key]
        if job.get("stats"):
            kwargs["stats"] = WorkloadStats()
        for name in FLASH_WRAPPERS:
            setattr(fa, name, counting(name))
        try:
            result = harness.run(job["cfg"], mesh=mesh, device="cpu", **kwargs)
        finally:
            moe_mod.route_tokens = route_tokens
            for name, fn in wrappers.items():
                setattr(fa, name, fn)
        detail = mesh.counters.detailed_snapshot()
        out.append({
            "losses": result.losses,
            "grad_norms": result.grad_norms,
            "start_step": result.start_step,
            "moment_bytes": result.moment_bytes,
            "counts": detail["counts"],
            "bytes": detail["bytes"],
            "coords": mesh.coords,
            "routes": routes,
            "flash_calls": calls,
        })
    return out


def copy_reduce_pair(rank: int, world: int, seed: int = 0) -> dict:
    """The Megatron f/g pair on a dp×tp = 2×2 mesh against the unsplit
    product, in f32: x [4, 8] @ w1 [8, 6] (column split) @ w2 [6, 10]
    (row split). Returns the max abs error of the output, of dx, and of
    the rank's slices of dw1 and dw2."""
    mesh = mesh_mod.make_mesh(2, 2, device=torch.device("cpu"))
    rng = np.random.default_rng(seed)
    x, w1, w2, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for s in ((4, 8), (8, 6), (6, 10), (4, 10)))
    full = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
    ((full[0] @ full[1] @ full[2]) * g).sum().backward()
    want = (x @ w1 @ w2).detach()

    m = mesh.coords["model"]
    xs = x.clone().requires_grad_(True)
    w1s = w1.chunk(2, dim=1)[m].clone().requires_grad_(True)
    w2s = w2.chunk(2, dim=0)[m].clone().requires_grad_(True)
    out = mesh_mod.reduce_from_model(mesh_mod.copy_to_model(xs, mesh) @ w1s @ w2s, mesh)
    (out * g).sum().backward()
    return {
        "out": (out.detach() - want).abs().max().item(),
        "dx": (xs.grad - full[0].grad).abs().max().item(),
        "dw1": (w1s.grad - full[1].grad.chunk(2, dim=1)[m]).abs().max().item(),
        "dw2": (w2s.grad - full[2].grad.chunk(2, dim=0)[m]).abs().max().item(),
        "counts": mesh.counters.detailed_snapshot()["counts"],
    }


def gather_route(rank: int, world: int, seed: int = 0) -> dict:
    """The seq gather and ``_route`` on a seq split of given f32 router
    probabilities, against ``_route`` on the unsplit ones, on an
    ep=2×sp=2 mesh (``models.moe.route_tokens``' routing under sp).
    Returns whether this rank's rows of dispatch and combine equal the
    unsplit routing's bit for bit, and the counts."""
    mesh = mesh_mod.make_mesh(1, 1, 2, ep=2, device=torch.device("cpu"))
    cfg = moe_mod.MoeConfig.tiny()
    B, S, E = 2, 32, cfg.n_experts
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((B, S, E)).astype(np.float32))
    probs = torch.softmax(logits, dim=-1)
    want = moe_mod._route(probs, cfg.top_k, cfg.capacity(S))
    rows = S // mesh.sp
    start = mesh.coords["seq"] * rows
    whole = mesh_mod.gather_seq(probs[:, start:start + rows].contiguous(), mesh)
    got = moe_mod._route(whole, cfg.top_k, cfg.capacity(whole.shape[1]))
    return {
        "equal": [torch.equal(g[:, start:start + rows], w[:, start:start + rows])
                  for g, w in zip(got, want)],
        "gathered_equal": torch.equal(whole, probs),
        "counts": mesh.counters.detailed_snapshot()["counts"],
    }


def permute_on_card(rank: int, world: int) -> dict:
    """Two ranks on card 0 over gloo swap a bf16 tensor with
    ``parallel.mesh.permute`` (staged through the host) and check what
    arrives against what the peer sent. Returns the max abs difference,
    the received tensor's device and the counts."""
    mesh = mesh_mod.make_mesh(1, 1, world, device=torch.device("cuda", 0))
    shape = (2, 64, 2, 128)

    def payload(r):
        gen = torch.Generator().manual_seed(r)
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    t = payload(rank).cuda()
    got = mesh_mod.permute(t, mesh, "seq", [(j, (j + 1) % world) for j in range(world)])
    want = payload((rank - 1) % world)
    return {
        "max_abs": (got.cpu().float() - want.float()).abs().max().item(),
        "device": str(got.device), "dtype": str(got.dtype),
        "counts": mesh.counters.detailed_snapshot()["counts"],
    }


def fail_on_rank(rank: int, world: int, bad: int) -> None:
    """Rank ``bad`` raises; the others wait in a barrier it never joins,
    so only the launcher can end them."""
    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


__all__ = ["copy_reduce_pair", "fail_on_rank", "gather_route", "permute_on_card",
           "run_jobs"]
