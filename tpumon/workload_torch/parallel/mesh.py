"""Process mesh, Megatron splits, ZeRO-1 and the port's collectives.

The counterpart of ``tpumon/workload/parallel/mesh.py``. The reference
lays devices out on a named ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives; here each mesh position is one process, each axis one
``torch.distributed`` process group, and every collective is an explicit
call in this module, wrapped in the rank's
:class:`~tpumon.workload_torch.collective_counters.CollectiveCounters`
so the page counts all of them.

Axes, outermost first, in the reference's order (``AXES``): ``data``
(batch; gradients all-reduce over it), ``stage``, ``expert``, ``seq`` and
``model`` (Megatron tensor parallelism: heads and FFN columns split,
output projections split by rows, the vocabulary split in the embedding
and the unembed). Ranks are laid out like ``reshape(dp, pp, ep, sp, tp)``,
so model peers are adjacent ranks. An axis of size 1 has no group, and a
collective over it is the identity: no call, nothing counted.

The weights are replicated over ``data`` and ``seq``, so the gradient
bucket all-reduces over one ``data_seq`` group per (stage, expert, model)
coordinate: the data group when sp = 1, the seq group when dp = 1.

Pipeline parallelism splits the decoder's layers over ``stage``
(``parallel/pipeline.py``): a stage holds its layers under their global
names (:func:`shard_params` keeps them), and the embedding, final norm
and unembed are replicated over it. The pipe's input enters through
:func:`copy_to_stage` and its output leaves through
:func:`reduce_from_stage`, and each schedule tick moves the activations
one stage on with :func:`stage_hop`.

Expert parallelism splits only the MoE banks over ``expert`` (E, as
``moe_param_specs`` does); tokens, activations and the routing are
replicated over it, as the reference's ``batch_spec``/``activation_spec``
leave them. Each expert rank runs its own experts on the whole batch
row, and one all-reduce over ``expert`` combines their outputs
(:func:`reduce_from_expert`), the traffic the reference's compiled step
issues (no all-to-all).

The backend rule: ``nccl`` when each rank has a card of its own on every
host, ``gloo`` when ranks share a card or run on the CPU (gloo stages CUDA
tensors through the host); the hosts agree on it through the job's store
(:func:`agree_backend`). A rank that is local rank j on its host uses
card ``j % device_count``. A mesh may take a subset of the world's ranks
(the dryrun's smaller cells); the other ranks create its groups too and
sit it out.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from tpumon.workload_torch.collective_counters import CollectiveCounters
from tpumon.workload_torch.platform import resolve_device

log = logging.getLogger(__name__)

AXES = ("data", "stage", "expert", "seq", "model")


def layout(dp: int, tp: int, sp: int = 1, pp: int = 1, ep: int = 1) -> np.ndarray:
    """The ranks of a dp×pp×ep×sp×tp mesh on a grid in :data:`AXES` order."""
    return np.arange(dp * pp * ep * sp * tp).reshape(dp, pp, ep, sp, tp)


def axis_groups(grid: np.ndarray, axis: str) -> list[list[int]]:
    """The rank lists of ``axis``'s groups: ranks that share every other
    coordinate, in grid order."""
    i = AXES.index(axis)
    return np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]).tolist()


def data_seq_groups(grid: np.ndarray) -> list[list[int]]:
    """The rank lists of the data×seq groups: ranks that share their
    stage, expert and model coordinates, data-major."""
    d, s = AXES.index("data"), AXES.index("seq")
    size = grid.shape[d] * grid.shape[s]
    return np.moveaxis(grid, (d, s), (-2, -1)).reshape(-1, size).tolist()


#: Seconds a rank waits for a peer, in a collective or while the group
#: forms, before it raises (TPUMON_DIST_TIMEOUT_S overrides): a rank
#: whose peer died or hangs exits non-zero instead of waiting forever.
#: Ranks wait at least this long for each other at the job's store
#: (:func:`env_store`): hosts start their ranks at their own pace.
GROUP_TIMEOUT_S = 600.0


def group_timeout() -> datetime.timedelta:
    """The process group's timeout: :data:`GROUP_TIMEOUT_S`, or
    ``$TPUMON_DIST_TIMEOUT_S`` seconds."""
    raw = os.environ.get("TPUMON_DIST_TIMEOUT_S")
    return datetime.timedelta(seconds=float(raw) if raw else GROUP_TIMEOUT_S)


def agree_backend(store, rank: int, world: int, device: torch.device,
                  local_world: int) -> str:
    """``nccl`` when every host has a card for each of its local ranks,
    else ``gloo``. Each rank posts on ``store`` (the job's, which every
    host reaches) whether its host has a card for each of the host's
    ``local_world`` ranks, then reads every rank's answer, so the ranks of
    every host pick the same backend before the group exists; a host
    deciding alone would pick nccl beside a gloo peer and hang."""
    own = device.type == "cuda" and torch.cuda.device_count() >= local_world
    store.set(f"backend/cards/{rank}", "1" if own else "0")
    keys = [f"backend/cards/{r}" for r in range(world)]
    store.wait(keys)
    backend = "nccl" if all(store.get(key) == b"1" for key in keys) else "gloo"
    log.info("backend %s: %d ranks, %d on this host on %s (%d CUDA devices)",
             backend, world, local_world, device.type, torch.cuda.device_count())
    return backend


def init_group(store, rank: int, world: int, device: torch.device,
               local_world: int) -> str:
    """Join the job's default process group on ``store`` with the backend
    the hosts agree on (:func:`agree_backend`) and the finite
    :func:`group_timeout`; returns the backend."""
    backend = agree_backend(store, rank, world, device, local_world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=group_timeout())
    return backend


def env_store(rank: int, world: int) -> "dist.TCPStore":
    """The job's store at ``$MASTER_ADDR:$MASTER_PORT`` (the coordinator
    of a multi-host job), hosted by global rank 0 as ``env://`` does, or
    by torchrun's agent when it says it hosts one. Its waits (every rank's
    connection, :func:`agree_backend`'s) last at least GROUP_TIMEOUT_S."""
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == str(True)
    timeout = max(group_timeout(), datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                         world, is_master=rank == 0 and not agent, timeout=timeout)


def rank_device(platform: str, local_rank: int) -> torch.device:
    """The device of a rank that is ``local_rank`` on its host: the host,
    or card ``local_rank % device_count`` (raises when a card is asked for
    and there is none)."""
    if platform == "cpu":
        return resolve_device("cpu")
    if not torch.cuda.is_available():
        return resolve_device("cuda")  # raises, naming what is missing
    return resolve_device("cuda", local_rank % torch.cuda.device_count())


def rank_cards(mesh: "Mesh") -> list[tuple[int, torch.device]]:
    """(host, device) of every rank of ``mesh``: global rank r is local
    rank r % local_world on host r // local_world (the launcher's
    layout), and every host has this host's devices. Ranks may share a
    card; card 0 of two hosts is two cards."""
    return [(r // mesh.local_world,
             rank_device(mesh.device.type, r % mesh.local_world))
            for r in mesh.ranks]


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the mesh: the axis sizes, its coordinates, its
    card, and the process group of each axis it is on (None for an axis
    of size 1), plus ``data_seq``, the gradient bucket's group. ``ranks``
    are the global ranks the mesh is laid out over, ``rank`` this rank's
    place among them (its checkpoint shard), ``local_world`` the ranks a
    host runs."""

    shape: dict[str, int]
    coords: dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: dict[str, object]
    counters: CollectiveCounters
    ranks: list[int] = dataclasses.field(default_factory=list)
    local_world: int = 1

    @property
    def dp(self) -> int:
        return self.shape["data"]

    @property
    def tp(self) -> int:
        return self.shape["model"]

    @property
    def sp(self) -> int:
        return self.shape["seq"]

    @property
    def ep(self) -> int:
        return self.shape["expert"]

    @property
    def pp(self) -> int:
        return self.shape["stage"]


def make_mesh(dp: int, tp: int, sp: int = 1, pp: int = 1, ep: int = 1, *,
              device: torch.device, counters: CollectiveCounters | None = None,
              ranks=None, local_world: int | None = None) -> "Mesh | None":
    """This rank's :class:`Mesh` over the initialized default process
    group. The mesh takes the whole world, or the global ``ranks`` given
    (laid out in that order). Every rank of the world calls it with the
    same arguments and creates every axis group, in the same order, as
    ``new_group`` requires; a rank outside ``ranks`` gets None.
    ``local_world`` is the ranks a host runs (default: the world, one
    host)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(harness.main starts one per rank)")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    total = dp * tp * sp * pp * ep
    if total != len(ranks) or len(set(ranks)) != total or not set(ranks) <= set(range(world)):
        raise ValueError(
            f"mesh dp={dp} pp={pp} ep={ep} sp={sp} tp={tp} needs {total} "
            f"distinct ranks of the world of {world}, got {len(ranks)}"
            + ("" if len(ranks) != world else
               ": start one process per mesh position")
        )
    rank = dist.get_rank()
    timeout = group_timeout()  # new_group does not inherit the world's
    grid = np.asarray(ranks).reshape(dp, pp, ep, sp, tp)
    groups: dict[str, object] = {}
    for axis, size in zip(AXES, grid.shape):
        groups[axis] = None
        if size == 1:
            continue
        for members in axis_groups(grid, axis):
            group = dist.new_group(members, timeout=timeout)
            if rank in members:
                groups[axis] = group
    groups["data_seq"] = groups["data"] if sp == 1 else groups["seq"]
    if dp > 1 and sp > 1:
        for members in data_seq_groups(grid):
            group = dist.new_group(members, timeout=timeout)
            if rank in members:
                groups["data_seq"] = group
    if rank not in ranks:
        return None
    where = np.argwhere(grid == rank)[0]
    place = ranks.index(rank)
    return Mesh(
        shape=dict(zip(AXES, grid.shape)),
        coords={axis: int(c) for axis, c in zip(AXES, where)},
        rank=place, device=torch.device(device), backend=dist.get_backend(),
        groups=groups, counters=counters or CollectiveCounters(rank=place),
        ranks=ranks, local_world=world if local_world is None else local_world,
    )


# ---------------------------------------------------------------------------
# Megatron splits
# ---------------------------------------------------------------------------

#: The mesh axis each dim of a dense parameter is split over, None for a
#: replicated dim (``param_specs``): column splits on the output dim, row
#: splits on the input dim, the vocabulary in embed and unembed.
#: Parameters not named are replicated.
PARAM_SPECS: dict[str, tuple] = {
    "embed": ("model", None), "unembed": (None, "model"),
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "w_gate": (None, "model"), "w_up": (None, "model"), "w_down": ("model", None),
}

#: The MoE model's (``moe_param_specs``): expert banks [E, D, F] / [E, F,
#: D] split on E over ``expert`` and on F over ``model``; the router is
#: replicated.
MOE_PARAM_SPECS: dict[str, tuple] = {
    **PARAM_SPECS,
    "w_gate": ("expert", None, "model"), "w_up": ("expert", None, "model"),
    "w_down": ("expert", "model", None),
}


def split_dim(name: str, specs: dict[str, tuple], axis: str = "model") -> int | None:
    """The dim of parameter ``name`` (a state-dict key) split over ``axis``."""
    spec = specs.get(name.rsplit(".", 1)[-1], ())
    return spec.index(axis) if axis in spec else None


def local_shape(name: str, shape, specs: dict[str, tuple], tp: int,
                ep: int = 1) -> tuple:
    """``shape`` with the dims of ``name`` split over model divided by
    ``tp`` and over expert by ``ep``."""
    shape = list(shape)
    for axis, n in (("expert", ep), ("model", tp)):
        dim = split_dim(name, specs, axis)
        if dim is not None and n > 1:
            if shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} ({shape[dim]}) must divide "
                                 f"by {'tp' if axis == 'model' else 'ep'} ({n})")
            shape[dim] //= n
    return tuple(shape)


def layer_index(name: str) -> int | None:
    """The global layer of a state-dict key ``blocks.<i>.<param>``, None
    for a parameter outside the layers."""
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "blocks" and len(parts) > 2 else None


def shard_params(tree: dict, mesh: Mesh, specs: dict[str, tuple],
                 layers=None) -> dict:
    """The rank's slice of each parameter of the full ``tree`` (a state
    dict that every rank drew from the same seed, as the reference's
    multi-process ``shard_tree`` does), on its expert and model
    coordinates. ``layers`` (the global layers of the rank's pipeline
    stage, ``parallel.pipeline.stage_layers``) drops the other stages'
    layers; the parameters outside the layers are kept on every stage."""
    out = {}
    for name, value in tree.items():
        index = layer_index(name)
        if layers is not None and index is not None and index not in layers:
            continue
        for axis in ("expert", "model"):
            dim = split_dim(name, specs, axis)
            if dim is not None and mesh.shape[axis] > 1:
                value = value.chunk(mesh.shape[axis], dim=dim)[mesh.coords[axis]]
        out[name] = value.clone()
    return out


# ---------------------------------------------------------------------------
# Collectives (counted)
# ---------------------------------------------------------------------------

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """All-reduce ``t`` in place over ``axis``; returns ``t``."""
    group = mesh.groups[axis]
    if group is None:
        return t
    with mesh.counters.span("all-reduce", t.numel() * t.element_size(), t.device):
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Every rank's ``t`` over ``axis``, in rank order (the list form,
    which gloo takes for CUDA tensors)."""
    group = mesh.groups[axis]
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    with mesh.counters.span("all-gather", t.numel() * t.element_size(), t.device):
        dist.all_gather(out, t.contiguous(), group=group)
    return out


def _exchange(send, dst, recv, src, group) -> None:
    """One send and one receive in a batch (either may be absent); peers
    are coordinates on ``group``."""
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def permute(t: torch.Tensor, mesh: Mesh, axis: str, pairs) -> torch.Tensor:
    """``lax.ppermute`` over ``axis``: ``pairs`` are (source, destination)
    coordinates on the axis, a partial permutation. Returns what this
    rank receives (zeros when no pair names it as a destination), a new
    tensor. A pair from this rank to itself is a local copy, neither sent
    nor counted; any other exchange counts one ``collective-permute`` of
    ``t``'s bytes.

    Over nccl the tensors go as they are. Over gloo a CUDA tensor is
    staged through host memory explicitly (copied to the host, sent and
    received there, copied back): gloo's send and receive take a raw data
    pointer, and a device pointer is not something to hand them."""
    me = mesh.coords[axis]
    dst = next((b for a, b in pairs if a == me), None)
    src = next((a for a, b in pairs if b == me), None)
    if dst == me and src == me:
        return t.clone()
    t = t.contiguous()
    if src is None:
        out = torch.zeros_like(t)
    else:
        out = torch.empty_like(t)
    group = mesh.groups[axis]
    with mesh.counters.span("collective-permute", t.numel() * t.element_size(), t.device):
        if mesh.backend == "gloo" and t.device.type == "cuda":
            host = torch.empty_like(out, device="cpu") if src is not None else None
            _exchange(t.cpu() if dst is not None else None, dst, host, src, group)
            if host is not None:
                out.copy_(host)
        else:
            _exchange(t, dst, out, src, group)
    return out


class _CopyTo(torch.autograd.Function):
    """Megatron's f over ``axis``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g over ``axis``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOverDataSeq(torch.autograd.Function):
    """The mean over data×seq ranks forward; identity backward, which is
    the mean of the ranks' upstream gradients when, as for a loss term
    that every rank computes from the same reduced value, they agree."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = all_reduce(x.clone(memory_format=torch.contiguous_format),
                         mesh, "data_seq")
        return out.div_(mesh.dp * mesh.sp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """The whole sequence of ``x`` [B, S/sp, ...] over seq forward (one
    all-gather); the backward returns this rank's own rows of the
    gradient, with no communication: the caller keeps only its rows of
    whatever it computes from the gathered tensor, row by row."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.coord = x.shape[1], mesh.coords["seq"]
        return torch.cat(all_gather(x, mesh, "seq"), dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.coord * ctx.rows, ctx.rows), None


def mean_over_data_seq(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean over the data×seq ranks of a statistic of the rank's
    tokens that a loss term needs over the whole batch (the MoE aux loss's
    routed fractions and mean probabilities): every axis the tokens are
    split on. Tokens are replicated over expert and model."""
    if mesh is None or mesh.groups["data_seq"] is None:
        return x
    return _MeanOverDataSeq.apply(x, mesh)


def gather_seq(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` [B, S/sp, ...] → [B, S, ...], the rows of every seq rank in
    order (:class:`_GatherSeq`)."""
    if mesh is None or mesh.groups["seq"] is None:
        return x
    return _GatherSeq.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The input of a column split (its gradient sums over model)."""
    if mesh is None or mesh.groups["model"] is None:
        return x
    return _CopyTo.apply(x, mesh, "model")


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum over model of a row split's partial outputs."""
    if mesh is None or mesh.groups["model"] is None:
        return x
    return _ReduceFrom.apply(x, mesh, "model")


def copy_to_stage(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The pipe's input, replicated over stage: only the first stage
    reads it, and its gradient sums over stage (the other stages add
    zeros)."""
    if mesh is None or mesh.groups["stage"] is None:
        return x
    return _CopyTo.apply(x, mesh, "stage")


def reduce_from_stage(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum over stage of the stages' parts (the pipe's output, which
    only the last stage holds, and the stages' MoE aux losses); every
    stage computes the same loss from it, so its gradient enters each
    stage once."""
    if mesh is None or mesh.groups["stage"] is None:
        return x
    return _ReduceFrom.apply(x, mesh, "stage")


def _stage_ring(pp: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % pp) for i in range(pp)]


class _StageHop(torch.autograd.Function):
    """One hop around the stage ring: each stage sends ``y`` to the next
    (the last to the first) and returns what the previous one sent; the
    backward sends the gradient back the other way."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return permute(y, mesh, "stage", _stage_ring(mesh.pp))

    @staticmethod
    def backward(ctx, g):
        inverse = [(b, a) for a, b in _stage_ring(ctx.mesh.pp)]
        return permute(g, ctx.mesh, "stage", inverse), None


def stage_hop(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``lax.ppermute`` of ``y`` over the full stage ring (one counted
    ``collective-permute``; :class:`_StageHop`)."""
    return _StageHop.apply(y, mesh)


def copy_to_expert(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """A tensor replicated over expert whose uses on each expert rank
    reach only that rank's experts (its gradient sums over expert)."""
    if mesh is None or mesh.groups["expert"] is None:
        return x
    return _CopyTo.apply(x, mesh, "expert")


def reduce_from_expert(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum over expert of the ranks' partial MoE outputs (each from
    its own experts): the combine."""
    if mesh is None or mesh.groups["expert"] is None:
        return x
    return _ReduceFrom.apply(x, mesh, "expert")


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------


def zero1_dim(shape, skip: int | None, dp: int) -> int | None:
    """The dim ZeRO-1 shards a leaf on: the first not split over model
    that divides by ``dp``; None keeps the leaf whole."""
    return next((i for i, n in enumerate(shape) if i != skip and n % dp == 0),
                None)


class Zero1:
    """ZeRO-1 (``zero1_shard_opt_state``): each data rank keeps the
    optimizer state of 1/dp of every leaf and steps the inner optimizer
    on that slice, then one all-gather over ``data`` of the updated slices
    (one flat bucket) writes every rank's slices back into the
    parameters, which stay replicated over data. A leaf with no divisible
    dim is stepped whole on every data rank.

    It exposes what the harness and the checkpoint use of a torch
    optimizer: ``zero_grad``, ``step``, ``state_dict``, ``load_state_dict``,
    ``param_groups`` and ``state``."""

    def __init__(self, named_params, mesh: Mesh, make_inner,
                 specs: dict[str, int]) -> None:
        if mesh.dp < 2:
            raise ValueError("zero1 shards optimizer state over dp; it "
                             "needs a mesh with dp > 1")
        self.mesh = mesh
        self.names, self.params, self.dims, self.shards = [], [], [], []
        dp, d = mesh.dp, mesh.coords["data"]
        for name, p in named_params:
            dim = zero1_dim(p.shape, split_dim(name, specs), dp)
            if dim is None:
                shard = p
            else:
                n = p.shape[dim] // dp
                shard = p.detach().narrow(dim, d * n, n).clone()
            self.names.append(name)
            self.params.append(p)
            self.dims.append(dim)
            self.shards.append(shard)
        self.inner = make_inner(self.shards)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    def _slices(self, t, dim):
        n = t.shape[dim] // self.mesh.dp
        return [t.narrow(dim, r * n, n) for r in range(self.mesh.dp)]

    @torch.no_grad()
    def step(self) -> None:
        d = self.mesh.coords["data"]
        for p, dim, shard in zip(self.params, self.dims, self.shards):
            if dim is not None:
                shard.grad = self._slices(p.grad, dim)[d].contiguous()
        self.inner.step()
        sharded = [(p, dim, s) for p, dim, s in
                   zip(self.params, self.dims, self.shards) if dim is not None]
        if not sharded:
            return
        flat = torch.cat([s.reshape(-1) for _, _, s in sharded])
        for r, part in enumerate(all_gather(flat, self.mesh, "data")):
            offset = 0
            for p, dim, s in sharded:
                n = s.numel()
                self._slices(p, dim)[r].copy_(part[offset:offset + n].view_as(s))
                offset += n

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load the inner optimizer's state; the slices are read again
        from the parameters (restore them first)."""
        d = self.mesh.coords["data"]
        for p, dim, shard in zip(self.params, self.dims, self.shards):
            if dim is not None:
                shard.copy_(self._slices(p, dim)[d])
        self.inner.load_state_dict(state)


__all__ = [
    "AXES",
    "MOE_PARAM_SPECS",
    "PARAM_SPECS",
    "Mesh",
    "Zero1",
    "all_gather",
    "all_reduce",
    "axis_groups",
    "GROUP_TIMEOUT_S",
    "agree_backend",
    "copy_to_expert",
    "copy_to_model",
    "copy_to_stage",
    "data_seq_groups",
    "env_store",
    "gather_seq",
    "group_timeout",
    "init_group",
    "layer_index",
    "layout",
    "local_shape",
    "make_mesh",
    "mean_over_data_seq",
    "permute",
    "rank_device",
    "rank_cards",
    "reduce_from_expert",
    "reduce_from_model",
    "reduce_from_stage",
    "shard_params",
    "split_dim",
    "stage_hop",
    "zero1_dim",
]
