"""Start one process per mesh position and watch them.

``harness.main`` with ``dp·tp·sp·pp·ep > 1`` and no ``RANK`` in its
environment calls :func:`launch` to start this host's processes of the
mesh with the ``spawn`` method (never ``fork``); each re-enters ``main``
with ``RANK`` (global), ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set and joins
the job's group at that address (``parallel.mesh.env_store``). One host
starts every rank and takes a free port on this machine; a host of a
multi-host job starts its ``world / num_processes`` ranks, process i's
local rank j as global rank i·local + j, and all meet at the
coordinator, where global rank 0 (on process 0) hosts the store.
:func:`spawn` starts a function on every rank of a group that meets at a
file, which is how the tests and the dryrun run several mesh jobs in one
start.

A rank that fails ends the run: the others get SIGTERM, then SIGKILL
after a grace period, and the exit code is the worst of the ranks'. No
rank is waited on forever; a rank whose peer on another host died or
hangs raises after the group's timeout (``parallel.mesh.group_timeout``).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue as queue_mod
import signal
import socket
import time
import traceback

log = logging.getLogger(__name__)

#: Seconds a rank gets to exit after SIGTERM before it is killed (rank 0
#: holds its page up for TPUMON_STEP_TERM_GRACE_S, 5 s by default).
KILL_GRACE_S = 30.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_code(code: int | None) -> int:
    """A process's exit code as a shell reports it (a signal n as 128+n)."""
    if code is None:
        return 1
    return 128 - code if code < 0 else code


def supervise(procs, results, timeout_s: float | None = None,
              stop: dict | None = None) -> tuple[list[int], dict]:
    """Wait for every process, reading ``results`` (a queue of (rank,
    payload)) as it goes, so no writer blocks on a full pipe. When one
    exits non-zero (or ``timeout_s`` passes) the rest are stopped: SIGTERM,
    then SIGKILL after :data:`KILL_GRACE_S`. ``stop["since"]``, set by a
    caller that already sent SIGTERM to every process, starts that grace
    period without a second SIGTERM (which a rank's SIGTERM marker takes
    as "exit now"). Returns the exit codes and {rank: payload}."""
    payloads: dict = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    stop = {} if stop is None else stop

    def drain(wait: float) -> None:
        try:
            while True:
                rank, payload = results.get(timeout=wait)
                payloads[rank] = payload
                wait = 0.0
        except queue_mod.Empty:
            pass

    while any(p.is_alive() for p in procs):
        drain(0.2)
        failed = any(p.exitcode not in (None, 0) for p in procs)
        late = deadline is not None and time.monotonic() > deadline
        if (failed or late) and stop.get("since") is None:
            if late:
                log.error("mesh ranks still running after %.0f s; stopping them",
                          timeout_s)
            stop["since"] = time.monotonic()
            for p in procs:
                if p.is_alive():
                    p.terminate()
        if stop.get("since") is not None and time.monotonic() - stop["since"] > KILL_GRACE_S:
            for p in procs:
                if p.is_alive():
                    p.kill()
    for p in procs:
        p.join()
    drain(0.0)
    return [_exit_code(p.exitcode) for p in procs], payloads


def launch(target, argv: list[str], world: int, *, coordinator: str | None = None,
           num_processes: int = 1, process_id: int = 0) -> tuple[int, dict]:
    """Run ``target(argv, env, results)`` in this host's spawned ranks of
    a job of ``world`` ranks: all of them, meeting at a free port on this
    machine, or, with ``coordinator`` ("host:port"), the
    ``world / num_processes`` ranks of host ``process_id``, meeting
    there. ``env`` holds RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT. SIGTERM to this process is passed on to
    the ranks. Returns (the worst exit code, {global rank: report})."""
    local = world // num_processes
    if coordinator is None:
        addr, port = "127.0.0.1", free_port()
    else:
        addr, _, port = coordinator.rpartition(":")
        port = int(port)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for j in range(local):
        rank = process_id * local + j
        env = {"RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(j), "LOCAL_WORLD_SIZE": str(local),
               "MASTER_ADDR": addr, "MASTER_PORT": str(port)}
        procs.append(ctx.Process(target=target, args=(argv, env, results),
                                 name=f"mesh-rank{rank}"))
    for p in procs:
        p.start()
    stop: dict = {}

    def forward_term(signum, frame):
        stop.setdefault("since", time.monotonic())
        for p in procs:
            if p.is_alive():
                p.terminate()

    try:
        previous = signal.signal(signal.SIGTERM, forward_term)
    except ValueError:
        previous = None  # not the main thread: nothing to forward from
    try:
        codes, reports = supervise(procs, results, stop=stop)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    log.info("mesh of %d ranks (%d on this host) exited with %s", world,
             local, codes)
    return max(codes), reports


def _spawned(target, rank, world, init_file, args, threads, platform,
             results) -> None:
    import torch
    import torch.distributed as dist

    from tpumon.workload_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(threads)
    try:
        device = mesh_mod.rank_device(platform, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh_mod.init_group(dist.FileStore(init_file, world), rank, world,
                            device, world)
        try:
            payload = ("ok", target(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, ("error", traceback.format_exc())))
        raise
    results.put((rank, payload))


def spawn(target, world: int, init_file: str, args: tuple = (), *,
          threads: int = 1, timeout_s: float = 300.0,
          platform: str = "cpu") -> list:
    """``target(rank, world, *args)`` on ``world`` spawned ranks of one
    host in a group that meets at ``init_file`` (a path that does not
    exist yet): on the CPU over gloo, or on the cards (``platform``
    "cuda": rank r on card r % device_count, nccl when each has its own,
    gloo when they share); returns each rank's value, in rank order.
    Raises RuntimeError with the traceback when a rank fails."""
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists: use a fresh path")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spawned, name=f"mesh-rank{rank}",
                         args=(target, rank, world, init_file, args, threads,
                               platform, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    codes, payloads = supervise(procs, results, timeout_s)
    errors = [f"rank {r}:\n{payloads[r][1]}" for r in sorted(payloads)
              if payloads[r][0] == "error"]
    if errors or any(codes) or len(payloads) != world:
        raise RuntimeError(f"mesh ranks failed (exit codes {codes})\n"
                           + "\n".join(errors))
    return [payloads[r][1] for r in range(world)]


__all__ = ["KILL_GRACE_S", "free_port", "launch", "spawn", "supervise"]
