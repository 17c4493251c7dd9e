"""Start one process per mesh position and watch them.

``harness.main`` with ``dp·tp·sp·pp·ep > 1`` and no ``RANK`` in its
environment calls :func:`launch` to start the mesh's processes with the ``spawn``
method (never ``fork``); each re-enters ``main`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set and joins an
``env://`` process group. :func:`spawn` starts a function on every rank
of a group that meets at a file (``file://``), which is how the tests run
several mesh checks in one start.

A rank that fails ends the run: the others get SIGTERM, then SIGKILL
after a grace period, and the exit code is the worst of the ranks'. No
rank is waited on forever.
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


def supervise(procs, results, timeout_s: float | None = None) -> tuple[list[int], dict]:
    """Wait for every process, reading ``results`` (a queue of (rank,
    payload)) as it goes, so no writer blocks on a full pipe. When one
    exits non-zero (or ``timeout_s`` passes) the rest are stopped.
    Returns the exit codes and {rank: payload}."""
    payloads: dict = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    stopping_since = None

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
        if (failed or late) and stopping_since is None:
            if late:
                log.error("mesh ranks still running after %.0f s; stopping them",
                          timeout_s)
            stopping_since = time.monotonic()
            for p in procs:
                if p.is_alive():
                    p.terminate()
        if stopping_since is not None and time.monotonic() - stopping_since > KILL_GRACE_S:
            for p in procs:
                if p.is_alive():
                    p.kill()
    for p in procs:
        p.join()
    drain(0.0)
    return [_exit_code(p.exitcode) for p in procs], payloads


def launch(target, argv: list[str], world: int) -> tuple[int, dict]:
    """Run ``target(argv, env, results)`` in ``world`` spawned processes,
    rank r with ``env`` = RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT for
    an ``env://`` group on this host. SIGTERM to this process is passed
    on to the ranks. Returns (the worst exit code, {rank: report})."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = []
    for rank in range(world):
        env = {"RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(ctx.Process(target=target, args=(argv, env, results),
                                 name=f"mesh-rank{rank}"))
    for p in procs:
        p.start()

    def forward_term(signum, frame):
        for p in procs:
            if p.is_alive():
                p.terminate()

    try:
        previous = signal.signal(signal.SIGTERM, forward_term)
    except ValueError:
        previous = None  # not the main thread: nothing to forward from
    try:
        codes, reports = supervise(procs, results)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    log.info("mesh of %d ranks exited with %s", world, codes)
    return max(codes), reports


def _spawned(target, rank, world, init_file, args, threads, results) -> None:
    import torch
    import torch.distributed as dist

    from tpumon.workload_torch.parallel.mesh import backend_for

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend_for(world, torch.device("cpu")),
            init_method=f"file://{init_file}", rank=rank, world_size=world,
        )
        try:
            payload = ("ok", target(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, ("error", traceback.format_exc())))
        raise
    results.put((rank, payload))


def spawn(target, world: int, init_file: str, args: tuple = (), *,
          threads: int = 1, timeout_s: float = 300.0) -> list:
    """``target(rank, world, *args)`` on ``world`` spawned CPU ranks in a
    gloo group that meets at ``init_file`` (a path that does not exist
    yet); returns each rank's value, in rank order. Raises RuntimeError
    with the traceback when a rank fails."""
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists: use a fresh path")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spawned, name=f"mesh-rank{rank}",
                         args=(target, rank, world, init_file, args, threads,
                               results))
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
