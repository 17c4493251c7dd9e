"""Checkpoint storage for the port's train loop (the reference uses orbax).

One directory per saved step under the checkpoint root, named by the
step (``<root>/4/state.pt``), holding one ``torch.save`` of
``{"params": model.state_dict(), "opt_state": optimizer.state_dict()}``.
A save writes ``<root>/<step>.tmp/`` and renames it into place with
``os.replace``, so a save killed half way leaves a ``.tmp`` directory that
no reader takes for a step. The :data:`MAX_TO_KEEP` newest steps are kept.

No RNG state is saved: the harness draws its token batch once from the
seed before the loop, and nothing in a step draws random numbers.

On a mesh each rank writes its own model and optimizer shard,
``<step>.tmp/rank<r>.pt`` (under pp, its stage's layers under their
global names); after a barrier rank 0 writes ``mesh.json`` (dp, tp, sp,
ep, zero1, pp, interleave, microbatches) and renames the directory into
place. A resume needs the same layout and raises otherwise.
"""

from __future__ import annotations

import json
import os
import shutil

import torch
import torch.distributed as dist

STATE_FILE = "state.pt"
#: A mesh checkpoint's layout (dp, tp, sp, ep, zero1, pp, interleave,
#: microbatches), written last by rank 0.
MESH_FILE = "mesh.json"
#: Saved steps kept, as the reference's orbax options keep them.
MAX_TO_KEEP = 2


def rank_file(rank: int) -> str:
    return f"rank{rank}.pt"


class CheckpointStore:
    """The saved steps under ``root`` (created on first save). ``mesh``
    (this rank's ``parallel.mesh.Mesh``) makes it the store of one rank's
    shards; ``zero1``, and under pp the schedule's ``interleave`` and
    ``microbatches`` (1 and 1 without pp), are part of the mesh layout a
    resume must match."""

    def __init__(self, root: str, mesh=None, zero1: bool = False,
                 interleave: int = 1, microbatches: int = 1) -> None:
        self.root = os.path.abspath(root)
        self.mesh = mesh
        self.layout = None if mesh is None else {
            "dp": mesh.dp, "tp": mesh.tp, "sp": mesh.sp, "ep": mesh.ep,
            "zero1": bool(zero1), "pp": getattr(mesh, "pp", 1),
            "interleave": interleave, "microbatches": microbatches}

    def steps(self) -> list[int]:
        """The complete saved steps, oldest first."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            int(name) for name in os.listdir(self.root)
            if name.isdigit() and any(
                os.path.isfile(os.path.join(self.root, name, f))
                for f in (STATE_FILE, MESH_FILE))
        )

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, optimizer) -> None:
        """Write ``step`` atomically, then drop all but the newest
        :data:`MAX_TO_KEEP` steps. On a mesh every rank calls it."""
        final = os.path.join(self.root, str(step))
        tmp = final + ".tmp"
        lead = self.mesh is None or self.mesh.rank == 0
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        if self.mesh is not None:
            dist.barrier()  # the directory exists before any rank writes
        name = STATE_FILE if self.mesh is None else rank_file(self.mesh.rank)
        state = {"params": model.state_dict(), "opt_state": optimizer.state_dict()}
        with open(os.path.join(tmp, name), "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        if self.mesh is not None:
            dist.barrier()  # every shard is on disk
        if lead:
            if self.layout is not None:
                with open(os.path.join(tmp, MESH_FILE), "w") as f:
                    json.dump(self.layout, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.steps()[:-MAX_TO_KEEP]:
                shutil.rmtree(os.path.join(self.root, str(old)))
        if self.mesh is not None:
            dist.barrier()  # no rank reads the store before the rename

    def restore(self, step: int, model, optimizer, device) -> None:
        """Load ``step`` into ``model`` and ``optimizer`` in place. Raises
        when the step is missing, was saved on another mesh layout, or
        does not fit the model."""
        directory = os.path.join(self.root, str(step))
        mesh_path = os.path.join(directory, MESH_FILE)
        saved = None
        if os.path.isfile(mesh_path):
            with open(mesh_path) as f:
                saved = json.load(f)
            # Written before ep, then pp, was ported.
            for key in ("ep", "pp", "interleave", "microbatches"):
                saved.setdefault(key, 1)
        if saved != self.layout:
            def name(layout):
                return "one device" if layout is None else (
                    "dp={dp} tp={tp} zero1={zero1} sp={sp} ep={ep} pp={pp} "
                    "interleave={interleave} microbatches={microbatches}"
                    .format(**layout))
            raise ValueError(
                f"checkpoint step {step} in {self.root} was saved on "
                f"{name(saved)}; this run is {name(self.layout)}: a resume "
                "needs the same dp×tp×zero1, sp, ep and pipeline"
            )
        path = os.path.join(
            directory, STATE_FILE if self.mesh is None else rank_file(self.mesh.rank))
        state = torch.load(path, map_location=device)
        model.load_state_dict(state["params"])
        optimizer.load_state_dict(state["opt_state"])
        # torch keeps a step count on the host unless the optimizer is
        # capturable or fused; load_state_dict leaves each where
        # map_location put it, so put them back where a fresh one has them.
        for group in optimizer.param_groups:
            if group.get("capturable") or group.get("fused"):
                continue
            for p in group["params"]:
                per_param = optimizer.state.get(p, {})
                if torch.is_tensor(per_param.get("step")):
                    per_param["step"] = per_param["step"].cpu()


__all__ = ["MAX_TO_KEEP", "MESH_FILE", "CheckpointStore", "STATE_FILE", "rank_file"]
