"""Checkpoint storage for the port's train loop (the reference uses orbax).

One directory per saved step under the checkpoint root, named by the
step (``<root>/4/state.pt``), holding one ``torch.save`` of
``{"params": model.state_dict(), "opt_state": optimizer.state_dict()}``.
A save writes ``<root>/<step>.tmp/`` and renames it into place with
``os.replace``, so a save killed half way leaves a ``.tmp`` directory that
no reader takes for a step. The :data:`MAX_TO_KEEP` newest steps are kept.

No RNG state is saved: the harness draws its token batch once from the
seed before the loop, and nothing in a step draws random numbers.
"""

from __future__ import annotations

import os
import shutil

import torch

STATE_FILE = "state.pt"
#: Saved steps kept, as the reference's orbax options keep them.
MAX_TO_KEEP = 2


class CheckpointStore:
    """The saved steps under ``root`` (created on first save)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)

    def steps(self) -> list[int]:
        """The complete saved steps, oldest first."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            int(name) for name in os.listdir(self.root)
            if name.isdigit()
            and os.path.isfile(os.path.join(self.root, name, STATE_FILE))
        )

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, optimizer) -> None:
        """Write ``step`` atomically, then drop all but the newest
        :data:`MAX_TO_KEEP` steps."""
        final = os.path.join(self.root, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        state = {"params": model.state_dict(), "opt_state": optimizer.state_dict()}
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(self.root, str(old)))

    def restore(self, step: int, model, optimizer, device) -> None:
        """Load ``step`` into ``model`` and ``optimizer`` in place. Raises
        when the step is missing or does not fit the model."""
        path = os.path.join(self.root, str(step), STATE_FILE)
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


__all__ = ["MAX_TO_KEEP", "CheckpointStore", "STATE_FILE"]
