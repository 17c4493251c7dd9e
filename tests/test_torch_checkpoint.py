"""Checkpoint/resume of the port's harness (the reference's cases,
tests/test_checkpoint.py, plus the storage's own rules).

The contract: a run stopped and resumed replays the per-step losses of an
uninterrupted one (the same seeded data, the train state restored bit for
bit), at the reference's tolerance rel 1e-6; the page shows the save and
restore spans and a step counter that counts on from the restored step.
"""

from __future__ import annotations

import os
import pickle

import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.checkpoint import STATE_FILE, CheckpointStore  # noqa: E402
from tpumon.workload_torch.models.llama import LlamaConfig  # noqa: E402
from tpumon.workload_torch.models.moe import MoeConfig  # noqa: E402

CONFIGS = {"llama": LlamaConfig.tiny, "moe": MoeConfig.tiny}


def _run(ckpt, steps, every=0, model="llama", **kw):
    kw.setdefault("device", "cpu")
    return harness.run(
        CONFIGS[model](), steps=steps, batch=2, seq=32,
        checkpoint_dir=str(ckpt), checkpoint_every=every, **kw,
    )


@pytest.mark.parametrize("model", ["llama", "moe"])
def test_resume_replays_uninterrupted_losses(tmp_path, model):
    full = _run(tmp_path / "full", steps=6, model=model)
    assert len(full.losses) == 6
    assert full.start_step == 0

    # A "preempted" run: 3 steps, saved at the end.
    part = _run(tmp_path / "resume", steps=3, model=model)
    assert part.losses == pytest.approx(full.losses[:3], rel=1e-6)

    # Resumed in a fresh call: it picks up at step 3 and runs steps 3-5.
    cont = _run(tmp_path / "resume", steps=6, model=model)
    assert cont.start_step == 3
    assert len(cont.losses) == 3
    assert cont.losses == pytest.approx(full.losses[3:], rel=1e-6)


def test_periodic_saves_and_noop_resume(tmp_path):
    r = _run(tmp_path / "ckpt", steps=4, every=2)
    assert len(r.losses) == 4
    assert CheckpointStore(tmp_path / "ckpt").steps() == [2, 4]

    # A run the checkpoint already covers: nothing left to run, no crash.
    again = _run(tmp_path / "ckpt", steps=4)
    assert again.start_step == 4
    assert again.losses == []
    assert again.steps_per_sec == 0.0


def test_keeps_only_the_two_newest_steps(tmp_path):
    _run(tmp_path / "ckpt", steps=5, every=1)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4", "5"]


def test_tmp_of_a_killed_save_is_ignored(tmp_path):
    """A save killed before its rename leaves ``<step>.tmp``: no reader
    takes it for a step, and the resume starts from the last whole one."""
    root = tmp_path / "ckpt"
    _run(root, steps=2)
    os.makedirs(root / "3.tmp")
    with open(root / "3.tmp" / STATE_FILE, "wb") as f:
        f.write(b"half a file")
    store = CheckpointStore(root)
    assert store.steps() == [2] and store.latest_step() == 2
    cont = _run(root, steps=3)
    assert cont.start_step == 2 and len(cont.losses) == 1
    assert store.steps() == [2, 3]


def test_failed_restore_raises(tmp_path):
    """The loop never carries on from a checkpoint it could not read."""
    root = tmp_path / "ckpt"
    _run(root, steps=2)
    with open(root / "2" / STATE_FILE, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(pickle.UnpicklingError):
        _run(root, steps=4)


def test_page_shows_spans_and_offset_step(tmp_path):
    from prometheus_client import generate_latest
    from prometheus_client.registry import CollectorRegistry

    from tpumon.lifecycle.probe import step_snapshot_from_text
    from tpumon.workload_torch.stats import StatsCollector, WorkloadStats

    _run(tmp_path / "ckpt", steps=2)
    stats = WorkloadStats()
    registry = CollectorRegistry()
    registry.register(StatsCollector(stats))
    cont = _run(tmp_path / "ckpt", steps=5, every=1, stats=stats,
                phase_stats=True)
    assert cont.start_step == 2
    snap = step_snapshot_from_text(generate_latest(registry).decode())
    assert snap["step"] == 5  # the training-global step, not 3
    assert snap["loss"] == pytest.approx(cont.losses[-1])
    assert snap["checkpoints"]["restore"]["count"] == 1
    assert snap["checkpoints"]["save"]["count"] == 3  # steps 3, 4, 5
    assert snap["checkpoints"]["save"]["last_s"] > 0
    assert snap["step_seconds"] > 0
    assert set(snap["phases"]) == {"fwd", "bwd", "optimizer"}


def test_serve_with_checkpoint_dir_is_rejected(tmp_path, capsys):
    from tpumon.workload_torch.serve import ServeStats

    with pytest.raises(ValueError, match="windowed"):
        _run(tmp_path / "ckpt", steps=1, serve=ServeStats())
    with pytest.raises(SystemExit) as exc:
        harness.main(["--platform", "cpu", "--serve", "--metrics-port", "1",
                      "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert exc.value.code == 2
    assert "--checkpoint-dir" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "ckpt")


def test_cli_resumes(tmp_path, caplog):
    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    argv = ["--platform", "cpu", "--model", "moe", "--batch", "2", "--seq",
            "32", "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert harness.main([*argv, "--steps", "2"]) == 0
    assert harness.main([*argv, "--steps", "3", "--checkpoint-every", "1"]) == 0
    assert any("resumed from" in r.getMessage() for r in caplog.records)
    assert CheckpointStore(tmp_path / "ckpt").steps() == [2, 3]


@pytest.mark.cuda
def test_resume_replays_on_card(tmp_path):
    """On the card, through the flash kernels (head_dim 64): the resumed
    losses equal the uninterrupted run's at rel 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    import dataclasses

    cfg = dataclasses.replace(MoeConfig.tiny(), dim=256)
    kw = dict(batch=4, seq=128, grad_accum=2, remat=True, attn="flash",
              device="cuda")
    full = harness.run(cfg, steps=4, checkpoint_dir=str(tmp_path / "f"), **kw)
    harness.run(cfg, steps=2, checkpoint_dir=str(tmp_path / "r"), **kw)
    cont = harness.run(cfg, steps=4, checkpoint_dir=str(tmp_path / "r"), **kw)
    assert cont.start_step == 2
    assert cont.losses == pytest.approx(full.losses[2:], rel=1e-6)
