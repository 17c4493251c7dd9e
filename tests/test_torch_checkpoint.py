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


def test_zero1_mesh_resume_replays_exactly(tmp_path):
    """dp=2×tp=2 with ZeRO-1 (the reference's
    ``test_zero1_resume_replays_exactly``): every rank saves and restores
    its own shard, and the resumed losses equal the uninterrupted run's
    bit for bit. A store of another layout refuses the steps."""
    import types

    from tpumon.workload_torch.checkpoint import MESH_FILE, rank_file
    from tpumon.workload_torch.parallel import checks, launch

    kw = dict(batch=8, seq=32, zero1=True, seed=3)

    def job(steps, directory, every=0):
        return dict(cfg=LlamaConfig.tiny(), dp=2, tp=2, kwargs=dict(
            steps=steps, checkpoint_dir=str(tmp_path / directory),
            checkpoint_every=every, **kw))

    ranks = launch.spawn(checks.run_jobs, 4, str(tmp_path / "rendezvous"), (
        [job(4, "f"), job(2, "r", every=2), job(4, "r")],))
    for full, part, cont in ranks:
        assert full["start_step"] == 0 and len(full["losses"]) == 4
        assert part["losses"] == full["losses"][:2]
        assert cont["start_step"] == 2
        assert cont["losses"] == full["losses"][2:]  # exact, not approx
    assert ranks[0][0]["losses"] == ranks[3][0]["losses"]
    step = tmp_path / "r" / "4"
    assert sorted(os.listdir(step)) == sorted(
        [MESH_FILE] + [rank_file(r) for r in range(4)])
    plain_dp = CheckpointStore(tmp_path / "r", zero1=False, mesh=types.SimpleNamespace(
        dp=2, tp=2, sp=1, ep=1, rank=0))
    with pytest.raises(ValueError, match="dp=2 tp=2 zero1=True"):
        plain_dp.restore(4, None, None, "cpu")
    with pytest.raises(ValueError, match="needs the same dp×tp×zero1"):
        _run(tmp_path / "r", steps=5)  # one device


def test_ring_mesh_checkpoint_carries_sp(tmp_path):
    """tp=2×sp=2 (zigzag ring): the resumed losses equal the
    uninterrupted run's bit for bit, ``mesh.json`` carries sp, and a
    resume onto another sp is refused."""
    import json
    import types

    from tpumon.workload_torch.checkpoint import MESH_FILE
    from tpumon.workload_torch.parallel import checks, launch

    def job(steps, directory, every=0):
        return dict(cfg=LlamaConfig.tiny(), dp=1, tp=2, sp=2, kwargs=dict(
            steps=steps, batch=2, seq=32, sp_layout="zigzag", seed=5,
            checkpoint_dir=str(tmp_path / directory), checkpoint_every=every))

    ranks = launch.spawn(checks.run_jobs, 4, str(tmp_path / "rendezvous"), (
        [job(3, "f"), job(2, "r", every=2), job(3, "r")],), timeout_s=120)
    for full, part, cont in ranks:
        assert part["losses"] == full["losses"][:2]
        assert cont["start_step"] == 2 and cont["losses"] == full["losses"][2:]
    with open(tmp_path / "r" / "3" / MESH_FILE) as f:
        assert json.load(f) == {"dp": 1, "tp": 2, "sp": 2, "ep": 1, "zero1": False,
                                "pp": 1, "interleave": 1, "microbatches": 1}
    other_sp = CheckpointStore(tmp_path / "r", mesh=types.SimpleNamespace(
        dp=1, tp=2, sp=1, ep=1, rank=0))
    with pytest.raises(ValueError, match="saved on dp=1 tp=2 zero1=False sp=2"):
        other_sp.restore(3, None, None, "cpu")


def test_expert_mesh_checkpoint_carries_ep(tmp_path):
    """dp=2×ep=2 MoE with ZeRO-1: each rank saves its own experts' banks
    and moments, the resumed losses equal the uninterrupted run's bit for
    bit, ``mesh.json`` carries ep, and a resume at another ep (or one from
    a layout written before ep was recorded, which reads as ep=1) is
    refused."""
    import json
    import types

    from tpumon.workload_torch.checkpoint import MESH_FILE
    from tpumon.workload_torch.parallel import checks, launch

    def job(steps, directory, every=0):
        return dict(cfg=MoeConfig.tiny(), dp=2, tp=1, ep=2, kwargs=dict(
            steps=steps, batch=4, seq=32, zero1=True, seed=7,
            checkpoint_dir=str(tmp_path / directory), checkpoint_every=every))

    ranks = launch.spawn(checks.run_jobs, 4, str(tmp_path / "rendezvous"), (
        [job(3, "f"), job(2, "r", every=2), job(3, "r")],), timeout_s=120)
    for full, part, cont in ranks:
        assert part["losses"] == full["losses"][:2]
        assert cont["start_step"] == 2 and cont["losses"] == full["losses"][2:]
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
    with open(tmp_path / "r" / "3" / MESH_FILE) as f:
        layout = json.load(f)
    assert layout == {"dp": 2, "tp": 1, "sp": 1, "ep": 2, "zero1": True,
                      "pp": 1, "interleave": 1, "microbatches": 1}
    other_ep = CheckpointStore(tmp_path / "r", zero1=True, mesh=types.SimpleNamespace(
        dp=2, tp=1, sp=1, ep=1, rank=0))
    with pytest.raises(ValueError, match="saved on dp=2 tp=1 zero1=True sp=1 ep=2"):
        other_ep.restore(3, None, None, "cpu")
    del layout["ep"]
    with open(tmp_path / "r" / "3" / MESH_FILE, "w") as f:
        json.dump(layout, f)
    at_ep2 = CheckpointStore(tmp_path / "r", zero1=True, mesh=types.SimpleNamespace(
        dp=2, tp=1, sp=1, ep=2, rank=0))
    with pytest.raises(ValueError, match="saved on dp=2 tp=1 zero1=True sp=1 ep=1"):
        at_ep2.restore(3, None, None, "cpu")


def test_pipeline_mesh_checkpoint_carries_pp(tmp_path):
    """pp=2×tp=2 on the circular schedule (interleave 2, 4 layers): each
    rank saves its stage's layers under their global names, the resumed
    losses equal the uninterrupted run's bit for bit, ``mesh.json``
    carries pp, interleave and microbatches, and a resume at another pp,
    interleave or microbatches (or one from a layout written before pp
    was recorded, which reads as pp=1) is refused."""
    import dataclasses
    import json
    import types

    from tpumon.workload_torch.checkpoint import MESH_FILE, rank_file
    from tpumon.workload_torch.parallel import checks, launch

    cfg = dataclasses.replace(LlamaConfig.tiny(), n_layers=4)

    def job(steps, directory, every=0):
        return dict(cfg=cfg, dp=1, tp=2, pp=2, interleave=2, microbatches=2,
                    kwargs=dict(steps=steps, batch=2, seq=32, seed=9,
                                checkpoint_dir=str(tmp_path / directory),
                                checkpoint_every=every))

    ranks = launch.spawn(checks.run_jobs, 4, str(tmp_path / "rendezvous"), (
        [job(3, "f"), job(2, "r", every=2), job(3, "r")],), timeout_s=120)
    for full, part, cont in ranks:
        assert part["losses"] == full["losses"][:2]
        assert cont["start_step"] == 2 and cont["losses"] == full["losses"][2:]
    assert ranks[0][0]["losses"] == ranks[3][0]["losses"]
    step = tmp_path / "r" / "3"
    with open(step / MESH_FILE) as f:
        layout = json.load(f)
    assert layout == {"dp": 1, "tp": 2, "sp": 1, "ep": 1, "zero1": False,
                      "pp": 2, "interleave": 2, "microbatches": 2}
    # Stage 1 (ranks 2 and 3) holds model blocks 1 and 3 (chunks 0 and 1).
    shard = torch.load(step / rank_file(2), map_location="cpu")["params"]
    assert {k.split(".")[1] for k in shard if k.startswith("blocks.")} == {"1", "3"}

    def store(**kw):
        mesh = dict(dp=1, tp=2, sp=1, ep=1, pp=2, rank=0)
        mesh.update(kw.pop("mesh", {}))
        return CheckpointStore(tmp_path / "r", mesh=types.SimpleNamespace(**mesh),
                               **{"interleave": 2, "microbatches": 2, **kw})

    saved_on = "saved on dp=1 tp=2 zero1=False sp=1 ep=1 pp=2 interleave=2 microbatches=2"
    for other in (store(mesh=dict(pp=1)), store(interleave=1), store(microbatches=4)):
        with pytest.raises(ValueError, match=saved_on):
            other.restore(3, None, None, "cpu")
    for key in ("pp", "interleave", "microbatches"):
        del layout[key]
    with open(step / MESH_FILE, "w") as f:
        json.dump(layout, f)
    with pytest.raises(ValueError, match="zero1=False sp=1 ep=1 pp=1 interleave=1"):
        store().restore(3, None, None, "cpu")


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
