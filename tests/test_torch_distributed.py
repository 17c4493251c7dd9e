"""The port's multi-host path: ``harness.main`` with ``--coordinator``,
``--num-processes`` and ``--process-id``, as two host processes on this
machine, each starting two of the four ranks of a dp=2×tp=2 mesh on the
CPU (the counterpart of tests/test_distributed.py's two JAX processes).

The two hosts' ranks must report the same losses as one host that starts
all four (rel 1e-6, the reference's bound across its processes), and
descending; the hosts share the checkpoint directory, as two hosts on one
machine do. A host whose peer host dies or hangs must exit non-zero in
bounded time; hosts that start their ranks far apart still meet. Each
rank runs one thread (``OMP_NUM_THREADS=1``) to keep the load of the
test run small. The hosts' agreement on the backend and
MFU's count of distinct (host, card) pairs are checked in one process.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import harness  # noqa: E402
from tpumon.workload_torch.parallel import launch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ["--platform", "cpu", "--dp", "2", "--tp", "2", "--batch", "4",
        "--seq", "32"]
ARGV = [*MESH, "--steps", "2"]


def _env(**extra):
    return {**os.environ, "OMP_NUM_THREADS": "1", **extra}


def _host(args, env, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "tpumon.workload_torch.harness", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True, **kw)


def _hosts(args, port, env):
    return [_host([*args, "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)], env)
            for i in range(2)]


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=30)


def _ended_early(hosts) -> str:
    """Stop every host, then each one's exit code and the tail of its
    log."""
    codes = [p.poll() for p in hosts]
    _stop(hosts)
    return "a host ended early\n" + "\n".join(
        f"--- host {i}: exit code {code} ---\n{p.communicate()[0][-3000:]}"
        for i, (p, code) in enumerate(zip(hosts, codes)))


def _reports(out: str) -> dict:
    return {int(m.group(1)): json.loads(m.group(2))
            for m in re.finditer(r"rank (\d+) report (\{.*\})", out)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-host job, then one host starting all four ranks, on the
    same argv (each with its own checkpoint directory)."""
    shared = str(tmp_path_factory.mktemp("shared"))
    alone = str(tmp_path_factory.mktemp("alone"))
    hosts = _hosts([*ARGV, "--checkpoint-dir", shared], launch.free_port(), _env())
    outs = []
    try:
        for p in hosts:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        _stop(hosts)
    one = _host([*ARGV, "--checkpoint-dir", alone], _env())
    try:
        one_out = one.communicate(timeout=240)[0]
    finally:
        _stop([one])
    return {"hosts": hosts, "outs": outs, "one": one, "one_out": one_out,
            "shared": shared}


def test_two_hosts_exit_zero_and_log_their_share(runs):
    for i, (p, out) in enumerate(zip(runs["hosts"], runs["outs"])):
        assert p.returncode == 0, out[-3000:]
        assert f"distributed: process {i}/2, 2 local / 4 global ranks" in out
        assert sorted(_reports(out)) == [2 * i, 2 * i + 1]
    assert runs["one"].returncode == 0, runs["one_out"][-3000:]


def test_two_hosts_match_one_launch(runs):
    """Every rank of both hosts has the one-host launch's losses (rel
    1e-6), and they descend."""
    reports = {}
    for out in runs["outs"]:
        reports.update(_reports(out))
    one = _reports(runs["one_out"])
    assert sorted(reports) == sorted(one) == [0, 1, 2, 3]
    want = one[0]["losses"]
    assert len(want) == 2 and want[1] < want[0]
    for rank, rep in reports.items():
        assert rep["losses"] == pytest.approx(want, rel=1e-6), rank
        assert rep["backend"] == "gloo"
        assert rep["collectives"]["counts"] == one[rank]["collectives"]["counts"]


def test_two_hosts_share_the_checkpoint_directory(runs):
    step = os.path.join(runs["shared"], "2")
    assert sorted(os.listdir(step)) == ["mesh.json", "rank0.pt", "rank1.pt",
                                        "rank2.pt", "rank3.pt"]
    with open(os.path.join(step, "mesh.json")) as f:
        assert json.load(f)["dp"] == 2


@pytest.mark.parametrize("flags,message", [
    (["--dp", "2", "--tp", "3", "--coordinator", "127.0.0.1:1", "--num-processes", "4"],
     "(6) must be divisible by --num-processes (4)"),
    (["--dp", "2", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "-1"], "--process-id (-1) must be in [0, --num-processes (2))"),
    (["--dp", "4", "--num-processes", "4"], "--num-processes > 1 requires --coordinator"),
])
def test_multi_host_refusals(flags, message, capsys, monkeypatch):
    """Refused with exit code 2 before any rank starts."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(launch, "launch", no_launch)
    with pytest.raises(SystemExit) as exc:
        harness.main([*flags, "--platform", "cpu"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


BAD_WORKER_ID = ("WARNING: could not determine TPU worker number, please set "
                 "env var `TPU_WORKER_ID` manually")


def test_one_host_ignores_tpu_worker_id(monkeypatch):
    """Without --coordinator the launch is host 0 whatever $TPU_WORKER_ID
    holds (loading libtpu can leave a warning in it), as the reference,
    which reads it only under --coordinator."""
    seen = {}

    def no_launch(*args, **kwargs):
        seen.update(kwargs)
        raise RuntimeError("stop before the ranks")

    monkeypatch.setenv("TPU_WORKER_ID", BAD_WORKER_ID)
    monkeypatch.setattr(launch, "launch", no_launch)
    with pytest.raises(RuntimeError, match="stop before the ranks"):
        harness.main(["--dp", "2", "--platform", "cpu"])
    assert seen["process_id"] == 0 and seen["num_processes"] == 1


def test_unreadable_tpu_worker_id_exits_2(capsys, monkeypatch):
    monkeypatch.setenv("TPU_WORKER_ID", BAD_WORKER_ID)
    with pytest.raises(SystemExit) as exc:
        harness.main(["--dp", "2", "--coordinator", "127.0.0.1:1",
                      "--num-processes", "2", "--platform", "cpu"])
    assert exc.value.code == 2
    assert "is not a host index; pass --process-id" in capsys.readouterr().err


def test_process_id_defaults_to_tpu_worker_id(capsys, monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setenv("TPU_WORKER_ID", "5")
    monkeypatch.setattr(launch, "launch", no_launch)
    with pytest.raises(SystemExit) as exc:
        harness.main(["--dp", "2", "--coordinator", "127.0.0.1:1",
                      "--num-processes", "2", "--platform", "cpu"])
    assert exc.value.code == 2
    assert "--process-id (5) must be in" in capsys.readouterr().err


def _page(port: int) -> str | None:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2) as resp:
            return resp.read().decode()
    except OSError:
        return None


@pytest.mark.parametrize("how", ["killed", "stopped"])
def test_a_dead_peer_host_ends_the_other_in_bounded_time(how):
    """Host 1 is killed (its sockets close) or stopped (they stay open,
    so only the group's timeout, TPUMON_DIST_TIMEOUT_S=20 here, can end
    the wait) while both hosts train; host 0 exits non-zero within
    120 s."""
    metrics = launch.free_port()
    env = _env(TPUMON_DIST_TIMEOUT_S="20", TPUMON_STEP_TERM_GRACE_S="1")
    hosts = _hosts([*MESH, "--steps", "1000000", "--stats-every", "1",
                    "--metrics-port", str(metrics)], launch.free_port(), env)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            page = _page(metrics)
            if page and re.search(r"^tpu_step_counter(_total)? [1-9]", page, re.M):
                break
            if any(p.poll() is not None for p in hosts):
                pytest.fail(_ended_early(hosts))
            time.sleep(0.25)
        else:
            pytest.fail("rank 0's page never counted a step")
        os.killpg(hosts[1].pid, signal.SIGKILL if how == "killed" else signal.SIGSTOP)
        t0 = time.monotonic()
        rc = hosts[0].wait(timeout=120)
        assert rc != 0
        assert time.monotonic() - t0 < 120
    finally:
        _stop(hosts)


def test_hosts_that_start_apart_still_meet():
    """Host 1 starts 25 s after host 0, past the 20 s group timeout: the
    ranks' wait for each other at the job's store is not the collectives'
    timeout, so both hosts stay up and rank 0's page counts a step."""
    metrics = launch.free_port()
    env = _env(TPUMON_DIST_TIMEOUT_S="20", TPUMON_STEP_TERM_GRACE_S="1")
    args = [*MESH, "--steps", "1000000", "--stats-every", "1",
            "--metrics-port", str(metrics), "--coordinator",
            f"127.0.0.1:{launch.free_port()}", "--num-processes", "2"]
    hosts = [_host([*args, "--process-id", "0"], env)]
    try:
        time.sleep(25)
        hosts.append(_host([*args, "--process-id", "1"], env))
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            page = _page(metrics)
            if page and re.search(r"^tpu_step_counter(_total)? [1-9]", page, re.M):
                break
            if any(p.poll() is not None for p in hosts):
                pytest.fail(_ended_early(hosts))
            time.sleep(0.25)
        else:
            pytest.fail("rank 0's page never counted a step")
    finally:
        _stop(hosts)


@pytest.mark.parametrize("others,cards,want", [
    ("1", 2, "nccl"),   # every host has a card for each of its ranks
    ("0", 2, "gloo"),   # a peer host has not: all pick gloo, not a mix
    ("1", 1, "gloo"),   # this host has not
])
def test_hosts_agree_on_the_backend(others, cards, want, monkeypatch):
    """Each rank posts its host's answer on the job's store and reads
    every rank's: rank 0 of a 4-rank job with 2 ranks a host, its peers'
    answers already posted."""
    import torch.distributed as dist

    from tpumon.workload_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    store = dist.HashStore()
    for rank in (1, 2, 3):
        store.set(f"backend/cards/{rank}", "1" if rank == 1 else others)
    assert mesh_mod.agree_backend(store, 0, 4, torch.device("cuda", 0), 2) == want


def test_mfu_counts_distinct_host_card_pairs(monkeypatch):
    """Card 0 of two hosts is two cards; two ranks on one host's card 0
    share its peak."""
    import types

    from tpumon.workload_torch import flops
    from tpumon.workload_torch.parallel import mesh as mesh_mod

    fake = types.SimpleNamespace(ranks=[0, 1, 2, 3], local_world=2,
                                 device=torch.device("cpu"))
    assert mesh_mod.rank_cards(fake) == [(0, torch.device("cpu"))] * 2 + [
        (1, torch.device("cpu"))] * 2
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    card = torch.device("cuda", 0)
    assert flops.peak_flops_total([(0, card), (0, card), (1, card), (1, card)]) == 2 * 989e12
    assert flops.peak_flops_total([card, card]) == 989e12
