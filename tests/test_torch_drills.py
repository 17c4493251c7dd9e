"""Monitor-loop drills against the port's live page, with no change on
the monitor side.

- The preemption drill of tests/test_preempt_live.py against the port's
  harness on the CPU: ``tpu_step_terminating`` reads 0 while training and
  1 within the grace window after one SIGTERM, and the process exits 143
  on its own.
- The same at --dp 2 --tp 2: SIGTERM goes to the launching process, which
  passes it on to the four ranks; every rank defers its exit by the grace
  window, rank 0's page flips, and the launcher exits with the worst
  rank's code, 143.
- The lifecycle plane reads that mesh run: an exporter built as
  tests/test_lifecycle.py's ``lifecycle_exporter`` fixture builds it, with
  ``lifecycle_step_urls`` pointing at rank 0's page, publishes
  ``tpu_lifecycle_collective_wait_fraction`` from it, and classifies the
  SIGTERM (with the device's duty collapsing) as a preemption.

Each drill starts its processes once; every rank runs one thread.
"""

import http.client
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

from tpumon.workload_torch.parallel import launch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRACE_S = 3.0
TINY = ["--platform", "cpu", "--preset", "tiny", "--steps", "1000000",
        "--seq", "32", "--stats-every", "1"]


def _metrics(port: int) -> str | None:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        return resp.read().decode() if resp.status == 200 else None
    except OSError:
        return None
    finally:
        conn.close()


def _gauge(page: str, name: str) -> float | None:
    m = re.search(rf"^{name} (\S+)", page, re.M)
    return float(m.group(1)) if m else None


def _start(argv: list[str], port: int):
    env = {**os.environ, "TPUMON_STEP_TERM_GRACE_S": str(GRACE_S),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "tpumon.workload_torch.harness", *argv,
         "--metrics-port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _wait_for(proc, port: int, want: str) -> str:
    """Rank 0's first page that carries ``want``."""
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out, _ = proc.communicate(timeout=10)
            pytest.fail(f"harness died before serving: {out[-3000:]}")
        page = _metrics(port)
        if page and want in page:
            return page
        time.sleep(0.25)
    pytest.fail(f"rank 0's page never carried {want}")


def _kill(proc) -> str:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    return proc.communicate(timeout=30)[0]


def _drill(proc, port: int, on_poll=None) -> dict:
    """SIGTERM the process, then watch the page (and call ``on_poll``)
    through the grace window; returns when the flag first read 1, the
    exit code, and ``on_poll``'s last answer."""
    t_term = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    flagged_at, polled = None, None
    while time.monotonic() - t_term < GRACE_S + 5.0:
        page = _metrics(port)
        if page is None:
            break  # the page is gone with the process
        if flagged_at is None and _gauge(page, "tpu_step_terminating") == 1.0:
            flagged_at = time.monotonic() - t_term
        if on_poll is not None:
            polled = on_poll()
        if flagged_at is not None and (on_poll is None or polled):
            break
        time.sleep(0.1)
    rc = proc.wait(timeout=GRACE_S + 40.0)
    return {"flagged_at": flagged_at, "rc": rc, "polled": polled}


@pytest.fixture(scope="module")
def single():
    port = launch.free_port()
    proc = _start([*TINY, "--batch", "2"], port)
    try:
        before = _wait_for(proc, port, "tpu_step_terminating")
        out = {"before": _gauge(before, "tpu_step_terminating"), **_drill(proc, port)}
    finally:
        out_text = _kill(proc)
    out["log"] = out_text
    return out


def test_single_process_page_reads_0_while_training(single):
    assert single["before"] == 0.0


def test_single_process_sigterm_flags_the_page_within_grace(single):
    assert single["flagged_at"] is not None, single["log"][-3000:]
    assert single["flagged_at"] < GRACE_S


def test_single_process_exits_143_after_grace(single):
    assert single["rc"] == 143, single["log"][-3000:]


def _lifecycle_exporter(step_url: str):
    from tpumon.backends.fake import FakeTpuBackend
    from tpumon.config import Config
    from tpumon.exporter.server import build_exporter
    from tpumon.lifecycle.fixture import LifecycleBackend

    backend = LifecycleBackend(FakeTpuBackend.preset("v4-8", ici_flake=0.0))
    cfg = Config(port=0, addr="127.0.0.1", interval=30.0,
                 pod_attribution=False, lifecycle_step_urls=step_url)
    exp = build_exporter(cfg, backend)
    exp.start()
    return exp, backend


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


@pytest.fixture(scope="module")
def mesh():
    """One dp=2×tp=2 run on the CPU, read by an exporter's lifecycle
    plane, then preempted through its launcher."""
    port = launch.free_port()
    proc = _start([*TINY, "--dp", "2", "--tp", "2", "--batch", "4"], port)
    exp = None
    try:
        before = _wait_for(proc, port, "tpu_step_collective_wait_fraction")
        exp, backend = _lifecycle_exporter(f"http://127.0.0.1:{port}")
        for _ in range(3):
            exp.poller.poll_once()
        exporter_page = _get(exp.server.url + "/metrics")

        def poll():
            exp.poller.poll_once()
            doc = json.loads(_get(exp.server.url + "/lifecycle"))
            return doc if "preemption" in doc.get("events_total", {}) else None

        backend.duty_zero = True  # the slice goes idle with the workload
        drill = _drill(proc, port, on_poll=poll)
        out = {"before": before, "exporter_page": exporter_page, **drill}
    finally:
        if exp is not None:
            exp.close()
        out_text = _kill(proc)
    out["log"] = out_text
    return out


def test_lifecycle_plane_reads_the_mesh_collective_wait(mesh):
    from tpumon.lifecycle.probe import step_snapshot_from_text

    snap = step_snapshot_from_text(mesh["before"])
    assert 0.0 <= snap["collective_wait_fraction"] <= 1.0
    assert snap["axes"] == {"dp": 2, "tp": 2, "sp": 1, "pp": 1, "ep": 1}
    m = re.search(r"^tpu_lifecycle_collective_wait_fraction\{[^}]*\} (\S+)",
                  mesh["exporter_page"], re.M)
    assert m, mesh["exporter_page"][-3000:]
    assert 0.0 <= float(m.group(1)) <= 1.0


def test_mesh_sigterm_flags_rank0_page_within_grace(mesh):
    assert _gauge(mesh["before"], "tpu_step_terminating") == 0.0
    assert mesh["flagged_at"] is not None, mesh["log"][-3000:]
    assert mesh["flagged_at"] < GRACE_S


def test_mesh_launcher_exits_143(mesh):
    assert mesh["rc"] == 143, mesh["log"][-3000:]
    assert "mesh of 4 ranks (4 on this host) exited with" in mesh["log"]


def test_lifecycle_plane_classifies_the_mesh_preemption(mesh):
    doc = mesh["polled"]
    assert doc is not None, "the plane never classified a preemption"
    assert doc["events_total"] == {"preemption": 1}
    assert doc["transition"] and "preemption" in doc["kinds"]
