"""The import guard compares whole dotted components."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from benchmark import guard, spec


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("tpumon.workload", True),
    ("tpumon.workload.harness", True), ("tpumon.workload_torch", False),
    ("tpumon.workload_torch.harness", False), ("tpumon", False),
    ("tpumon.config", False), ("jaxtyping", False), ("benchmark.run", False),
])
def test_forbidden(name, bad):
    assert guard.forbidden(name) is bad


def test_loaded_forbidden_reads_given_modules():
    assert guard.loaded_forbidden({"tpumon.workload_torch": 1, "torch": 1}) == []
    assert guard.loaded_forbidden({"tpumon.workload.ops": 1, "jax": 1}) == [
        "jax", "tpumon.workload.ops"]


def test_the_benchmark_and_the_port_load_no_jax():
    """The harness, the port and every metric reader, loaded as a run
    loads them."""
    code = ("import benchmark.cellrun, benchmark.calibrate, "
            "tpumon.workload_torch.harness, "
            "tpumon.workload_torch.ops.flash_attention; "
            "from benchmark import guard, run; "
            "[run.load_reader(p.stem) for p in run.METRICS.glob('*.py') "
            "if p.stem != '__init__']; "
            "print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_check_exits_when_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["sys"])
    with pytest.raises(SystemExit) as exc:
        guard.check("test")
    assert exc.value.code == 3


#: Drives ``run.finish`` on a made-up run, with the metric readers taken
#: from the folder given as the first argument (a fake ``jax`` module
#: there too), as a run's last stage after its window.
_FINISH = textwrap.dedent("""
    import argparse, dataclasses, sys
    from pathlib import Path
    folder = Path(sys.argv[1])
    sys.path.insert(0, str(folder))
    from benchmark import run
    from benchmark.tests.conftest import tiny_cell
    run.METRICS = folder
    cell = dataclasses.replace(tiny_cell(), end_to_end=(
        {"name": "probe", "unit": "s"},))
    numbers = {k: 0.0 for k in cell.limits}
    numbers["at"] = {k: "-" for k in cell.limits}
    record = {"memory_peak_bytes": 1, "trace": None,
              "window": {"steps": 3, "seconds": 1.0, "failed": 0}}
    fake = {"record": record, "correct": True, "device_name": "cpu",
            "reference_s": 0.0, "numbers": numbers, "phases": {},
            "losses": {}}
    args = argparse.Namespace(trace=0, workload="tiny", seed=1)
    sys.exit(run.finish(cell, fake, args))
""")


def _finish_with_reader(tmp_path, body):
    (tmp_path / "jax.py").write_text("")
    (tmp_path / "probe.py").write_text(body)
    return subprocess.run([sys.executable, "-c", _FINISH, str(tmp_path)],
                          cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=120)


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    out = _finish_with_reader(tmp_path, "import jax\n\ndef read(rec):\n    return 1.0\n")
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "forbidden modules loaded: jax" in out.stderr


def test_a_clean_reader_gives_the_result_with_checks_last(tmp_path):
    out = _finish_with_reader(tmp_path, "def read(rec):\n    return 1.0\n")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"] == {"probe": {"value": 1.0, "unit": "s"}}
    assert list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
