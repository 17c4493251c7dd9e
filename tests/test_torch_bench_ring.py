"""The port's ring bench (``tpumon/workload_torch/bench_ring.py``), the
counterpart of ``tpumon/workload/bench_ring.py``: the same refusals, the
same four layouts and the same row keys. On the host it runs the plain
versions on the host's clock, so only the rows are checked, not times."""

import json

import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import bench_ring  # noqa: E402

SMALL = ["--platform", "cpu", "--sp", "2", "--seq", "32", "--batch", "1",
         "--heads", "4", "--kv-heads", "2", "--head-dim", "16", "--iters", "1"]


@pytest.mark.parametrize("n,sp,batch,seqs", [
    (4, 3, 2, (24,)), (4, 2, 3, (16,)), (2, 2, 2, (1024, 30, 36)), (2, 2, 2, (1024,)),
])
def test_validate_matches_reference(n, sp, batch, seqs):
    pytest.importorskip("jax")
    from tpumon.workload.bench_ring import _validate

    def outcome(fn):
        try:
            return fn(n, sp, batch, seqs)
        except ValueError as exc:
            return str(exc)

    assert outcome(bench_ring._validate) == outcome(_validate)


def test_rows_on_cpu(capsys):
    """Two ranks on the host: one row per (seq, layout), the reference's
    keys and the reference's layout names, printed by the launcher."""
    assert bench_ring.main(SMALL) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["layout"] for r in rows] == list(bench_ring.LAYOUTS)
    assert all(set(r) == {"layout", "platform", "dp", "sp", "batch", "heads",
                          "kv_heads", "head_dim", "seq", "fwd_ms", "fwd_bwd_ms"}
               for r in rows)
    assert all(r["platform"] == "cpu" and r["sp"] == 2 and r["dp"] == 1 for r in rows)
    assert all(r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0 for r in rows)


def test_refusals_and_the_default_card(capsys, monkeypatch):
    with pytest.raises(SystemExit) as exc:
        bench_ring.main(["--platform", "cpu", "--sp", "2", "--seq", "30"])
    assert exc.value.code == 2 and "must divide by 2*sp (4)" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_ring.main(["--sp", "2", "--seq", "32"])
