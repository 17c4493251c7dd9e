"""The port's attention bench against tpumon/workload/bench_attention.py.

On the host the bench times the plain versions (a check of the rows, not
a device number). The rows must carry the reference's fields, less the
TPU tile sizes the Hopper kernels do not take; the two impls' forwards
must agree (f32 atol 1e-5: the plain attention path against the flash
kernels' plain version, which sum in other orders).
"""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import bench_attention  # noqa: E402

SHAPE = dict(batch=1, heads=4, kv_heads=2, head_dim=16, seqs=(32,), iters=1)


def test_cpu_rows_have_the_reference_shape():
    pytest.importorskip("jax")
    from tpumon.workload import bench_attention as ref_bench

    ref_rows = ref_bench.bench(**SHAPE, out=io.StringIO())
    out = io.StringIO()
    rows = bench_attention.bench(**SHAPE, platform="cpu", out=out)
    assert [json.loads(line) for line in out.getvalue().splitlines()] == rows
    assert [(r["impl"], r["seq"]) for r in rows] == [
        (r["impl"], r["seq"]) for r in ref_rows]
    for row, ref in zip(rows, ref_rows):
        assert set(row) == set(ref) - {"block_q", "block_k"}
        assert "error" not in row
        assert row["platform"] == row["device_kind"] == "cpu"
        assert row["fwd_ms"] > 0 and row["fwd_bwd_ms"] > 0 and row["fwd_tflops"] > 0
        for key in ("batch", "heads", "kv_heads", "head_dim", "seq", "inner"):
            assert row[key] == ref[key], key


def test_flash_and_xla_forwards_agree():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 16), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 16), dtype=np.float32))
            for _ in range(2))
    outs = {name: impl(q, k, v) for name, impl in bench_attention.IMPLS.items()}
    assert outs["xla"].shape == (2, 64, 4, 16)
    torch.testing.assert_close(outs["flash"], outs["xla"], rtol=0, atol=1e-5)


def test_error_row_keeps_the_bench_going():
    """An impl that fails gives an error row, and the next one runs."""
    def broken(q, k, v):
        raise RuntimeError("CUDA out of memory. Tried to allocate 4 GiB")

    x = torch.zeros(1, 8, 2, 16)
    out = io.StringIO()
    row = bench_attention._timed_row(
        {"impl": "broken"}, broken, x, x, x, device=torch.device("cpu"),
        iters=1, attn_flops=1, out=out,
    )
    assert row["error"].startswith("CUDA out of memory") and row["oom"] is True
    assert "fwd_ms" not in row
    assert json.loads(out.getvalue()) == row


@pytest.mark.parametrize(
    "flag", [["--sweep-blocks"], ["--block-q", "128"], ["--block-k", "256"]])
def test_tile_flags_fail_loudly(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        bench_attention.main([*flag, "--platform", "cpu"])
    assert exc.value.code == 2
    assert "fix their tiles at compile time" in capsys.readouterr().err


def test_platform_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_attention.main(["--seq", "32"])
