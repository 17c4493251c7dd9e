"""The port's attention bench against tpumon/workload/bench_attention.py.

On the host the bench times the plain versions (a check of the rows, not
a device number). The rows must carry the reference's fields, the flash
rows' tiles included, plus one ``effective_<kernel>`` key per kernel; the
tiling sweep's rows the reference's sweep fields, one row per distinct
effective tiling. The two impls' forwards must agree (f32 atol 1e-5: the
plain attention path against the flash kernels' plain version, which sum
in other orders).
"""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpumon.workload_torch import bench_attention  # noqa: E402

SHAPE = dict(batch=1, heads=4, kv_heads=2, head_dim=16, seqs=(32,), iters=1)
EFFECTIVE = {"effective_flash_fwd", "effective_flash_dq", "effective_flash_dkv"}


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
        extra = EFFECTIVE if row["impl"] == "flash" else set()
        assert set(row) == set(ref) | extra
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


CLI_SHAPE = ["--platform", "cpu", "--seq", "32", "--iters", "1", "--batch", "1",
             "--heads", "4", "--kv-heads", "2", "--head-dim", "16"]


@pytest.mark.parametrize("flags,fwd", [
    (["--block-q", "64"], [64, 64]),
    (["--block-k", "256"], [64, 128]),
    (["--block-q", "128", "--block-k", "100"], [128, 64]),
])
def test_tile_flags_reach_the_flash_rows(flags, fwd, capsys):
    """--block-q/--block-k run: the flash row records the forward's
    effective tiles as block_q/block_k and every kernel's own."""
    assert bench_attention.main([*flags, *CLI_SHAPE]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    flash = [r for r in rows if r["impl"] == "flash"]
    assert len(flash) == 1 and "error" not in flash[0]
    assert [flash[0]["block_q"], flash[0]["block_k"]] == fwd
    assert flash[0]["effective_flash_fwd"] == fwd


@pytest.mark.parametrize("value", ["0", "-64"])
def test_tile_flags_below_one_exit_2(value, capsys):
    with pytest.raises(SystemExit) as exc:
        bench_attention.main(["--block-q", value, *CLI_SHAPE])
    assert exc.value.code == 2
    assert "must be >= 1" in capsys.readouterr().err


def test_sweep_rows_have_the_reference_shape():
    """--sweep-blocks: the reference's sweep fields plus each kernel's
    effective tiles, one row per distinct effective tiling."""
    pytest.importorskip("jax")
    from tpumon.workload import bench_attention as ref_bench

    shape = dict(SHAPE, seqs=(32,))
    ref_rows = ref_bench.sweep_blocks(**shape, blocks=(16, 32), out=io.StringIO())
    out = io.StringIO()
    rows = bench_attention.sweep_blocks(**shape, platform="cpu", out=out)
    assert [json.loads(line) for line in out.getvalue().splitlines()] == rows
    assert len(rows) == 4  # every pair of TILES runs other tiles in flash_fwd
    for row in rows:
        assert set(row) == set(ref_rows[0]) | EFFECTIVE
        assert "error" not in row and row["impl"] == "flash"
        assert [row["effective_block_q"], row["effective_block_k"]] == \
            row["effective_flash_fwd"]
    assert {(r["block_q"], r["block_k"]) for r in rows} == {
        (64, 64), (64, 128), (128, 64), (128, 128)}


def test_sweep_skips_requests_that_run_timed_tiles():
    """As the reference's: a request whose effective tiles (every
    kernel's) were already timed gives no second row."""
    rows = bench_attention.sweep_blocks(**SHAPE, blocks=(32, 64, 100, 128),
                                        platform="cpu", out=io.StringIO())
    effective = [tuple(tuple(r[f"effective_{n}"]) for n in
                       ("flash_fwd", "flash_dq", "flash_dkv")) for r in rows]
    assert len(effective) == len(set(effective)) == 4
    assert [(r["block_q"], r["block_k"]) for r in rows] == [
        (32, 32), (32, 128), (128, 32), (128, 128)]


def test_sweep_cli_on_cpu(capsys):
    assert bench_attention.main(["--sweep-blocks", *CLI_SHAPE]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 4 and all(r["impl"] == "flash" for r in rows)


def test_platform_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_attention.main(["--seq", "32"])
