"""The model-family seam of the port: every family is one record in
``models.family``, and the harness, the pipeline and ``flops.py`` read
the record. A fourth, toy family defined here (a two-layer dense decoder
on the port's trunk, with a preset of its own) trains through
``harness.run`` and ``harness.main`` once it is registered, with no edit
to the harness.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402

from tpumon.workload_torch import flops, harness  # noqa: E402
from tpumon.workload_torch.models import deepseek_v2, family, llama, moe  # noqa: E402
from tpumon.workload_torch.parallel import launch  # noqa: E402


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    vocab: int = 256
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    ffn_dim: int = 96
    max_seq: int = 32
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


class Toy(nn.Module):
    """A dense decoder of ``n_layers`` of the Llama blocks, on one
    device."""

    def __init__(self, cfg: ToyConfig, device=None) -> None:
        super().__init__()
        llama.decoder_params(self, cfg, lambda i: llama.Block(cfg, device), device)

    def forward(self, tokens, attn_impl=None, remat=False):
        return llama.trunk(self, tokens, attn_impl, remat)


def _toy_params(cfg, generator):
    return llama.init_weights(Toy(cfg, generator.device), generator)


def _no_tree(cfg, tree, device=None):
    raise ValueError("the toy has no JAX counterpart")


def _one_device(cfg, *, dp=1, tp=1, sp=1, pp=1, ep=1, **_):
    if max(dp, tp, sp, pp, ep) > 1:
        raise ValueError("the toy runs on one device")


TOY = family.Family(
    name="toy", config=ToyConfig, presets={"toy2": ToyConfig}, model=Toy,
    init_params=_toy_params, from_jax_params=_no_tree,
    forward_flops=flops.forward_flops, check=_one_device,
)


@pytest.fixture
def toy(monkeypatch):
    family.families()
    monkeypatch.setitem(family.REGISTRY, "toy", TOY)
    return TOY


@pytest.mark.parametrize("cfg,name", [
    (llama.LlamaConfig.tiny(), "llama"), (moe.MoeConfig.tiny(), "moe"),
    (deepseek_v2.DeepseekV2Config.tiny(), "deepseek_v2"),
])
def test_each_config_finds_its_family(cfg, name):
    assert family.of(cfg) is family.families()[name]
    assert type(cfg) is family.families()[name].config


def test_an_unregistered_config_has_no_family():
    with pytest.raises(TypeError, match="no model family takes a ToyConfig"):
        family.of(ToyConfig())


def test_a_new_family_trains_through_run(toy):
    """Seeded, on the flash API's plain path under remat: finite losses
    that fall, the FLOPs of the toy's record, and the loss of the
    trunk's logits."""
    cfg = ToyConfig()
    result = harness.run(cfg, steps=4, batch=2, seq=32, device="cpu",
                         attn="flash", remat=True)
    assert all(math.isfinite(x) for x in result.losses)
    assert result.losses[-1] < result.losses[0]
    assert result.model_flops_per_step == 3.0 * flops.forward_flops(cfg, 2, 32)
    model = _toy_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator().manual_seed(1))
    logits = model(tokens[:, :-1])
    want = nn.functional.cross_entropy(logits.reshape(-1, cfg.vocab),
                                       tokens[:, 1:].reshape(-1))
    torch.testing.assert_close(harness.loss_fn(model, tokens), want, rtol=1e-6, atol=0)


def test_a_new_family_trains_through_main(toy, caplog):
    caplog.set_level("INFO", logger="tpumon.workload_torch.harness")
    assert harness.main(["--model", "toy", "--preset", "toy2", "--platform", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "32"]) == 0
    assert any(r.getMessage().startswith("loss ") for r in caplog.records)


def test_a_new_family_s_check_refuses_before_any_rank(toy, capsys, monkeypatch):
    monkeypatch.setattr(launch, "launch", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(SystemExit) as exc:
        harness.main(["--model", "toy", "--dp", "2", "--platform", "cpu"])
    assert exc.value.code == 2
    assert "the toy runs on one device" in capsys.readouterr().err
