"""MiMo-V2-Flash in the port (``models/mimo_v2.py``) against its plain
float32 reference (``benchmark/reference/mimo_v2.py``), on the CPU at the
tiny preset with seeded random weights: logits, the loss and every
weight's gradient (the sinks among them); two train steps with the
router bias's update; the expert share; the bias update's rule under
remat; the spans; the harness's refusals.

Tolerances: both sides compute in float32 and differ only in the order
of their sums (the port's per-expert rows are gathered and scattered,
its window attention is dense and masked where the reference's runs in
query blocks), so logits and losses agree to atol 1e-4 and gradients,
whose largest entries are near 1e-2, to atol 2e-5, as DeepSeek-V2's do.
"""

from __future__ import annotations

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.families import mimo_v2 as family  # noqa: E402
from benchmark.reference import mimo_v2 as ref  # noqa: E402
from benchmark.reference.decoder import Precision  # noqa: E402
from benchmark.spec import HERE  # noqa: E402
from tpumon.workload_torch import flops, harness, spans  # noqa: E402
from tpumon.workload_torch.models import family as families  # noqa: E402
from tpumon.workload_torch.models import mimo_v2 as mm  # noqa: E402
from tpumon.workload_torch.ops import flash_attention as fa  # noqa: E402

F32 = dataclasses.replace(mm.MimoV2Config.tiny(), dtype=torch.float32)
SEQ = 32

#: Published layers whose kinds are the tiny preset's: the dense full
#: layer 0, two window layers, a full MoE layer.
TINY_LAYERS = [0, 6, 7, 11]


def sizes_of(cfg: mm.MimoV2Config):
    """The benchmark family's sizes of a port config, through the
    configuration file's keys (the published names)."""
    config = json.loads((HERE / "configs" / "mimo-v2-flash.json").read_text())
    config.update(
        vocab_size=cfg.vocab, hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, swa_num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, swa_num_key_value_heads=cfg.swa_n_kv_heads,
        head_dim=cfg.head_dim, swa_head_dim=cfg.head_dim,
        v_head_dim=cfg.v_head_dim, swa_v_head_dim=cfg.v_head_dim,
        partial_rotary_factor=cfg.rotary_dim / cfg.head_dim,
        sliding_window=cfg.sliding_window, sliding_window_size=cfg.sliding_window,
        intermediate_size=cfg.ffn_dim, moe_intermediate_size=cfg.moe_ffn_dim,
        n_routed_experts=cfg.held, num_experts_per_tok=cfg.top_k,
        layers_run=TINY_LAYERS, learning_rate=cfg.learning_rate)
    config["expert_share"] = {"router_width": cfg.n_routed_experts,
                              "expert_start": cfg.expert_start}
    return family.sizes(config)


def weights_of(model) -> dict:
    """The port's parameters as the reference's leaves: expert banks as
    one leaf an expert."""
    W = {}
    for name, p in model.named_parameters():
        leaf = p.detach().clone()
        if leaf.dim() == 3:
            W[name] = [e.clone().requires_grad_() for e in leaf]
        else:
            W[name] = leaf.requires_grad_()
    return W


def grads_of(W) -> dict:
    """Each leaf's gradient; an expert no token reached has none: zeros."""
    def grad(e):
        return torch.zeros_like(e) if e.grad is None else e.grad

    return {n: torch.stack([grad(e) for e in w]) if isinstance(w, list) else grad(w)
            for n, w in W.items()}


def _model(cfg=F32, seed=0):
    return mm.init_params(cfg, torch.Generator().manual_seed(seed))


def _tokens(rows=2, seed=1, vocab=F32.vocab):
    return torch.randint(0, vocab, (rows, SEQ + 1),
                         generator=torch.Generator().manual_seed(seed))


def _zero_state(m):
    moe_layers = [i for i in range(m.n_layers) if m.is_moe(i)]
    return ({i: torch.zeros(m.n_routed) for i in moe_layers},
            {i: torch.zeros(m.n_routed, dtype=torch.int64) for i in moe_layers})


def test_tiny_preset_is_the_test_size():
    cfg = mm.MimoV2Config.tiny()
    assert (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.swa_n_kv_heads, cfg.head_dim,
            cfg.v_head_dim, cfg.rotary_dim, cfg.sliding_window) == (
        64, 4, 1, 2, 48, 32, 16, 8)
    assert cfg.layer_types == (0, 1, 1, 0) and cfg.moe_layers == (0, 1, 1, 1)
    assert (cfg.n_routed_experts, cfg.top_k, cfg.held) == (8, 3, 8)
    assert sizes_of(cfg).rotary == cfg.rotary_dim


def test_the_share_keeps_every_published_width():
    cfg = mm.MimoV2Config.v2_flash_share()
    assert (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.swa_n_kv_heads, cfg.head_dim,
            cfg.v_head_dim, cfg.rotary_dim, cfg.sliding_window) == (
        4096, 64, 4, 8, 192, 128, 64, 128)
    assert (cfg.ffn_dim, cfg.moe_ffn_dim, cfg.top_k, cfg.n_routed_experts,
            cfg.held, cfg.vocab) == (16384, 2048, 8, 256, 8, 19072)
    assert cfg.layer_types == (0, 1, 1, 1, 1, 1, 0)
    assert cfg.moe_layers == (0, 1, 1, 1, 1, 1, 1)
    assert (cfg.rope_theta, cfg.swa_rope_theta, cfg.value_scale) == (5e6, 1e4, 0.707)
    assert cfg.learning_rate == 2.2e-5
    assert len(mm.PUBLISHED_PATTERN) == 48 and mm.PUBLISHED_PATTERN.count(0) == 9
    model = mm.MimoV2(cfg, "meta")
    assert sum(p.numel() for p in model.parameters()) == 2_221_994_304
    assert families.families()["mimo_v2"].after_step is mm.update_bias


def test_param_names_and_shapes_are_the_family_s():
    model = _model()
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert have == family.param_shapes(sizes_of(F32))
    buffers = {n: tuple(b.shape) for n, b in model.named_buffers()}
    assert buffers == {f"blocks.{i}.{name}": (8,) for i in (1, 2, 3)
                       for name in ("e_score_correction_bias", "load")}
    assert set(model.state_dict()) - set(have) == {
        f"blocks.{i}.e_score_correction_bias" for i in (1, 2, 3)}


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_logits_loss_and_gradients_match_the_reference(attn):
    """The port's f32 forward (plain attention, or the flash API's plain
    path) against the reference's, with a router bias that moves the
    choices: logits and the loss atol 1e-4, the loss's gradient of every
    weight atol 2e-5 (the module's docstring), the loads alike."""
    model = _model()
    with torch.no_grad():
        for block in model.blocks:
            if block.moe:
                block.e_score_correction_bias.copy_(torch.linspace(-0.3, 0.3, 8))
    tokens = _tokens()
    impl = fa.make_flash_attn() if attn == "flash" else None
    m = sizes_of(F32)
    W = weights_of(model)
    bias, load = _zero_state(m)
    for i in bias:
        bias[i].copy_(torch.linspace(-0.3, 0.3, 8))
    logits = model(tokens[:, :-1], impl)
    h = ref.hidden(W, tokens[:, :-1], m, Precision(), bias, load)
    torch.testing.assert_close(logits, h @ W["unembed"], rtol=0, atol=1e-4)
    for i, block in enumerate(model.blocks):
        if block.moe:
            assert torch.equal(block.load, load[i]) and int(load[i].sum()) == 2 * SEQ * 3
            block.load.zero_()
    loss = harness.loss_fn(model, tokens, impl, remat=attn == "flash")
    ref_loss = ref.chunk_loss(W, tokens, m, Precision(), bias, _zero_state(m)[1])
    torch.testing.assert_close(loss, ref_loss, rtol=0, atol=1e-4)
    loss.backward()
    ref_loss.backward()
    want = grads_of(W)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=2e-5,
                                   msg=lambda s, n=name: f"{n}: {s}")
    assert model.blocks[1].sinks.grad.abs().max() > 0


def test_two_train_steps_with_the_bias_update_follow_the_reference():
    """Two AdamW steps of the port's train step (flash's plain path, remat,
    two micro-batches) against the reference's ``follow`` from the same
    weights: the losses atol 1e-4, every weight after the second step atol
    1e-5, a hundredth of the learning rate that AdamW moves each by (a
    gradient near zero at step 2 leaves a few 1e-6 apart), and the router
    biases exactly: ±γ after step 1, from the step's loads."""
    cfg = dataclasses.replace(F32, learning_rate=1e-3)
    model = _model(cfg)
    m = sizes_of(cfg)
    f = ref.MimoFollower(m, 0, "cpu", Precision())
    views = f.views(f.theta)
    with torch.no_grad():
        for name, p in model.named_parameters():
            views[name].copy_(p)
    opt = harness.build_optimizer(model.named_parameters(), model)
    step = harness.make_train_step(model, opt, fa.make_flash_attn(), grad_accum=2,
                                   remat=True)
    batches = [_tokens(rows=4, seed=s) for s in (5, 6)]
    for s, batch in enumerate(batches):
        loss, _ = step(batch)
        ref_loss = f.step(batch, 2, 1)
        f.update()
        assert loss.item() == pytest.approx(ref_loss, abs=1e-4)
        for i, block in enumerate(model.blocks):
            if block.moe:
                torch.testing.assert_close(block.e_score_correction_bias, f.bias[i],
                                           rtol=0, atol=1e-7)
                assert not block.load.any()
                if s == 0:
                    moved = block.e_score_correction_bias.abs()
                    assert bool(((moved == 0) | ((moved - 1e-3).abs() < 1e-9)).all())
                    assert bool((moved > 0).any())
    for name, view in views.items():
        torch.testing.assert_close(dict(model.named_parameters())[name].detach(), view,
                                   rtol=0, atol=1e-5, msg=lambda s, n=name: f"{n}: {s}")


def test_the_bias_update_reads_only_the_signs_of_the_loads():
    """b_i += γ·sign(mean − load_i): an expert under the mean load rises by
    γ, one over it falls, one at it stays; counting every pass twice (remat's
    recompute) moves nothing, and the loads are cleared."""
    model = _model(F32)
    loads = torch.tensor([0, 3, 3, 3, 6, 9, 0, 0])  # mean 3
    for block in model.blocks:
        if block.moe:
            block.load.copy_(loads)
    mm.update_bias(model)
    want = torch.tensor([1.0, 0, 0, 0, -1, -1, 1, 1]) * 1e-3
    for block in model.blocks:
        if block.moe:
            torch.testing.assert_close(block.e_score_correction_bias, want)
            assert not block.load.any()
            block.load.copy_(2 * loads)
    mm.update_bias(model)
    for block in model.blocks:
        if block.moe:
            torch.testing.assert_close(block.e_score_correction_bias, 2 * want)


def test_remat_counts_each_choice_twice():
    model = _model(F32)
    tokens = _tokens(rows=2)
    for remat, passes in ((False, 1), (True, 2)):
        loss = harness.loss_fn(model, tokens, fa.make_flash_attn(), remat=remat)
        loss.backward()
        for block in model.blocks:
            if block.moe:
                assert int(block.load.sum()) == passes * 2 * SEQ * F32.top_k
                block.load.zero_()


def test_the_shares_of_the_experts_add_up_to_the_whole_layer():
    """Four cards of two experts each: their routed parts, summed, are
    the uncut reference layer's output; every card counts the same loads
    over all eight experts."""
    whole = _model()
    layer = whole.blocks[1]
    x = torch.randn(2, SEQ, F32.dim, generator=torch.Generator().manual_seed(3))
    m = sizes_of(F32)
    bias, load = _zero_state(m)
    want = ref.moe(weights_of(whole), 1, x, bias[1], load[1], m, Precision())
    total = torch.zeros_like(want)
    for start in range(0, 8, 2):
        cfg = dataclasses.replace(F32, expert_start=start, experts_held=2)
        block = mm.Block(cfg, 1)
        with torch.no_grad():
            for name, p in block.named_parameters():
                src = getattr(layer, name)
                p.copy_(src[start:start + 2] if src.dim() == 3 else src)
        total = total + block.moe_mlp(x)
        assert torch.equal(block.load, load[1])
    torch.testing.assert_close(total, want, rtol=0, atol=1e-5)


def test_the_probe_leaves_the_loads_and_biases_as_they_were():
    model = _model(mm.MimoV2Config.tiny())
    opt = harness.build_optimizer(model.named_parameters(), model)
    probe = harness._make_phase_probe(model, opt, fa.make_flash_attn(), True, 0)
    before = {n: b.clone() for n, b in model.named_buffers()}
    probe(_tokens(rows=2))
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


def test_the_model_s_spans_and_their_backward_halves():
    """A profiled train step of two micro-batches with remat: every
    layer's forward twice, its backward once; the window layers' calls in
    ``swa_core`` and the full layers' in ``attn_core``, routing in the
    three MoE layers, and one ``balance`` after the optimizer."""
    model = _model(mm.MimoV2Config.tiny())
    opt = harness.build_optimizer(model.named_parameters(), model)
    step = harness.make_train_step(model, opt, fa.make_flash_attn(), grad_accum=2,
                                   remat=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_tokens(rows=4))
    counts: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            name = e.name()[len(spans.PREFIX):]
            counts[name] = counts.get(name, 0) + 1
    M = 2
    per_layer = {"qkv": 4, "attn_core": 2, "swa_core": 2, "attn_out": 4,
                 "layer": 4, "rope": 4, "mlp": 1, "router": 3, "permute": 3,
                 "experts": 3, "unpermute": 3}
    for name, n in per_layer.items():
        assert counts.get(name) == 2 * M * n, name
    for name in ("qkv", "attn_core", "swa_core", "attn_out", "rope", "mlp",
                 "experts"):
        assert counts.get(f"{name}.bwd") == M * per_layer[name], name
    assert counts["step"] == counts["optimizer"] == counts["balance"] == 1


def test_the_harness_refuses_meshes_and_loss_chunk():
    cfg = mm.MimoV2Config.tiny()
    for axis in ("dp", "tp", "sp", "pp", "ep"):
        with pytest.raises(ValueError, match=f"one device.*{axis}=2"):
            harness.run(cfg, steps=1, batch=4, seq=32, device="cpu", **{axis: 2})
    with pytest.raises(ValueError, match="loss_chunk"):
        harness.run(cfg, steps=1, batch=2, seq=32, device="cpu", loss_chunk=16)
    with pytest.raises(ValueError, match="no JAX counterpart"):
        mm.from_jax_params(cfg, {})


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--ep", "2"], ["--loss-chunk", "16"]])
def test_the_cli_refuses_them_before_any_rank_starts(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        harness.main(["--model", "mimo_v2", "--platform", "cpu", *flags])
    assert exc.value.code == 2
    assert "MiMo-V2" in capsys.readouterr().err


def test_cli_trains_the_tiny_preset(caplog):
    caplog.set_level("INFO")
    assert harness.main(["--model", "mimo_v2", "--preset", "tiny", "--platform",
                         "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                         "--attn", "flash", "--remat", "--phase-stats",
                         "--stats-every", "1"]) == 0
    assert any("GFLOP/step" in r.getMessage() for r in caplog.records)


def test_flops_count_the_window_layers_at_their_pairs():
    """The port's count (full layers at S², as flops.py counts; window
    layers at their windowed pairs) against the benchmark family's (full
    layers at S(S+1)/2): they differ only in the full layers' core; a
    step is three of the port's forwards."""
    from benchmark import spec

    cfg = mm.MimoV2Config.v2_flash_share()
    m = spec.load_cell("mimo-v2-flash.s32768").model
    B, S = 2, 32768
    full_s2 = 2 * B * 64 * S * S * (192 + 128) * 2
    full_pairs = 2 * B * 64 * (S * (S + 1) // 2) * (192 + 128) * 2
    assert mm.forward_flops(cfg, B, S) - full_s2 == pytest.approx(
        family.forward_flops(m, B, S) - full_pairs, rel=1e-12)
    assert flops.train_flops_per_step(cfg, B, S) == 3.0 * mm.forward_flops(cfg, B, S)
    assert flops.window_pairs(S, 128) == 128 * 129 // 2 + (S - 128) * 128
    # The window layers' core is a small part: 5 layers at 128 keys.
    swa = 5 * 2 * B * 64 * flops.window_pairs(S, 128) * 320
    assert swa / family.forward_flops(m, B, S) < 0.01


@pytest.mark.cuda
def test_a_step_on_card_matches_the_cpu():
    """The tiny preset's loss in bf16 on the card (flash kernels at width
    64 padded, under the window and with sinks; grouped expert products)
    against the same on the CPU (plain paths): rel 2e-2, bf16 products on
    both sides; the biases move alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = mm.MimoV2Config.tiny()
    losses, biases = [], []
    for device in ("cpu", "cuda"):
        model = _model(cfg).to(device)
        opt = harness.build_optimizer(model.named_parameters(), model)
        step = harness.make_train_step(model, opt, fa.make_flash_attn(), remat=True)
        loss, _ = step(_tokens(rows=2, vocab=cfg.vocab).to(device))
        losses.append(loss.item())
        biases.append(model.blocks[1].e_score_correction_bias.cpu())
    assert math.isfinite(losses[1])
    assert losses[1] == pytest.approx(losses[0], rel=2e-2)
    assert (biases[0] != biases[1]).float().mean() <= 0.25
