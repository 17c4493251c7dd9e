"""DeepSeek-V2 in the port (``models/deepseek_v2.py``) against its plain
float32 reference (``benchmark/reference/deepseek_v2.py``), on the CPU at
the tiny preset with seeded random weights: logits, the balance loss and
every weight's gradient; the expert share; the dropless dispatch under
full imbalance; YaRN's tables; the flash API at q·k width 192 and v
width 128; the spans; the harness's refusals.

Tolerances: both sides compute in float32 and differ only in the order
of their sums (the port's per-expert rows are gathered and scattered, the
reference loops over experts and rows), so logits and losses agree to
atol 1e-4 and gradients, whose largest entries are near 1e-2, to atol
2e-5; the padding of the flash wrappers is exact, held to rel 1e-6 as the
existing ``_on_width`` tests are.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.families import deepseek_v2 as family  # noqa: E402
from benchmark.reference import deepseek_v2 as ref  # noqa: E402
from benchmark.reference.decoder import Precision  # noqa: E402
from benchmark.spec import HERE  # noqa: E402
from tpumon.workload_torch import harness, spans  # noqa: E402
from tpumon.workload_torch.models import deepseek_v2 as ds  # noqa: E402
from tpumon.workload_torch.models import moe  # noqa: E402
from tpumon.workload_torch.ops import core  # noqa: E402
from tpumon.workload_torch.ops import flash_attention as fa  # noqa: E402

F32 = dataclasses.replace(ds.DeepseekV2Config.tiny(), dtype=torch.float32)
SEQ = 64


def sizes_of(cfg: ds.DeepseekV2Config):
    """The benchmark family's sizes of a port config, through the
    configuration file's keys (the published names)."""
    config = json.loads((HERE / "configs" / "deepseek-v2-lite.json").read_text())
    config.update(
        vocab_size=cfg.vocab, hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim, qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim, intermediate_size=cfg.ffn_dim,
        moe_intermediate_size=cfg.moe_ffn_dim, n_routed_experts=cfg.held,
        n_shared_experts=cfg.n_shared_experts, num_experts_per_tok=cfg.top_k,
        first_k_dense_replace=cfg.first_k_dense, rms_norm_eps=cfg.rms_eps,
        aux_loss_alpha=cfg.aux_loss_alpha, learning_rate=cfg.learning_rate)
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
    return {n: torch.stack([e.grad for e in w]) if isinstance(w, list) else w.grad
            for n, w in W.items()}


def _model(cfg=F32, seed=0):
    return ds.init_params(cfg, torch.Generator().manual_seed(seed))


def _tokens(rows=2, seed=1, vocab=F32.vocab):
    return torch.randint(0, vocab, (rows, SEQ + 1),
                         generator=torch.Generator().manual_seed(seed))


def test_tiny_preset_is_the_test_size():
    cfg = ds.DeepseekV2Config.tiny()
    assert (cfg.dim, cfg.n_heads, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim,
            cfg.v_head_dim, cfg.kv_lora_rank) == (64, 4, 16, 32, 32, 32)
    assert (cfg.n_routed_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.first_k_dense, cfg.n_moe_layers) == (8, 3, 2, 1, 2)


def test_v2_lite_share_keeps_every_published_width():
    cfg = ds.DeepseekV2Config.v2_lite_share()
    assert (cfg.dim, cfg.n_heads, cfg.qk_head_dim, cfg.v_head_dim,
            cfg.kv_lora_rank, cfg.qk_rope_head_dim) == (2048, 16, 192, 128, 512, 64)
    assert (cfg.ffn_dim, cfg.moe_ffn_dim, cfg.shared_ffn_dim, cfg.top_k,
            cfg.n_routed_experts, cfg.held, cfg.expert_start) == (
        10944, 1408, 2816, 6, 64, 8, 0)
    assert (cfg.n_layers, cfg.n_moe_layers, cfg.vocab) == (27, 26, 12800)
    n = sum(math.prod(s) for s in family.param_shapes(sizes_of(cfg)).values())
    assert n == 2_743_987_712
    # YaRN's scale: mscale(40, 0.707)² / √192.
    assert cfg.softmax_scale == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2
                                              / math.sqrt(192), rel=1e-12)


def test_adamw_runs_at_the_config_s_learning_rate():
    """The share trains at 4.2e-5 (the published schedule's last rate);
    ``build_optimizer`` takes a DeepSeek-V2 config's rate, and a model
    whose config has none (Mixtral's) keeps the port's 1e-3."""
    assert ds.DeepseekV2Config.v2_lite_share().learning_rate == 4.2e-5
    assert ds.DeepseekV2Config.tiny().learning_rate == harness.LEARNING_RATE == 1e-3
    for cfg in (F32, dataclasses.replace(F32, learning_rate=4.2e-5)):
        model = _model(cfg)
        opt = harness.build_optimizer(model.named_parameters(), model)
        assert [g["lr"] for g in opt.param_groups] == [cfg.learning_rate]
    mixtral = moe.init_params(moe.MoeConfig.tiny(), torch.Generator().manual_seed(0))
    opt = harness.build_optimizer(mixtral.named_parameters(), mixtral)
    assert [g["lr"] for g in opt.param_groups] == [1e-3]


def test_the_reference_s_adamw_step_is_at_the_config_s_learning_rate():
    """AdamW's first step is lr · g / (|g| + eps) after the decay
    θ · (1 − lr · wd): the reference's update at ``Sizes.lr``. rtol 1e-6,
    atol 1e-9: f32 rounding of a few operations on weights of 0.02 and
    norms of 1, where a step at the port's 1e-3 would miss by 9.6e-4."""
    m = dataclasses.replace(sizes_of(F32), lr=4.2e-5)
    f = ref.DeepseekFollower(m, 3, "cpu", Precision())
    before = f.theta.clone()
    g = torch.randn(f.grad.shape, generator=torch.Generator().manual_seed(4))
    f.grad.copy_(g)
    f.update()
    want = before * (1 - 4.2e-5 * 1e-4) - 4.2e-5 * g / (g.abs() + 1e-8)
    torch.testing.assert_close(f.theta, want, rtol=1e-6, atol=1e-9)


def test_param_names_and_shapes_are_the_family_s():
    model = _model()
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert have == family.param_shapes(sizes_of(F32))


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_logits_aux_and_gradients_match_the_reference(attn):
    """The port's f32 forward (plain attention, or the flash API's plain
    path) against the reference's: logits and the balance loss atol 1e-4;
    the loss's gradient of every weight atol 2e-5 (see the module's
    docstring)."""
    model = _model()
    tokens = _tokens()
    impl = fa.make_flash_attn() if attn == "flash" else None
    logits, aux = model(tokens[:, :-1], impl, remat=attn == "flash")
    W = weights_of(model)
    m = sizes_of(F32)
    h, ref_aux = ref.hidden(W, tokens[:, :-1], m, Precision())
    torch.testing.assert_close(logits, h @ W["unembed"], rtol=0, atol=1e-4)
    torch.testing.assert_close(aux, ref_aux, rtol=0, atol=1e-4)
    assert aux.item() > 0.5  # a balance loss near 1 for random routing
    loss = harness.loss_fn(model, tokens, impl, remat=attn == "flash")
    ref_loss = ref.chunk_loss(W, tokens, m, Precision())
    torch.testing.assert_close(loss, ref_loss, rtol=0, atol=1e-4)
    loss.backward()
    ref_loss.backward()
    want = grads_of(W)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=2e-5,
                                   msg=lambda s, n=name: f"{n}: {s}")


def test_the_shares_of_the_experts_add_up_to_the_whole_layer():
    """Four cards of two experts each: the routed part each computes
    (its output less the shared experts', which every card computes
    alike), summed, plus the shared experts once, is the uncut reference
    layer's output; the balance loss is the same on every card."""
    whole = _model()
    layer = whole.blocks[1]
    x = torch.randn(2, SEQ, F32.dim, generator=torch.Generator().manual_seed(3))
    W = weights_of(whole)
    want, want_aux = ref.moe(W, 1, x, sizes_of(F32), Precision())
    shared = ds._shared(x, layer.shared_gate, layer.shared_up, layer.shared_down,
                        F32.dtype)
    total = shared.clone()
    for start in range(0, 8, 2):
        cfg = dataclasses.replace(F32, expert_start=start, experts_held=2)
        block = ds.Block(cfg, moe=True)
        with torch.no_grad():
            for name, p in block.named_parameters():
                src = getattr(layer, name)
                p.copy_(src[start:start + 2] if src.dim() == 3 else src)
        out, aux = block.moe_mlp(x)
        torch.testing.assert_close(aux, want_aux, rtol=0, atol=1e-6)
        total = total + (out - shared)
    torch.testing.assert_close(total, want, rtol=0, atol=1e-5)


def test_dropless_under_full_imbalance():
    """Every token routed to the same three experts: each of them takes
    every token (no capacity, nothing dropped), the counter says so, and
    the output is each token's gated sum over them."""
    T, D, F_ = 96, 16, 8
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(T, D, generator=gen)
    banks = [torch.randn(4, D, F_, generator=gen), torch.randn(4, D, F_, generator=gen),
             torch.randn(4, F_, D, generator=gen)]
    experts = torch.tensor([[2, 0, 1]]).expand(T, 3)
    gates = torch.rand(T, 3, generator=gen)
    moe.reset_dropless_counts()
    out = moe.dropless_experts(x, experts, gates, *banks, start=0, dtype=torch.float32)
    assert moe.dropless_counts == {"rows": {0: T, 1: T, 2: T, 3: 0}, "host_reads": 1}
    want = torch.zeros(T, D)
    for j, e in enumerate((2, 0, 1)):
        y = (torch.nn.functional.silu(x @ banks[0][e]) * (x @ banks[1][e])) @ banks[2][e]
        want += gates[:, j:j + 1] * y
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    # A share that holds none of them adds nothing.
    none = moe.dropless_experts(x, experts, gates, *banks, start=4, dtype=torch.float32)
    assert torch.count_nonzero(none) == 0


def test_sort_by_expert_is_stable_and_puts_the_absent_last():
    experts = torch.tensor([[5, 1], [1, 2], [0, 5], [2, 1]])
    order, counts = moe.sort_by_expert(experts, start=1, held=2)
    assert counts.tolist() == [3, 2]
    # Pairs (flat index = 2·token + choice) of expert 1, then 2, in token
    # order; then the pairs of experts 0 and 5.
    assert order[:5].tolist() == [1, 2, 7, 3, 6]
    assert sorted(order[5:].tolist()) == [0, 4, 5]


def test_yarn_freqs_and_mscale_against_their_closed_forms():
    d, theta, factor = 64, 1e4, 40.0
    got = core.yarn_freqs(d, 4096, theta, factor, 4096, 32.0, 1.0)
    assert got.shape == (4096, 32)
    # Pair i turns 4096·inv_i / 2π times over 4096 positions: the ramp
    # runs from pair ⌊10.47⌋ = 10 (32 turns) to pair ⌈22.5⌉ = 23 (one).
    i = np.arange(32)
    extra = theta ** (-2.0 * i / d)
    ramp = np.clip((i - 10) / 13.0, 0.0, 1.0)
    inv = extra / factor * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(got[1].numpy(), inv, rtol=1e-6)
    np.testing.assert_allclose(got[4095].numpy(), 4095 * inv, rtol=1e-6)
    # Factor 1 is plain RoPE.
    torch.testing.assert_close(core.yarn_freqs(d, 128, theta, 1.0),
                               core.rope_freqs(d, 128, theta), rtol=1e-6, atol=0)
    assert core.yarn_mscale(40.0, 0.707) == pytest.approx(1 + 0.0707 * math.log(40))
    assert core.yarn_mscale(1.0, 0.707) == 1.0


def _mla_inputs(B=2, S=48, H=4, seed=5):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    return randn(B, S, H, 192), randn(B, S, H, 192), randn(B, S, H, 128), randn(B, S, H, 128)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_qk_192_and_v_128_pads_exactly(causal):
    """The wrappers' padding path (``_on_width``: v and dO padded to the
    q·k width 192 for flash_fwd and flash_dq, O sliced back to 128, and at
    128 as they are for flash_dkv, the scale given) on the plain versions,
    against the plain versions on the unpadded inputs: forward and
    backward at f32 rel 1e-6."""
    q, k, v, do = _mla_inputs()
    scale = 0.1147
    o, lse = fa._on_width("flash_fwd", fa.flash_fwd_reference, q, k, v,
                          causal=causal, scale=scale)
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = fa.flash_delta(want_o, do)
    dq = fa._on_width("flash_dq", fa.flash_dq_reference, q, k, v, do, want_lse,
                      delta, causal=causal, scale=scale)
    dk, dv = fa._on_width("flash_dkv", fa.flash_dkv_reference, q, k, v, do,
                          want_lse, delta, causal=causal, scale=scale)
    want = [want_o, want_lse,
            fa.flash_dq_reference(q, k, v, do, want_lse, delta, causal, scale),
            *fa.flash_dkv_reference(q, k, v, do, want_lse, delta, causal, scale)]
    for name, got, w in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, dq, dk, dv), want):
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6, atol=0,
                                   err_msg=name)
    assert o.shape[3] == dv.shape[3] == 128 and dq.shape[3] == dk.shape[3] == 192
    assert o.is_contiguous() and dv.is_contiguous()  # the sliced outputs


def test_flash_api_with_a_scale_matches_dense_attention():
    """flash_attention at q·k 192 / v 128 and a scale, forward and
    backward through autograd, against dense softmax attention (f32
    atol 1e-5); an impl of make_flash_attn takes softmax_scale's inside
    the block, and 1/√192 outside it."""
    q, k, v, do = _mla_inputs(seed=6)
    scale = 0.1147
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, scale=scale)
    out.backward(do)
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", dense[0], dense[1]) * scale
    s = s.masked_fill(torch.ones(48, 48, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), dense[2])
    want.backward(do)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    for a, b in zip(leaves, dense):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5)
    impl = fa.make_flash_attn()
    with fa.softmax_scale(scale):
        torch.testing.assert_close(impl(q, k, v), out.detach(), rtol=0, atol=0)
    torch.testing.assert_close(impl(q, k, v), fa.flash_attention(q, k, v),
                               rtol=0, atol=0)


def test_the_model_s_spans_and_their_backward_halves():
    """A profiled train step of two micro-batches with remat opens each of
    the new spans at the counts of the shape: every layer's forward twice
    (remat's recompute), its backward once; the latent attention in all
    three layers, the dense SwiGLU in layer 0, routing and the dispatch
    in the two MoE layers."""
    model = _model(ds.DeepseekV2Config.tiny())
    opt = harness.build_optimizer(model.named_parameters(), model)
    step = harness.make_train_step(model, opt, fa.make_flash_attn(), grad_accum=2,
                                   remat=True)
    tokens = _tokens(rows=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(tokens)
    counts: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            name = e.name()[len(spans.PREFIX):]
            counts[name] = counts.get(name, 0) + 1
    M, L, MOE = 2, 3, 2
    per_layer = {"latent": L, "qkv": L, "attn_core": L, "attn_out": L, "layer": L,
                 "mlp": L - MOE, "router": MOE, "permute": MOE, "experts": MOE,
                 "unpermute": MOE, "shared": MOE}
    for name, n in per_layer.items():
        assert counts.get(name) == 2 * M * n, name
        assert counts.get(f"{name}.bwd") == M * n, name
    assert counts["rope"] == 2 * M * L * 2  # q's and the shared key's
    assert counts["step"] == 1 and counts["optimizer"] == 1


def test_the_harness_refuses_meshes_and_loss_chunk():
    cfg = ds.DeepseekV2Config.tiny()
    for axis in ("dp", "tp", "sp", "pp", "ep"):
        with pytest.raises(ValueError, match=f"one device.*{axis}=2"):
            harness.run(cfg, steps=1, batch=4, seq=32, device="cpu", **{axis: 2})
    with pytest.raises(ValueError, match="loss_chunk"):
        harness.run(cfg, steps=1, batch=2, seq=32, device="cpu", loss_chunk=16)


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--ep", "2"], ["--loss-chunk", "16"]])
def test_the_cli_refuses_them_before_any_rank_starts(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        harness.main(["--model", "deepseek_v2", "--platform", "cpu", *flags])
    assert exc.value.code == 2
    assert "DeepSeek-V2" in capsys.readouterr().err


def test_cli_trains_the_tiny_preset(caplog):
    caplog.set_level("INFO")
    assert harness.main(["--model", "deepseek_v2", "--preset", "tiny", "--platform",
                         "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                         "--attn", "flash", "--remat"]) == 0
    assert any("GFLOP/step" in r.getMessage() for r in caplog.records)


def test_flops_count_the_layers_of_the_published_shape():
    """The port's count (attention at S², as flops.py counts) against the
    benchmark family's (S(S+1)/2 pairs): they differ only in the core; a
    step is three of the port's forwards."""
    from tpumon.workload_torch import flops

    cfg = ds.DeepseekV2Config.v2_lite_share()
    m = sizes_of(cfg)
    B, S = 4, 4096
    core_s2 = 2 * B * S * S * 16 * (192 + 128) * 27
    core_pairs = 2 * B * 16 * (S * (S + 1) // 2) * (192 + 128) * 27
    assert ds.forward_flops(cfg, B, S) - core_s2 == pytest.approx(
        family.forward_flops(m, B, S) - core_pairs, rel=1e-12)
    assert flops.train_flops_per_step(cfg, B, S) == 3.0 * ds.forward_flops(cfg, B, S)


@pytest.mark.cuda
def test_a_step_on_card_matches_the_cpu():
    """The tiny preset's loss in bf16 on the card (flash kernels at width
    64 padded, grouped expert products) against the same on the CPU
    (plain paths, the expert loop): rel 2e-2, bf16 products both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = ds.DeepseekV2Config.tiny()
    cpu = _model(cfg)
    card = _model(cfg).cuda()
    card.load_state_dict(cpu.state_dict())
    tokens = _tokens()
    want = harness.loss_fn(cpu, tokens, fa.make_flash_attn(), remat=True)
    got = harness.loss_fn(card, tokens.cuda(), fa.make_flash_attn(), remat=True)
    assert got.item() == pytest.approx(want.item(), rel=2e-2)
