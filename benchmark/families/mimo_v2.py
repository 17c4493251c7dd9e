"""MiMo-V2-Flash: the port's ``models.mimo_v2.MimoV2``.

Two kinds of attention layer by the published ``hybrid_layer_pattern``:
full grouped-query attention (``num_key_value_heads`` kv heads, θ
``rope_theta``) and sliding-window attention over the last
``sliding_window`` keys (``swa_num_key_value_heads`` kv heads, θ
``swa_rope_theta``, one learnable sink logit a head), both at q·k width
``head_dim`` and v width ``v_head_dim``, RoPE on the first
``partial_rotary_factor`` of the q·k columns, v scaled by
``attention_value_scale``. Layers whose ``moe_layer_freq`` entry is 0 end
in a dense SwiGLU, the others in a sigmoid-routed mixture with a
per-expert correction bias (``noaux_tc``), top-k gates renormalised.

The configuration runs the published layers that ``layers_run`` names
(all of them when absent), reading both 48-entry lists there. With
``expert_share`` it holds a card's share of the routed experts:
``n_routed_experts`` then counts the experts held (a key in
``reduced``), ``expert_share`` the router's width and the first expert
held. ``learning_rate`` is AdamW's and ``bias_update_rate`` the bias
update's γ, for the program and the reference alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.flops import causal_pairs
from benchmark.hybrid_work import window_pairs


@dataclass(frozen=True)
class Sizes:
    """The sizes the program and the reference share, from a config file."""
    family: str
    vocab: int
    dim: int
    n_heads: int
    kv_full: int
    kv_swa: int
    qk_head: int
    v_head: int
    rotary: int
    theta_full: float
    theta_swa: float
    window: int
    value_scale: float
    layer_types: tuple[int, ...]  # 0 full, 1 window, by layer as run
    moe_layers: tuple[int, ...]
    ffn: int  # the dense layers' SwiGLU
    moe_ffn: int  # an expert's SwiGLU
    n_routed: int  # the router's width: every routed expert
    held: int  # routed experts held here
    expert_start: int
    top_k: int
    gamma: float  # the bias update's rate
    eps: float
    lr: float  # AdamW's learning rate

    @property
    def n_layers(self) -> int:
        return len(self.layer_types)

    def is_swa(self, i: int) -> bool:
        return self.layer_types[i] == 1

    def is_moe(self, i: int) -> bool:
        return self.moe_layers[i] == 1

    def kv_heads(self, i: int) -> int:
        return self.kv_swa if self.is_swa(i) else self.kv_full

    def has_sink(self, i: int) -> bool:
        """A window layer has its sinks, a full layer none."""
        return self.is_swa(i)


def sizes(config: dict) -> Sizes:
    layers = config.get("layers_run", list(range(config["num_hidden_layers"])))
    if len(layers) != config["num_hidden_layers"]:
        raise ValueError("families/mimo_v2.py: layers_run must name "
                         "num_hidden_layers layers")
    fixed = {"swa_num_attention_heads": config["num_attention_heads"],
             "swa_head_dim": config["head_dim"],
             "swa_v_head_dim": config["v_head_dim"],
             "sliding_window_size": config["sliding_window"],
             "add_swa_attention_sink_bias": True,
             "add_full_attention_sink_bias": False,
             "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "norm_topk_prob": True, "n_group": 1, "topk_group": 1,
             "routed_scaling_factor": None}
    for key, want in fixed.items():
        if config[key] != want:
            raise ValueError(f"families/mimo_v2.py: {key} {config[key]!r} is "
                             f"not supported (MiMo-V2-Flash's is {want!r})")
    if config.get("n_shared_experts"):
        raise ValueError("families/mimo_v2.py: shared experts are not supported")
    share = config.get("expert_share", {})
    qk = config["head_dim"]
    return Sizes(
        family=config["family"],
        vocab=config["vocab_size"],
        dim=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        kv_full=config["num_key_value_heads"],
        kv_swa=config["swa_num_key_value_heads"],
        qk_head=qk,
        v_head=config["v_head_dim"],
        rotary=int(config["partial_rotary_factor"] * qk) // 2 * 2,
        theta_full=float(config["rope_theta"]),
        theta_swa=float(config["swa_rope_theta"]),
        window=config["sliding_window"],
        value_scale=float(config["attention_value_scale"]),
        layer_types=tuple(config["hybrid_layer_pattern"][i] for i in layers),
        moe_layers=tuple(config["moe_layer_freq"][i] for i in layers),
        ffn=config["intermediate_size"],
        moe_ffn=config["moe_intermediate_size"],
        n_routed=share.get("router_width", config["n_routed_experts"]),
        held=config["n_routed_experts"],
        expert_start=share.get("expert_start", 0),
        top_k=config["num_experts_per_tok"],
        gamma=float(config["bias_update_rate"]),
        eps=float(config["layernorm_epsilon"]),
        lr=float(config.get("learning_rate", 1e-3)),
    )


def port_model(m: Sizes, seq: int, device):
    from tpumon.workload_torch.models.mimo_v2 import MimoV2, MimoV2Config

    cfg = MimoV2Config(
        vocab=m.vocab, dim=m.dim, n_heads=m.n_heads, n_kv_heads=m.kv_full,
        swa_n_kv_heads=m.kv_swa, head_dim=m.qk_head, v_head_dim=m.v_head,
        rotary_dim=m.rotary, rope_theta=m.theta_full, swa_rope_theta=m.theta_swa,
        sliding_window=m.window, value_scale=m.value_scale,
        layer_types=m.layer_types,
        moe_layers=m.moe_layers, ffn_dim=m.ffn, moe_ffn_dim=m.moe_ffn,
        n_routed_experts=m.n_routed, top_k=m.top_k,
        bias_update_rate=m.gamma,
        rms_eps=m.eps, max_seq=seq, expert_start=m.expert_start,
        experts_held=m.held, learning_rate=m.lr, dtype=torch.bfloat16)
    return MimoV2(cfg, device)


def layer_shapes(m: Sizes, i: int) -> dict[str, tuple[int, ...]]:
    """Layer i's weights: [in, out] matrices, the sinks [H] where it has
    them, expert banks [E', in, out]."""
    D, H, KV = m.dim, m.n_heads, m.kv_heads(i)
    shapes = {
        "attn_norm": (D,),
        "wq": (D, H * m.qk_head),
        "wk": (D, KV * m.qk_head),
        "wv": (D, KV * m.v_head),
        "wo": (H * m.v_head, D),
    }
    if m.has_sink(i):
        shapes["sinks"] = (H,)
    shapes["mlp_norm"] = (D,)
    if not m.is_moe(i):
        shapes.update(w_gate=(D, m.ffn), w_up=(D, m.ffn), w_down=(m.ffn, D))
        return shapes
    E, F = m.held, m.moe_ffn
    shapes.update(router=(D, m.n_routed), w_gate=(E, D, F), w_up=(E, D, F),
                  w_down=(E, F, D))
    return shapes


def param_shapes(m: Sizes) -> dict[str, tuple[int, ...]]:
    shapes = {"embed": (m.vocab, m.dim)}
    for i in range(m.n_layers):
        shapes.update({f"blocks.{i}.{k}": s for k, s in layer_shapes(m, i).items()})
    shapes.update(final_norm=(m.dim,), unembed=(m.dim, m.vocab))
    return shapes


def forward_flops(m: Sizes, batch: int, seq: int) -> float:
    """Matmul FLOPs of one forward, 2·m·n·k a product at the true widths:
    each layer's q, k, v and output projections at its kind's kv heads;
    the full layers' causal core over S(S+1)/2 pairs and the window
    layers' over their windowed pairs (:func:`window_pairs`), scores at
    the q·k width and probs·V at the v width; the dense layers' SwiGLU;
    each MoE layer's router and the held experts' expected share of the
    top-k (k · held / E a token, no padding); the unembed."""
    T, D, H = batch * seq, m.dim, m.n_heads
    total = 2 * T * D * m.vocab
    for i in range(m.n_layers):
        KV = m.kv_heads(i)
        total += 2 * T * D * (H * m.qk_head + KV * (m.qk_head + m.v_head))
        total += 2 * T * H * m.v_head * D
        pairs = window_pairs(seq, m.window) if m.is_swa(i) else causal_pairs(seq)
        total += 2 * batch * H * pairs * (m.qk_head + m.v_head)
        if m.is_moe(i):
            total += 2 * T * D * m.n_routed
            total += 6 * T * D * m.moe_ffn * m.top_k * m.held / m.n_routed
        else:
            total += 6 * T * D * m.ffn
    return float(total)


def train_flops_per_step(m: Sizes, batch: int, seq: int) -> float:
    """Forward and backward (2× the forward) of one optimizer step."""
    return 3.0 * forward_flops(m, batch, seq)


def attn_shape(m: Sizes, micro_batch: int, seq: int) -> None:
    """None: the flash rooflines' shape has one kind of call; the hybrid
    rooflines (``metrics/hybrid_*_roofline.py``, ``metrics/swa_roofline.py``)
    count each kind from the record's configuration."""
    return None
