"""Plain float32 reference of the MiMo-V2-Flash configurations, and its
training step.

It follows the published configuration's equations (``config.json`` of
XiaomiMiMo/MiMo-V2-Flash; the bias update of DeepSeek-V3,
arXiv:2412.19437): token embedding; per layer RMSNorm, then grouped-query
attention of the layer's kind by ``hybrid_layer_pattern``: q = x·Wq per
head at the q·k width, k = x·Wk and v = x·Wv per kv head (the kind's
count), v × ``attention_value_scale``; the rotary embedding of the kind's
θ on the first ``partial_rotary_factor`` of each q and k head's columns;
causal attention scaled by 1/√(q·k width) over every earlier key (full
layers) or the last ``sliding_window`` keys (window layers), a window
layer's softmax running over its keys and one learnable sink logit a
head that has no value; the output projection and the residual. Then
RMSNorm and, where ``moe_layer_freq`` is 0, a dense SwiGLU; elsewhere a
float32 router s = sigmoid(x·W) over every routed expert, the top-k of
s + the layer's correction bias chosen, gates s over the k's sum; each
held expert's SwiGLU on the tokens routed to it times its gate. Final
RMSNorm, unembed, mean next-token cross-entropy, with no balance loss.
The gradients by autograd and the AdamW update on one flat float32 vector
(``decoder.Follower``'s, at the configuration's ``Sizes.lr``); then each
MoE layer's bias b_i += γ·sign(mean load − load_i), the loads being every
routed expert's count of choices over the step's tokens.

Departures, as the port runs the configuration (its file's
``departures``):

- no multi-token-prediction layers;
- only the experts held (``Sizes.held`` from ``Sizes.expert_start``) add
  their part; the others' is left out, as on one card of an
  expert-parallel job before its exchange;
- RoPE turns split halves of the rotary columns (a fixed permutation of
  those columns of Wq and Wk, the same function).

Every product goes through ``Precision.mm`` (float32 with TF32 off, or
the float8 control). Each sequence's attention sublayer is recomputed in
the backward, and within it each block of :data:`QUERY_BLOCK` queries'
scores, so that a sequence of 32,768 fits beside the optimizer state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import seeded
from benchmark.reference.decoder import (  # noqa: F401 (the interface)
    BETA1,
    BETA2,
    EPS,
    WEIGHT_DECAY,
    Follower,
    ForcedRouting,
    Precision,
    rms_norm,
    strict_f32,
)

#: Query rows a block of the attention's scores holds: a full layer's
#: block at 32,768 keys and 64 heads is 1 GiB of float32 scores.
QUERY_BLOCK = 128


def rope_tables(m, theta: float, seq: int, device):
    """cos and sin [seq, 1, rotary/2] of the rotary angles at ``theta``."""
    half = torch.arange(0, m.rotary, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (half / m.rotary))
    ang = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def rope(x, cos, sin, rotary: int):
    """x [S, heads, d]: turn the two halves of its first ``rotary``
    columns; the others as they are."""
    x1, x2 = x[..., :rotary].chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, x[..., rotary:]],
                     dim=-1)


def _block(q, k, v, sinks, i0: int, k0: int, window: int, prec):
    """Queries i0… of one sequence, q [KV, rep, b, Dqk] (scaled; q-head
    h = kv·rep + r reads kv-head kv), against keys k0…, k [KV, Dqk, n] and
    v [KV, n, Dv]: causal, within ``window`` keys (0: all), softmax over
    the live keys and the sink logit [H] where given → [H, b, Dv]."""
    KV, rep, b, D = q.shape
    n = k.shape[2]
    s = prec.mm(q.reshape(KV, rep * b, D), k).reshape(KV * rep, b, n)
    i = torch.arange(i0, i0 + b, device=q.device)[:, None]
    j = torch.arange(k0, k0 + n, device=q.device)[None, :]
    dead = j > i
    if window:
        dead = dead | (j <= i - window)
    s = s.masked_fill(dead, float("-inf"))
    if sinks is not None:
        s = torch.cat([s, sinks[:, None, None].expand(KV * rep, b, 1)], dim=-1)
        p = torch.softmax(s, dim=-1)[..., :n]
    else:
        p = torch.softmax(s, dim=-1)
    out = prec.mm(p.reshape(KV, rep * b, n), v)  # [KV, rep·b, Dv]
    return out.reshape(KV * rep, b, -1)


def _attention_row(x, wq, wk, wv, wo, sinks, cos, sin, window, m, prec):
    """One sequence's attention sublayer of one kind: x [S, D] → [S, D]."""
    S, H = x.shape[0], m.n_heads
    q = prec.mm(x, wq).reshape(S, H, m.qk_head)
    k = prec.mm(x, wk).reshape(S, -1, m.qk_head)
    v = prec.mm(x, wv).reshape(S, -1, m.v_head) * m.value_scale
    q = rope(q, cos, sin, m.rotary) / math.sqrt(m.qk_head)
    k = rope(k, cos, sin, m.rotary)
    KV = k.shape[1]
    qh = q.reshape(S, KV, H // KV, m.qk_head).permute(1, 2, 0, 3)  # [KV, rep, S, Dqk]
    kh = k.permute(1, 2, 0)  # [KV, Dqk, S]
    vh = v.transpose(0, 1)  # [KV, S, Dv]
    parts = []
    for i0 in range(0, S, QUERY_BLOCK):
        i1 = min(i0 + QUERY_BLOCK, S)
        k0 = max(i0 - window + 1, 0) if window else 0
        parts.append(checkpoint(_block, qh[:, :, i0:i1], kh[:, :, k0:i1],
                                vh[:, k0:i1], sinks, i0, k0, window, prec,
                                use_reentrant=False))
    out = torch.cat(parts, dim=1).transpose(0, 1).reshape(S, H * m.v_head)
    return prec.mm(out, wo)


def attention(W, i, x, tables, m, prec):
    """x [R, S, D] → [R, S, D], one sequence at a time, recomputed in the
    backward."""
    b = f"blocks.{i}."
    cos, sin = tables[m.is_swa(i)]
    window = m.window if m.is_swa(i) else 0
    w = [W[b + k] for k in ("wq", "wk", "wv", "wo")]
    sinks = W[b + "sinks"] if m.has_sink(i) else None
    rows = [checkpoint(_attention_row, x[r], *w, sinks, cos, sin, window, m, prec,
                       use_reentrant=False) for r in range(len(x))]
    return torch.stack(rows)


def swiglu(x, w_gate, w_up, w_down, prec):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def _swiglu(x, w_gate, w_up, w_down, prec):
    """:func:`swiglu`, recomputed in the backward."""
    return checkpoint(swiglu, x, w_gate, w_up, w_down, prec, use_reentrant=False)


def moe(W, i, h, bias, load, m, prec, forced: ForcedRouting | None = None):
    """h [R, S, D] → the held routed experts' outputs; adds each routed
    expert's count of choices to ``load``."""
    R, S, D = h.shape
    b = f"blocks.{i}."
    scores = torch.sigmoid(prec.mm(h, W[b + "router"]))  # [R, S, E]
    if forced is None:
        experts = (scores + bias).topk(m.top_k, dim=-1).indices
    else:
        experts = forced.experts(i, scores + bias)
    top = scores.gather(-1, experts)
    gates = top / top.sum(dim=-1, keepdim=True)
    load += torch.bincount(experts.reshape(-1), minlength=m.n_routed)
    flat = h.reshape(R * S, D)
    experts, gates = experts.reshape(R * S, -1), gates.reshape(R * S, -1)
    out = torch.zeros_like(flat)
    for j in range(m.held):
        tok, slot = (experts == m.expert_start + j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(flat[tok], W[b + "w_gate"][j], W[b + "w_up"][j],
                    W[b + "w_down"][j], prec)
        out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    return out.reshape(R, S, D)


def _nll_sum(h, unembed, targets, prec):
    return F.cross_entropy(prec.mm(h, unembed), targets, reduction="sum")


def hidden(W, inputs, m, prec, bias, load, forced: ForcedRouting | None = None):
    """inputs [R, S] → the final norm's output [R, S, D], the MoE layers
    routing with ``bias`` and counting into ``load`` (by layer)."""
    S = inputs.shape[1]
    x = W["embed"][inputs]
    tables = {swa: rope_tables(m, m.theta_swa if swa else m.theta_full, S, x.device)
              for swa in (False, True)}
    for i in range(m.n_layers):
        x = x + attention(W, i, rms_norm(x, W[f"blocks.{i}.attn_norm"], m.eps),
                          tables, m, prec)
        h = rms_norm(x, W[f"blocks.{i}.mlp_norm"], m.eps)
        b = f"blocks.{i}."
        if m.is_moe(i):
            out = moe(W, i, h, bias[i], load[i], m, prec, forced)
        else:
            out = _swiglu(h, W[b + "w_gate"], W[b + "w_up"], W[b + "w_down"], prec)
        x = x + out
    return rms_norm(x, W["final_norm"], m.eps)


def chunk_loss(W, tokens, m, prec, bias, load, forced: ForcedRouting | None = None):
    """Mean next-token cross-entropy of ``tokens`` [R, S + 1] (:func:`hidden`,
    then the unembed)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h = hidden(W, inputs, m, prec, bias, load, forced)
    # One sequence's [S, vocab] float32 logits at a time, recomputed in
    # the backward.
    loss = sum(checkpoint(_nll_sum, h[r], W["unembed"], targets[r], prec,
                          use_reentrant=False) for r in range(len(h)))
    return loss / targets.numel()


class MimoFollower(Follower):
    """``decoder.Follower`` (the seeded flat weights, AdamW) with this
    model's loss, the configuration's learning rate, and each MoE layer's
    correction bias (zero at the start) and loads of the step."""

    def __init__(self, m, seed: int, device, prec: Precision | None = None,
                 forced: ForcedRouting | None = None) -> None:
        super().__init__(m, seed, device, prec, forced)
        moe_layers = [i for i in range(m.n_layers) if m.is_moe(i)]
        self.bias = {i: torch.zeros(m.n_routed, device=device) for i in moe_layers}
        self.load = {i: torch.zeros(m.n_routed, dtype=torch.int64, device=device)
                     for i in moe_layers}

    def step(self, batch, grad_accum: int, rows_per_pass: int) -> float:
        self.grad.zero_()
        for load in self.load.values():
            load.zero_()
        total = 0.0
        for a in range(grad_accum):
            chunk = batch[a::grad_accum]
            for r in range(0, len(chunk), rows_per_pass):
                part = chunk[r:r + rows_per_pass]
                loss = chunk_loss(self.W, part, self.m, self.prec, self.bias,
                                  self.load, self.forced)
                weight = len(part) / len(chunk) / grad_accum
                (loss * weight).backward()
                total += float(loss.detach()) * weight
        return total

    @torch.no_grad()
    def update(self) -> None:
        """AdamW (decoupled weight decay) on the flat vector at
        ``Sizes.lr``, then the bias update from the step's loads."""
        g, p, lr = self.grad, self.theta, self.m.lr
        if self.exp_avg is None:
            self.exp_avg, self.exp_avg_sq = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        p.mul_(1.0 - lr * WEIGHT_DECAY)
        self.exp_avg.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
        self.exp_avg_sq.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
        denom = (self.exp_avg_sq.sqrt() / math.sqrt(1.0 - BETA2 ** self.t)).add_(EPS)
        p.addcdiv_(self.exp_avg, denom, value=-lr / (1.0 - BETA1 ** self.t))
        for i, load in self.load.items():
            mean = load.double().mean()
            self.bias[i] += self.m.gamma * torch.sign(mean - load.double()).float()


def follow(m, seed: int, batches, grad_accum: int, rows_per_pass: int,
           steps: int, device, prec: Precision | None = None,
           projections: bool = True, forced: ForcedRouting | None = None) -> dict:
    """The reference's first ``steps`` steps on ``batches[0..steps)``, as
    ``decoder.follow``: each step's loss, every leaf's gradient norm (and
    projections) at step 1, and every leaf's change after the last."""
    strict_f32()
    f = MimoFollower(m, seed, device, prec, forced)
    losses, grad_norms, grad_proj = [], None, None
    for s in range(steps):
        losses.append(f.step(batches[s], grad_accum, rows_per_pass))
        if s == 0:
            grad_norms = f.leaf_norms(f.grad)
            if projections:
                grad_proj = seeded.projections(m, seed, f.views(f.grad))
        f.update()
    out = {"losses": losses, "grad_norms": grad_norms, "grad_proj": grad_proj,
           "change_norms": f.change_norms()}
    del f
    return out
