"""Plain float32 reference of the DeepSeek-V2 configurations
(DeepSeek-V2-Lite), and its training step.

It follows the published equations (arXiv:2405.04434; the published
``modeling_deepseek.py``) with ``q_lora_rank`` null: token embedding; per
layer RMSNorm, then multi-head latent attention: q = x·Wq split per head
into nope and rope columns; x·Wkv_a split into the latent c and one rope
key shared by the heads; k_nope and v per head from RMSNorm(c)·Wkv_b;
YaRN's rotary embedding on the rope columns of q and of the shared key;
causal attention at the q·k width nope + rope, scaled by
mscale(factor, mscale_all_dim)² / √(q·k width), over v; the output
projection and the residual. Then RMSNorm and, in the first
``first_k_dense_replace`` layers, a dense SwiGLU; in the others
DeepSeekMoE: a float32 softmax router over every routed expert, greedy
top-k, gates the chosen probabilities (not renormalised) ×
``routed_scaling_factor``, each held expert's SwiGLU on the tokens routed
to it times its gate, plus the shared experts' SwiGLU on every token.
Final RMSNorm, unembed, mean next-token cross-entropy plus α × the
sequence-level balance loss (``seq_aux``: for each sequence Σ_i f_i·P_i,
f_i = E/(k·S) × expert i's count among its choices, P_i its mean
probability; the mean over sequences), averaged over the MoE layers. The
gradients by autograd and the AdamW update on one flat float32 vector
(``decoder.Follower``'s, at the configuration's ``Sizes.lr``).

Departures, as the port runs the configuration:

- RoPE turns split halves of the rope columns, where the published
  weights pair interleaved columns (a fixed permutation of the rope
  columns of Wq and Wkv_a);
- only the experts held (``Sizes.held`` from ``Sizes.expert_start``) add
  their part; the others' is left out, as on one card of an
  expert-parallel job before its exchange;
- no token is dropped, as ``modeling_deepseek.py`` runs it, where the V2
  paper drops tokens at a device budget during training;
- the balance loss is averaged over the MoE layers, where
  ``modeling_deepseek.py`` adds each layer's.

Every product goes through ``Precision.mm`` (float32 with TF32 off, or
the float8 control). Each sequence's attention, and each SwiGLU, is
recomputed in the backward, so that a sequence of 4096 fits beside the
optimizer state.
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


def mscale(factor: float, m: float) -> float:
    """``yarn_get_mscale``: 0.1·m·ln(factor) + 1 above a factor of 1."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_tables(m, seq: int, device):
    """cos and sin [seq, 1, rope/2] of YaRN's angles
    (``DeepseekV2YarnRotaryEmbedding``): each pair's inverse frequency
    blends θ^(−2i/d) and θ^(−2i/d)/factor by a linear ramp between the
    pairs that turn ``beta_fast`` and ``beta_slow`` times over the
    original context."""
    d = m.qk_rope

    def pair(turns):
        return d * math.log(m.original_max / (turns * 2 * math.pi)) / (2 * math.log(m.rope_theta))

    low = max(math.floor(pair(m.beta_fast)), 0)
    high = min(math.ceil(pair(m.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / (m.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                   device=device) / d))
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv = (extra / m.rope_factor) * ramp + extra * (1 - ramp)
    ang = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def rope(x, cos, sin):
    """x [S, H, d]: turn the two halves of its columns."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mla_row(x, wq, wkv_a, kv_norm, wkv_b, wo, cos, sin, m, prec):
    """One sequence's latent attention: x [S, D] → [S, D]."""
    S, H = x.shape[0], m.n_heads
    q = prec.mm(x, wq).reshape(S, H, m.qk_head)
    q_nope, q_pe = q.split([m.qk_nope, m.qk_rope], dim=-1)
    c, k_pe = prec.mm(x, wkv_a).split([m.kv_lora_rank, m.qk_rope], dim=-1)
    kv = prec.mm(rms_norm(c, kv_norm, m.eps), wkv_b).reshape(S, H, m.qk_nope + m.v_head)
    k_nope, v = kv.split([m.qk_nope, m.v_head], dim=-1)
    q = torch.cat([q_nope, rope(q_pe, cos, sin)], dim=-1)
    k_pe = rope(k_pe[:, None, :], cos, sin).expand(S, H, m.qk_rope)
    k = torch.cat([k_nope, k_pe], dim=-1)
    scale = mscale(m.rope_factor, m.mscale_all_dim) ** 2 / math.sqrt(m.qk_head)
    s = prec.mm(q.transpose(0, 1), k.permute(1, 2, 0)) * scale  # [H, S, S]
    above = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
    out = prec.mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(S, H * m.v_head)
    return prec.mm(out, wo)


def attention(W, i, x, cos, sin, m, prec):
    """x [R, S, D] → [R, S, D], one sequence at a time, recomputed in the
    backward."""
    w = [W[f"blocks.{i}.{k}"] for k in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")]
    rows = [checkpoint(_mla_row, x[r], *w, cos, sin, m, prec, use_reentrant=False)
            for r in range(len(x))]
    return torch.stack(rows)


def swiglu(x, w_gate, w_up, w_down, prec):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def _swiglu(x, w_gate, w_up, w_down, prec):
    """:func:`swiglu`, recomputed in the backward."""
    return checkpoint(swiglu, x, w_gate, w_up, w_down, prec, use_reentrant=False)


def balance_loss(probs, experts, m):
    """Σ_i f_i·P_i of each sequence of probs [R, S, E] and its choices
    experts [R, S, k], the mean over the R sequences."""
    R, S, E = probs.shape
    counts = F.one_hot(experts, E).sum(dim=(1, 2)).float()  # [R, E]
    f = counts * E / (m.top_k * S)
    return (f * probs.mean(dim=1)).sum(dim=-1).mean()


def moe(W, i, h, m, prec, forced: ForcedRouting | None = None):
    """h [R, S, D] → (the shared experts' and the held routed experts'
    outputs, the layer's balance loss)."""
    R, S, D = h.shape
    b = f"blocks.{i}."
    probs = torch.softmax(prec.mm(h, W[b + "router"]), dim=-1)  # [R, S, E]
    if forced is None:
        experts = probs.topk(m.top_k, dim=-1).indices
    else:
        experts = forced.experts(i, probs)
    gates = probs.gather(-1, experts) * m.routed_scale
    flat = h.reshape(R * S, D)
    experts, gates = experts.reshape(R * S, -1), gates.reshape(R * S, -1)
    out = _swiglu(flat, W[b + "shared_gate"], W[b + "shared_up"],
                  W[b + "shared_down"], prec)
    for j in range(m.held):
        tok, slot = (experts == m.expert_start + j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(flat[tok], W[b + "w_gate"][j], W[b + "w_up"][j],
                    W[b + "w_down"][j], prec)
        out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    return out.reshape(R, S, D), balance_loss(probs, experts.reshape(R, S, -1), m)


def _nll_sum(h, unembed, targets, prec):
    return F.cross_entropy(prec.mm(h, unembed), targets, reduction="sum")


def hidden(W, inputs, m, prec, forced: ForcedRouting | None = None):
    """inputs [R, S] → (the final norm's output [R, S, D], the balance
    loss of these sequences averaged over the MoE layers)."""
    S = inputs.shape[1]
    x = W["embed"][inputs]
    cos, sin = yarn_tables(m, S, x.device)
    aux = x.new_zeros(())
    for i in range(m.n_layers):
        x = x + attention(W, i, rms_norm(x, W[f"blocks.{i}.attn_norm"], m.eps),
                          cos, sin, m, prec)
        h = rms_norm(x, W[f"blocks.{i}.mlp_norm"], m.eps)
        if i < m.first_dense:
            b = f"blocks.{i}."
            out = _swiglu(h, W[b + "w_gate"], W[b + "w_up"], W[b + "w_down"], prec)
        else:
            out, layer_aux = moe(W, i, h, m, prec, forced)
            aux = aux + layer_aux
        x = x + out
    return rms_norm(x, W["final_norm"], m.eps), aux / max(m.n_layers - m.first_dense, 1)


def chunk_loss(W, tokens, m, prec, forced: ForcedRouting | None = None):
    """Mean next-token cross-entropy of ``tokens`` [R, S + 1] plus α × the
    balance loss of these sequences, averaged over the MoE layers."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h, aux = hidden(W, inputs, m, prec, forced)
    # One sequence's [S, vocab] float32 logits at a time, recomputed in
    # the backward.
    loss = sum(checkpoint(_nll_sum, h[r], W["unembed"], targets[r], prec,
                          use_reentrant=False) for r in range(len(h)))
    return loss / targets.numel() + m.aux_alpha * aux


class DeepseekFollower(Follower):
    """``decoder.Follower`` (the seeded flat weights, AdamW) with this
    model's loss and the configuration's learning rate. The balance loss
    is per sequence, so every chunk runs ``rows_per_pass`` sequences at a
    time."""

    def step(self, batch, grad_accum: int, rows_per_pass: int) -> float:
        self.grad.zero_()
        total = 0.0
        for a in range(grad_accum):
            chunk = batch[a::grad_accum]
            for r in range(0, len(chunk), rows_per_pass):
                part = chunk[r:r + rows_per_pass]
                loss = chunk_loss(self.W, part, self.m, self.prec, self.forced)
                weight = len(part) / len(chunk) / grad_accum
                (loss * weight).backward()
                total += float(loss.detach()) * weight
        return total

    @torch.no_grad()
    def update(self) -> None:
        """AdamW (decoupled weight decay) on the flat vector, as
        ``decoder.Follower.update`` at ``Sizes.lr``."""
        g, p, lr = self.grad, self.theta, self.m.lr
        if self.exp_avg is None:
            self.exp_avg, self.exp_avg_sq = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        p.mul_(1.0 - lr * WEIGHT_DECAY)
        self.exp_avg.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
        self.exp_avg_sq.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
        denom = (self.exp_avg_sq.sqrt() / math.sqrt(1.0 - BETA2 ** self.t)).add_(EPS)
        p.addcdiv_(self.exp_avg, denom, value=-lr / (1.0 - BETA1 ** self.t))


def follow(m, seed: int, batches, grad_accum: int, rows_per_pass: int,
           steps: int, device, prec: Precision | None = None,
           projections: bool = True, forced: ForcedRouting | None = None) -> dict:
    """The reference's first ``steps`` steps on ``batches[0..steps)``, as
    ``decoder.follow``: each step's loss, every leaf's gradient norm (and
    projections) at step 1, and every leaf's change after the last."""
    strict_f32()
    f = DeepseekFollower(m, seed, device, prec, forced)
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
