"""Plain float32 reference of the decoder configurations (dense Llama /
Mistral and the Mixtral mixture of experts), and its training step.

It follows the published layer equations as the port runs them: token
embedding; per layer RMSNorm, q/k/v projections, rotary embeddings
(split halves, θ as run), causal grouped-query attention with scale
1/√head_dim, output projection and residual, RMSNorm, then SwiGLU — or,
for the MoE, a float32 softmax router, top-k with gates renormalised
over the k, each expert's SwiGLU on the tokens routed to it and the
gated sum; final RMSNorm, unembed, mean next-token cross-entropy (plus
the weighted load-balancing loss for the MoE); the gradients by autograd
and the AdamW update on one flat float32 vector.

Departure noted for the MoE, as the port runs it: a static capacity of
⌈k·S·factor / E⌉ token slots an expert a sequence, filled first by every
token's first choice in sequence order, then by the second choices;
a choice past the capacity is dropped (its gate stays in the
renormalising sum). The load-balancing loss is GShard's,
E · Σ_e kept_fraction(e) / k · mean_probability(e), over each
accumulation chunk's tokens and the mean over layers.

Every product goes through ``Precision.mm``: float32 with TF32 off, or,
for the control, both operands (and the backward's gradient) rounded to
float8 e4m3 with a per-tensor scale.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import seeded

#: The port's optimizer: optax.adamw(1e-3)'s defaults.
LR, BETA1, BETA2, EPS, WEIGHT_DECAY = 1e-3, 0.9, 0.999, 1e-8, 1e-4

#: float8 e4m3's largest finite value.
E4M3_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with a, b and, in the backward, the incoming gradient rounded
    to float8 e4m3 (per-tensor scale); products accumulate in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.b_dims = b.dim()
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        if gb.dim() > ctx.b_dims:
            gb = gb.reshape(-1, *gb.shape[-2:]).sum(0)
        return ga, gb


class Precision:
    """The reference's products: float32, or float8 e4m3 (the control)."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def mm(self, a, b):
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, cos, sin):
    """x [R, S, H, D]: rotate the two halves of each head."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rope_tables(m, seq: int, device):
    half = torch.arange(0, m.head_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (m.rope_theta ** (half / m.head_dim))
    ang = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
    return torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]


def _attention_row(q, k, v, prec):
    """Causal attention of one sequence: q [S, H, D], k/v [S, KV, D]; q
    head h reads kv head h // (H / KV)."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).permute(1, 2, 0)  # [H, D, S]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)  # [H, S, D]
    s = prec.mm(q.transpose(0, 1), k) * (1.0 / math.sqrt(D))  # [H, S, S]
    above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
    return prec.mm(p, v).transpose(0, 1)  # [S, H, D]


def attention(W, i, x, cos, sin, m, prec):
    R, S, _ = x.shape
    HD = m.head_dim
    q = prec.mm(x, W[f"blocks.{i}.wq"]).reshape(R, S, m.n_heads, HD)
    k = prec.mm(x, W[f"blocks.{i}.wk"]).reshape(R, S, m.n_kv_heads, HD)
    v = prec.mm(x, W[f"blocks.{i}.wv"]).reshape(R, S, m.n_kv_heads, HD)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    # One sequence at a time, recomputed in the backward: the [H, S, S]
    # scores of a whole chunk would not fit beside the optimizer state.
    rows = [checkpoint(_attention_row, q[r], k[r], v[r], prec,
                       use_reentrant=False) for r in range(R)]
    out = torch.stack(rows).reshape(R, S, m.n_heads * HD)
    return prec.mm(out, W[f"blocks.{i}.wo"])


def swiglu(x, w_gate, w_up, w_down, prec):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def route(probs, m, seq: int, experts=None):
    """probs [R, S, E] → (experts [R, S, k], gates [R, S, k], kept [R, S, k]):
    the top-k experts (or the ``experts`` given, first choice first),
    their probabilities over the k's sum, and whether the choice found a
    slot under the capacity."""
    if experts is None:
        top, experts = probs.topk(m.top_k, dim=-1)
    else:
        top = probs.gather(-1, experts)
    gates = top / (top.sum(-1, keepdim=True) + 1e-9)
    capacity = m.capacity(seq)
    fill = torch.zeros(probs.shape[0], 1, m.n_experts, dtype=torch.long,
                       device=probs.device)
    kept = []
    for j in range(m.top_k):
        chosen = F.one_hot(experts[..., j], m.n_experts)  # [R, S, E]
        before = torch.cumsum(chosen, dim=1) - chosen + fill
        kept.append((before * chosen).sum(-1) < capacity)
        fill = fill + chosen.sum(dim=1, keepdim=True)
    return experts, gates, torch.stack(kept, dim=-1)


class ForcedRouting:
    """A witness, not a check: each MoE layer takes, in call order, the
    expert choices given for it (``choices[layer]``: one [R, S, k] tensor
    an accumulation chunk of each step followed) in place of its own
    top-k; the gates stay the reference's own probabilities, renormalised
    over the forced k, and the capacity is worked out again. Counts, by
    layer, the tokens whose own top-k set differs (``flips``) out of
    ``tokens``."""

    def __init__(self, choices: dict[int, list]) -> None:
        self.queue = {i: list(c) for i, c in choices.items()}
        self.flips = dict.fromkeys(choices, 0)
        self.tokens = dict.fromkeys(choices, 0)

    def experts(self, layer: int, probs):
        forced = self.queue[layer].pop(0).to(probs.device)
        own = probs.topk(forced.shape[-1], dim=-1).indices.sort(-1).values
        differ = (own != forced.sort(-1).values).any(-1)
        self.flips[layer] += int(differ.sum())
        self.tokens[layer] += differ.numel()
        return forced


def moe_mlp(W, i, x, m, prec, forced: ForcedRouting | None = None):
    """x [R, S, D] → (out, the layer's load-balancing loss)."""
    R, S, D = x.shape
    probs = torch.softmax(prec.mm(x, W[f"blocks.{i}.router"]), dim=-1)
    chosen = None if forced is None else forced.experts(i, probs)
    experts, gates, kept = route(probs, m, S, chosen)
    flat = x.reshape(R * S, D)
    experts, gates = experts.reshape(R * S, -1), gates.reshape(R * S, -1)
    kept = kept.reshape(R * S, -1)
    out = torch.zeros_like(flat)
    counts = []
    for e in range(m.n_experts):
        tok, slot = ((experts == e) & kept).nonzero(as_tuple=True)
        counts.append(tok.numel())
        if tok.numel() == 0:
            continue
        # Recomputed in the backward: every expert's [tokens, ffn] float32
        # activations at once would not fit beside the optimizer state.
        y = checkpoint(swiglu, flat[tok], W[f"blocks.{i}.w_gate"][e],
                       W[f"blocks.{i}.w_up"][e], W[f"blocks.{i}.w_down"][e], prec,
                       use_reentrant=False)
        out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    frac = torch.tensor(counts, dtype=torch.float32, device=x.device) / (R * S)
    aux = m.n_experts * (frac / m.top_k * probs.mean(dim=(0, 1))).sum()
    return out.reshape(R, S, D), aux


def _nll_sum(h, unembed, targets, prec):
    return F.cross_entropy(prec.mm(h, unembed), targets, reduction="sum")


def chunk_loss(W, tokens, m, prec, forced: ForcedRouting | None = None):
    """Mean next-token cross-entropy of ``tokens`` [R, S + 1] (plus, for
    the MoE, aux_coef × the mean over layers of the load-balancing loss
    over these rows)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    S = inputs.shape[1]
    x = W["embed"][inputs]
    cos, sin = rope_tables(m, S, x.device)
    aux = x.new_zeros(())
    for i in range(m.n_layers):
        x = x + attention(W, i, rms_norm(x, W[f"blocks.{i}.attn_norm"], m.eps),
                          cos, sin, m, prec)
        h = rms_norm(x, W[f"blocks.{i}.mlp_norm"], m.eps)
        if m.moe:
            out, layer_aux = moe_mlp(W, i, h, m, prec, forced)
            aux = aux + layer_aux
        else:
            out = swiglu(h, W[f"blocks.{i}.w_gate"], W[f"blocks.{i}.w_up"],
                         W[f"blocks.{i}.w_down"], prec)
        x = x + out
    h = rms_norm(x, W["final_norm"], m.eps)
    # One sequence's [S, vocab] float32 logits at a time, recomputed in
    # the backward.
    loss = sum(checkpoint(_nll_sum, h[r], W["unembed"], targets[r], prec,
                          use_reentrant=False) for r in range(len(h)))
    loss = loss / targets.numel()
    if m.moe:
        loss = loss + m.aux_coef * aux / m.n_layers
    return loss


class Follower:
    """The reference's training state: the seeded weights as one flat
    float32 vector, its gradient as another, and the AdamW moments. Each
    weight (each expert of a bank) is a leaf that aliases its slice of
    the flat vector, with its ``.grad`` aliasing the flat gradient, so
    the backward accumulates in place and the update is one pass."""

    def __init__(self, m, seed: int, device, prec: Precision | None = None,
                 forced: ForcedRouting | None = None) -> None:
        self.m, self.seed = m, seed
        self.prec = prec or Precision()
        self.forced = forced
        n = seeded.total(m)
        self.theta = torch.empty(n, dtype=torch.float32, device=device)
        self.grad = torch.zeros(n, dtype=torch.float32, device=device)
        with torch.no_grad():
            for index, start, length in seeded.chunks(m):
                seeded.draw_chunk(seed, index, length,
                                  out=self.theta[start:start + length])
            for name, p in self.views(self.theta).items():
                if seeded.is_norm(name):
                    p.fill_(1.0)
        self.W = {}
        for name, shape, o in seeded.layout(m):
            if len(shape) == 3:  # an expert bank: a leaf an expert
                per = math.prod(shape[1:])
                self.W[name] = [self._leaf(o + e * per, shape[1:])
                                for e in range(shape[0])]
            else:
                self.W[name] = self._leaf(o, shape)
        self.exp_avg = self.exp_avg_sq = None
        self.t = 0

    def _leaf(self, offset, shape):
        n = math.prod(shape)
        p = self.theta[offset:offset + n].view(shape).detach().requires_grad_()
        p.grad = self.grad[offset:offset + n].view(shape)
        return p

    def views(self, flat) -> dict[str, torch.Tensor]:
        """Each weight's slice of ``flat`` (the weights or the gradient)."""
        return {name: flat[o:o + math.prod(shape)].view(shape)
                for name, shape, o in seeded.layout(self.m)}

    def step(self, batch, grad_accum: int, rows_per_pass: int) -> float:
        """Loss and gradients of one optimizer step on ``batch``
        [B, S + 1]: averaged over ``grad_accum`` strided chunks (chunk a
        holds rows a, a + A, …), each chunk's loss over its own rows,
        computed ``rows_per_pass`` rows at a time for the dense model (the
        MoE's load-balancing loss needs the whole chunk). Returns the
        step's loss; :meth:`update` applies the gradient."""
        self.grad.zero_()
        total = 0.0
        for a in range(grad_accum):
            chunk = batch[a::grad_accum]
            rows = len(chunk) if self.m.moe else rows_per_pass
            for r in range(0, len(chunk), rows):
                part = chunk[r:r + rows]
                loss = chunk_loss(self.W, part, self.m, self.prec, self.forced)
                weight = len(part) / len(chunk) / grad_accum
                (loss * weight).backward()
                total += float(loss.detach()) * weight
        return total

    def leaf_norms(self, flat) -> dict[str, float]:
        return {name: float(torch.linalg.vector_norm(v))
                for name, v in self.views(flat).items()}

    @torch.no_grad()
    def update(self) -> None:
        """AdamW (decoupled weight decay) on the flat vector."""
        g, p = self.grad, self.theta
        if self.exp_avg is None:
            self.exp_avg, self.exp_avg_sq = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        p.mul_(1.0 - LR * WEIGHT_DECAY)
        self.exp_avg.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
        self.exp_avg_sq.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
        denom = (self.exp_avg_sq.sqrt() / math.sqrt(1.0 - BETA2 ** self.t)).add_(EPS)
        p.addcdiv_(self.exp_avg, denom, value=-LR / (1.0 - BETA1 ** self.t))

    def change_norms(self) -> dict[str, float]:
        return seeded.change_norms(self.m, self.seed, self.views(self.theta))


def follow(m, seed: int, batches, grad_accum: int, rows_per_pass: int,
           steps: int, device, prec: Precision | None = None,
           projections: bool = True, forced: ForcedRouting | None = None) -> dict:
    """The reference's first ``steps`` steps on ``batches[0..steps)``: each
    step's loss, every leaf's gradient norm (and, with ``projections``,
    its projections) at step 1, and every leaf's change after the last
    step."""
    strict_f32()
    f = Follower(m, seed, device, prec, forced)
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
