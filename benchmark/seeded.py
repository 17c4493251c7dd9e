"""Inputs from the seed: the weights and the token batches.

Both sides get them from here: the program at set-up, the reference
after the window, each drawing them anew from the same seed. Weights are
drawn on the device as normal(0, 0.02) float32 (the master weights' type)
in fixed chunks of ``CHUNK`` elements over one flat index space, one
call a chunk, each chunk with a generator of its own, so that any chunk
can be drawn again alone; norm weights are ones. Token ids are drawn
uniformly from the vocabulary, a pool of distinct batches in one call.
"""

from __future__ import annotations

import torch

from benchmark import families

#: Elements a weight chunk holds (1 GiB of float32).
CHUNK = 1 << 28

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def _derived(seed: int, role: int, index: int = 0) -> int:
    return (seed * _MIX + role * 1_000_003 + index) & _MASK


def _shapes(m) -> dict[str, tuple[int, ...]]:
    """Every weight of the model of run sizes ``m`` by name, in the flat
    index space's order, as its family gives them."""
    return families.of(m).param_shapes(m)


def is_norm(name: str) -> bool:
    return name.endswith("norm")


def layout(m) -> list[tuple[str, tuple[int, ...], int]]:
    """(name, shape, offset) of each weight in the flat index space."""
    out, offset = [], 0
    for name, shape in _shapes(m).items():
        out.append((name, shape, offset))
        offset += _numel(shape)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def total(m) -> int:
    return sum(_numel(s) for s in _shapes(m).values())


#: Random directions each weight's gradient is projected on.
PROJECTIONS = 64


def draw_chunk(seed: int, index: int, n: int, out: torch.Tensor | None = None,
               device=None, role: int = 1) -> torch.Tensor:
    """Chunk ``index`` of the flat weights (``role`` 1; other roles draw
    the projections' directions): ``n`` normal(0, 0.02) float32 values
    (into ``out``, a contiguous 1-D tensor, when given)."""
    device = out.device if out is not None else torch.device(device)
    g = torch.Generator(device=device).manual_seed(_derived(seed, role, index))
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=device)
    return out.normal_(0.0, 0.02, generator=g)


def chunks(m):
    """(index, start, length) of each chunk of the flat weights."""
    n = total(m)
    return [(i, s, min(CHUNK, n - s)) for i, s in enumerate(range(0, n, CHUNK))]


def overlaps(m, start: int, length: int):
    """(name, shape, lo, hi, flat_lo) of each weight that chunk
    [start, start + length) covers: its own elements lo:hi, the chunk's
    flat_lo:flat_lo + hi - lo."""
    for name, shape, offset in layout(m):
        n = _numel(shape)
        lo, hi = max(start, offset), min(start + length, offset + n)
        if lo < hi:
            yield name, shape, lo - offset, hi - offset, lo - start


@torch.no_grad()
def fill(m, seed: int, params: dict[str, torch.Tensor]) -> None:
    """Write the seeded weights into ``params`` (name → float32 tensor of
    the shape the family's ``param_shapes`` gives), one chunk at a time."""
    device = next(iter(params.values())).device
    for index, start, length in chunks(m):
        values = draw_chunk(seed, index, length, device=device)
        for name, _, lo, hi, flat in overlaps(m, start, length):
            params[name].view(-1)[lo:hi].copy_(values[flat:flat + hi - lo])
        del values
    for name, p in params.items():
        if is_norm(name):
            p.fill_(1.0)


@torch.no_grad()
def change_norms(m, seed: int, params: dict[str, torch.Tensor]) -> dict[str, float]:
    """‖w − w₀‖ of each weight against its seeded initial value, drawn
    again chunk by chunk (one chunk of memory), as host floats."""
    device = next(iter(params.values())).device
    sq = {name: torch.zeros((), dtype=torch.float64, device=device)
          for name in params}
    for index, start, length in chunks(m):
        values = draw_chunk(seed, index, length, device=device)
        for name, _, lo, hi, flat in overlaps(m, start, length):
            if is_norm(name):
                continue
            d = params[name].view(-1)[lo:hi] - values[flat:flat + hi - lo]
            sq[name] += torch.linalg.vector_norm(d).double().square()
        del values
    for name, p in params.items():
        if is_norm(name):
            sq[name] = (p.double() - 1.0).square().sum()
    return {name: float(v.sqrt()) for name, v in sq.items()}


@torch.no_grad()
def projections(m, seed: int, tensors: dict[str, torch.Tensor]) -> dict[str, list]:
    """Each weight's tensor (a gradient) projected on :data:`PROJECTIONS`
    random directions drawn from the seed, chunk by chunk, as host floats:
    a first-order trace of the whole tensor in a few numbers."""
    device = next(iter(tensors.values())).device
    acc = {name: torch.zeros(PROJECTIONS, dtype=torch.float64, device=device)
           for name in tensors}
    for index, start, length in chunks(m):
        for j in range(PROJECTIONS):
            r = draw_chunk(seed, index, length, device=device, role=3 + j)
            for name, _, lo, hi, flat in overlaps(m, start, length):
                part = tensors[name].reshape(-1)[lo:hi].float()
                acc[name][j] += torch.dot(part, r[flat:flat + hi - lo]).double()
            del r
    return {name: v.tolist() for name, v in acc.items()}


def tokens(seed: int, pool: int, batch: int, seq: int, vocab: int,
           device=None) -> torch.Tensor:
    """``pool`` distinct batches of token ids [pool, batch, seq + 1]
    (inputs and the shifted targets), uniform over the vocabulary."""
    g = torch.Generator(device=device).manual_seed(_derived(seed, 2))
    return torch.randint(0, vocab, (pool, batch, seq + 1), generator=g,
                         device=device)
