"""Named spans inside the port's train step and model.

Each span is a ``torch.profiler.record_function`` named ``workload.<name>``,
so it lands in the same kineto trace as the kernels it launches, on the
same clock (and, under ``torch.autograd.profiler.emit_nvtx``, as an NVTX
range). They exist only while a profiler records: otherwise :func:`span`
returns one shared null context and :func:`traced` calls straight
through, with no allocation, no autograd node and no kernel. There is no
switch besides the profiler.

:func:`traced` also gives a region's backward a span of its own,
``workload.<name>.bwd``: while a profiler records, the region's inputs
that need a gradient pass through one identity node (its backward closes
the span) and its outputs through another (its backward opens it). The
autograd engine runs a node's backward after those of every node created
after it that it waits for, so the span covers the region's backward on
the thread that runs it. The identity nodes save no tensors, so remat's
check of the saved tensors holds whether or not a profiler recorded the
first forward.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd.profiler import record_function

#: The prefix of every span of the port.
PREFIX = "workload."

#: What :func:`span` returns while no profiler records.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``with`` block named ``workload.<name>`` while a profiler records;
    the shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(PREFIX + name)


class _Open(torch.autograd.Function):
    """Identity on a region's outputs; its backward opens the region's
    backward span."""

    @staticmethod
    def forward(ctx, held, name, *tensors):
        ctx.set_materialize_grads(False)
        ctx.held, ctx.name = held, name
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.held:
            ctx.held.append(record_function(ctx.name))
            ctx.held[0].__enter__()
        return (None, None, *grads)


class _Close(torch.autograd.Function):
    """Identity on a region's inputs; its backward closes the region's
    backward span."""

    @staticmethod
    def forward(ctx, held, *tensors):
        ctx.set_materialize_grads(False)
        ctx.held = held
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.held:
            ctx.held.pop().__exit__(None, None, None)
        return (None, *grads)


def _grad_positions(values) -> list[int]:
    return [i for i, v in enumerate(values)
            if isinstance(v, torch.Tensor) and v.requires_grad]


def _through(fn, held, values, *extra):
    """``values`` with its tensors that need a gradient replaced by their
    images through ``fn`` (one node for all of them)."""
    at = _grad_positions(values)
    if not at:
        return values
    images = fn(held, *extra, *(values[i] for i in at))
    values = list(values)
    for i, image in zip(at, images):
        values[i] = image
    return values


def traced(name: str):
    """Decorator: the function runs in ``span(name)`` and, where its tensor
    arguments and results carry gradients, its backward in
    ``workload.<name>.bwd``. The backward half ends at the arguments'
    gradients, so a region none of whose tensor arguments needs a
    gradient (one that reads only a module's weights) has none: pass the
    weight in. Off the profiler it is the function itself but for one
    check."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            held: list = []
            with record_function(PREFIX + name):
                if not (torch.is_grad_enabled() and _grad_positions(args)):
                    return fn(*args, **kwargs)
                out = fn(*_through(_Close.apply, held, args), **kwargs)
                if isinstance(out, torch.Tensor):
                    return _through(_Open.apply, held, [out],
                                    f"{PREFIX}{name}.bwd")[0]
                if isinstance(out, tuple):
                    return tuple(_through(_Open.apply, held, out,
                                          f"{PREFIX}{name}.bwd"))
                return out

        return inner

    return wrap
