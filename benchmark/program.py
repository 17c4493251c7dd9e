"""The program side: the port's own train step, built from the cell's
files, fed from the seed, and read for the correctness check.

The step is ``tpumon.workload_torch.harness.make_train_step`` over the
port's model that the cell's family builds (``families/<family>.py``:
``port_model``) with ``build_optimizer``, flash attention, remat and the
cell's loss chunk, as ``harness.run`` wires them. The weights are the
benchmark's (``seeded.fill``), written into the model's own parameters.
"""

from __future__ import annotations

import torch

from benchmark import devtrace, families, seeded


class Program:
    """One cell's train step on ``device``, with the seeded weights and the
    pool of token batches. ``spans`` puts the benchmark's attention spans
    around the port's attention core (traced runs); ``fault`` plants one
    of :data:`FAULTS` under the step (the correctness tests and the
    calibration only)."""

    FAULTS = ("frozen", "half_batch")

    def __init__(self, cell, seed: int, device, spans: bool = False,
                 fault: str | None = None) -> None:
        from tpumon.workload_torch import harness
        from tpumon.workload_torch.parallel import pipeline

        # f32 products stay f32, as harness.run sets.
        torch.backends.cuda.matmul.allow_tf32 = False
        m = cell.model
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        family = families.of(m)
        self.model = family.port_model(m, cell.seq, self.device)
        self.params = dict(self.model.named_parameters())
        want = family.param_shapes(m)
        have = {n: tuple(p.shape) for n, p in self.params.items()}
        if have != want:
            raise ValueError(f"the port's parameters {have} are not the "
                             f"configuration's {want}")
        seeded.fill(m, seed, self.params)
        self.optimizer = harness.build_optimizer(self.model.named_parameters(),
                                                 self.model)
        attn_impl = pipeline.make_attn_impl(None, attn=cell.attn)
        if spans and attn_impl is not None:
            attn_impl = devtrace.spanned(attn_impl)
        self._step = harness.make_train_step(
            self.model, self.optimizer, attn_impl, grad_accum=cell.grad_accum,
            remat=cell.remat, loss_chunk=cell.loss_chunk)
        self.pool = seeded.tokens(seed, cell.pool, cell.batch, cell.seq, m.vocab,
                                  self.device)
        self.steps = 0
        if fault not in (None, *self.FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        if fault == "frozen":
            self.optimizer.step = lambda *args, **kwargs: None

    def step(self) -> torch.Tensor:
        """One optimizer step on the pool's next batch; the loss, on the
        device."""
        batch = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        if self.fault == "half_batch":
            batch = batch[:len(batch) // 2]
        loss, _ = self._step(batch)
        return loss

    def grad_norms(self) -> dict[str, float]:
        """Each weight's gradient norm at the last step as the optimizer
        got it: its first moment over (1 − β1), read after step 1."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        state = self.optimizer.state
        norms = {}
        for name, p in self.params.items():
            avg = state.get(p, {}).get("exp_avg")
            norms[name] = (0.0 if avg is None
                           else float(torch.linalg.vector_norm(avg)) / (1.0 - beta1))
        return norms

    def grad_projections(self) -> dict[str, list]:
        """Each weight's gradient of the last step, as the optimizer got
        it, on the seeded directions (``seeded.projections``)."""
        return seeded.projections(self.cell.model, self.seed,
                                  {n: p.grad for n, p in self.params.items()})

    def change_norms(self) -> dict[str, float]:
        return seeded.change_norms(self.cell.model, self.seed,
                                   {n: p.detach() for n, p in self.params.items()})

    def close(self) -> None:
        """Drop the model, the optimizer state and the pool."""
        for name in ("_step", "optimizer", "model", "params", "pool"):
            setattr(self, name, None)
