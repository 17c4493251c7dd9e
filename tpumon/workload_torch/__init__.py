"""Workload harness, ported to PyTorch and CUDA for an NVIDIA H100.

The counterpart of :mod:`tpumon.workload`, which stays the reference: a
compact Llama-style training step that generates real accelerator work
for the monitor to observe, publishing the same ``tpu_step_*`` and
``tpu_serve_*`` families on its metrics page. The attention core runs on
three hand-written Hopper kernels (``ops/csrc/``). This package imports
``torch`` and never ``jax`` or anything under ``tpumon.workload``.
"""
