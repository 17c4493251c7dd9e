"""Plain float32 references of the benchmark's configurations.

Each configuration file names its reference module here (``reference``).
A reference imports nothing of ``tpumon``, neither ``jax`` nor the JAX
package, and takes nothing the program made: it draws the weights and
the tokens from the seed itself (``benchmark.seeded``).
"""
