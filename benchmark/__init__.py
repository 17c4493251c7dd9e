"""The port's benchmark: data-driven cells of train steps on the H100.

``run.py`` is the command; ``BENCHMARK.json`` at the repository root
names the cells. Everything that decides a number lives here and is
frozen for later changes: the traffic generator (``seeded.py``), the
model-FLOPs count (``flops.py``), the attention work and byte counts
and the peaks (``roofline.py``), the kernel classes
(``kernel_classes.py``), the reduction of a device trace
(``devtrace.py``), the plain float32 reference (``reference/``) and
the comparison that decides ``correct`` (``compare.py``).
"""
