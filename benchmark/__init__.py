"""The port's benchmark: data-driven cells of train steps on the H100.

``run.py`` is the command; ``BENCHMARK.json`` at the repository root
names the cells. Everything that decides a number lives here and is
frozen for later changes: the traffic generator (``seeded.py``), each
model family's sizes, weight layout and model-FLOPs count
(``families/``), the attention work and byte counts and the peaks
(``roofline.py``), the kernel classes (``kernel_classes.py``), the
reduction of a device trace and the port's span table (``devtrace.py``,
``progspans.py``), the plain float32 references (``reference/``) and
the comparison that decides ``correct`` (``compare.py``). A new model
comes in as new files: its family module, configuration, reference,
traffic, cell and metric readers.
"""
