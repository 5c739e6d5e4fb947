"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a model configuration under a traffic mix)
once on the machine it is started on:

    python3 perfbench/run.py --workload hymba_1_5b.serve_b96_p2048 \\
        --seed 7 --seconds 51 --trace 0

``BENCHMARK.json`` at the repository root lists the cells and metrics.
Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (its ``kind``
names the module under ``kinds/`` that drives it),
``metrics/<metric>.py`` and ``limits/<cell>.json`` (the limits of the
numbers the cell compares with the reference, and the readings they
were set from). ``control.py`` reads those numbers over many seeds, for
the program and for a float8 control. The yardstick lives here too: the
seeded weights and inputs (``harness/weights.py``), the frozen operation and
byte counts and the chip's peaks (``harness/counts.py``), the reading of
the profiler's trace (``harness/trace.py``), and the plain float32
reference (``reference/``) that decides ``correct``.
"""
