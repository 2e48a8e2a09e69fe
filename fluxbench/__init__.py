"""The benchmark of the PyTorch and CUDA port (``viennaray_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; the cell's
configuration and its set-up, traffic mix and its steps, limits and metrics
are files of their own here (``spec.py`` finds them by name).
``reference/`` is the plain tracer that decides ``correct``; it imports
nothing of the program.
"""
