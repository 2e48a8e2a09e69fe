"""The port's benchmark programs, counterparts of the JAX package's
``bench.py`` (``flagship``), ``benchmarks/perf_sweep.py`` (``perf_sweep``)
and ``benchmarks/grad_bench.py`` (``grad_bench``). Each runs on the CUDA
device unless ``--device cpu`` is given and prints JSON lines to stdout (or
appends them to ``--out``): ``python3 -m viennaray_tpu_torch.bench.<name>``."""
