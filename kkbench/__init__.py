"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run is ``python3 -m kkbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout. A cell is a file under
``workloads/``, its configuration a file under ``configs/``, its data a
generator under ``gen/``, the program's entry a module under ``entries/``,
and each per-layer metric a reader under ``metrics/``: the harness finds
every one of them by the name ``BENCHMARK.json`` gives. A cell on several
chips runs as a world of processes, one a chip (``world.py``).

Nothing here imports ``jax`` or the JAX package ``repro``; the plain
reference under ``reference/`` imports neither, nor ``repro_torch``.
"""
