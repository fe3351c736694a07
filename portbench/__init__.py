"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json``::

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it (``README.md``).  Nothing here imports JAX or
the JAX package ``repro``; ``reference/`` imports nothing of the port.
"""
