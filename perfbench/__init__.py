"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON line.  Everything that belongs to one
configuration, traffic mix, operation or metric sits in a file of its own,
found by the name the manifest gives it (``registry.py``); README.md says
how to add one.

Nothing here imports ``jax`` or the JAX package ``repro``; the plain
references under ``reference/`` import nothing of ``repro_torch`` either.
"""
