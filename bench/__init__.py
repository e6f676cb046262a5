"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of the root ``BENCHMARK.json`` once; see
``bench/README.md``.  Nothing here imports JAX or the JAX package, and
``bench/reference`` imports nothing of the port.
"""
