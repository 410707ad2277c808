"""The benchmark of the PyTorch and CUDA port.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration in
``configs/``, its traffic in ``workloads/``, its output limits in
``limits/`` and each per-layer metric's reader in ``metrics/`` (see
``README.md``). Nothing here imports JAX or the JAX package; the port is
imported only by the traffic generators in ``generators/``.
"""
