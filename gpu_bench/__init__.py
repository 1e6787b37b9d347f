"""Benchmark of crackling_tpu_torch, the PyTorch and CUDA port.

``python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. A cell is ``<configuration>.<traffic>``; the harness finds
``configs/<configuration>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` by name, so a new configuration, traffic mix or
per-layer metric is a new file and a new entry. Only ``system.py``
imports the port; ``reference/`` is the plain reference that decides
``correct``.
"""
