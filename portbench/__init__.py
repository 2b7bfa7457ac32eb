"""The benchmark of ``commpy_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Cells,
configurations and per-layer metric readers are data and small files
found by name (``workloads/``, ``configs/``, ``metrics/``); the plain
reference that decides ``correct`` is under ``reference/``.
"""
