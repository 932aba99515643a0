"""The benchmark of the PyTorch and CUDA treewidth solver (``repro_torch``).

``python3 twbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``harness.py``.
"""
