"""The benchmark of ``sm_hpss_mtl_tpu_torch`` on NVIDIA GPUs.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Cells, configurations, traffic mixes and per-layer metrics are
files found by name (``configs/``, ``mixes/``, ``kinds/``, ``metrics/``,
``limits/``, ``flops/``).  ``reference/`` is the plain PyTorch reference the
output check compares against; it imports nothing of the program.
"""
