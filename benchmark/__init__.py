"""The benchmark of ``mesh_to_sdf_tpu_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own under ``configs/``, ``traffic/`` and
``metrics/``, found by the name ``BENCHMARK.json`` gives it.
"""
