"""The benchmark of ``dlwp_torch`` on one NVIDIA H100.

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line; see ``h100bench/README.md``. Nothing here imports JAX or the
JAX package; the plain reference (``h100bench/reference``) imports nothing
of ``dlwp_torch`` either.
"""
