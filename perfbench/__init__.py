"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
The cells, configurations, traffic, per-layer metrics and limits are
files found by the names in ``BENCHMARK.json``."""
