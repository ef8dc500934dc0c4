"""The benchmark of tpuvdb_torch on one or four NVIDIA H100 cards.

`python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line last on stdout. See perfbench/harness.py for a run's order and
perfbench/registry.py for how configurations, traffic mixes, metrics,
roofline counts and references are found by name.
"""
