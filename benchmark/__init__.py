"""The benchmark of pyrenderer_tpu_torch: BENCHMARK.json's cells, driven
as data (benchmark/harness.py), with their plain reference
(benchmark/reference/) and the comparison that decides `correct`
(benchmark/compare.py). Run one cell with

    python3 benchmark/run.py --workload cornell.render --seed 1 --seconds 10 --trace 0
"""
