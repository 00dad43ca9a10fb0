"""The benchmark of spla_tpu_torch: GAP graphs under BFS, SSSP and PageRank queries.

``python graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; ``README.md`` says how the files fit together.
"""
