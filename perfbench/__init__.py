"""The benchmark of the PyTorch / CUDA port (`ft_mpc_torch`) on one H100.

`python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once; see `perfbench/README.md`.
"""
