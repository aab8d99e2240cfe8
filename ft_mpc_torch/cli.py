"""Console entry points of the port, counterpart of `ft_mpc_tpu/cli.py`.

    ft-mpc-torch-sim       closed-loop demo (reactive.yaml-compatible config)
    ft-mpc-torch-bench     one-card batched solves/s benchmark
    ft-mpc-torch-terminal  offline terminal-ingredient pipeline (writes npz)
"""

from __future__ import annotations

import sys


def sim_main() -> None:
    from ft_mpc_torch.examples.sim import main

    main()


def bench_main() -> None:
    from ft_mpc_torch.benchmarks.bench import cli

    sys.exit(cli(sys.argv[1:]))


def terminal_main() -> None:
    from ft_mpc_torch.terminal.pipeline import main

    main()
