"""Ablation timing of the per-scenario control step on one card,
counterpart of `benchmarks/ablate.py`.

The per-scenario step `get_control_rows` (what the JAX script times as
`jax.vmap(get_control)`: the exact-refactor `solve_mpc_qp`, the plain
condensing and allocation; no kernel) on B=2048 rows of healthy and the
(10, 11) double fault alternating, the hover references at Nt=15 and the
states of `ablate.py:46-50` (positions from `default_rng(0)`, identity
attitude, at rest), in four variants (`:68-79`) and "sqp only", the
per-scenario SQP without the allocation (`sqp_solve_rows`, `:98-115`).
The JAX labels are kept beside the configuration each row actually runs:
its "full (3 sqp, admm 25x2)" runs `MPCConfig()` at Nt=15, whose ADMM is
30x1 at rho 50.  Every variant starts from one `init_warmstart`.

Timing keeps `timed_chain`'s semantics (`:53-62`): one untimed call, then 8
calls chained on the warm start with the states x0 + 1e-4 (i + 1); but the
variants run in turns (`profile_step.in_turns`: call i of every variant in
round i, the order reversed every other round), so that the host's drift
within a run falls on all of them alike.  A call is timed by the host
clock to a device synchronize.  Per row: the median and the mean ms a
batch step over the 8 calls, solves/s = B / median, and the kernels'
launches (none).  Every tensor of every call's output must be finite, else
the run raises.

    python -m ft_mpc_torch.benchmarks.ablate [--device cuda|cpu] [--out FILE]

Prints one line a row and the record as one JSON line, last.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np
import torch

from ft_mpc_torch.benchmarks import common, profile_step

BATCH = 2048
HORIZON = 15
REPS = 8
PERTURB = 1e-4
PATTERNS = ((), (10, 11))
SQP_ONLY = "sqp only (no alloc)"
FULL = "full (3 sqp, admm 25x2)"


def variants() -> dict:
    """ablate.py:68-79: JAX label -> MPCConfig."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    return {
        FULL: MPCConfig(horizon=HORIZON, sqp_iters=3),
        "sqp=1": MPCConfig(horizon=HORIZON, sqp_iters=1),
        "admm 1x1": MPCConfig(horizon=HORIZON, sqp_iters=3,
                              admm=StructuredADMMConfig(iters=1, phases=1, rho=1.0)),
        "no line search": MPCConfig(horizon=HORIZON, sqp_iters=3, ls_alphas=(1.0,)),
    }


def setup(B: int, device, dtype=torch.float32):
    """ablate.py:31-51: the bank, plant, weights, references and states,
    float leaves of `dtype`."""
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiraling import MPCWeights
    from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center
    from ft_mpc_torch.utils.faults import BrokenThruster

    patterns = [[BrokenThruster(i, 1.0) for i in p] for p in PATTERNS]
    s = SimpleNamespace(bank=common.tiled_bank(common.build_scenarios(patterns), B, device,
                                               dtype))
    s.params = BodyParams.default(common.DT, dtype=dtype, device=device)
    s.weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                          dtype=dtype, device=device)
    s.x_ref, s.u_ref = common.hover_refs(HORIZON, 5.0, device, dtype)
    s.x0 = torch.as_tensor(common.long_horizon_x0(B), dtype=dtype, device=device)
    s.c0 = robot_to_center(s.bank.r, s.x0)
    return s


class Chain:
    """`timed_chain`'s calls one at a time: the first untimed on (x0, the
    initial warm start), then the i-th on x0 + 1e-4 (i + 1) and the
    previous call's warm start.  `step(x, warm)` returns (output, its warm
    start)."""

    def __init__(self, step, x0, warm):
        self.step, self.x0, self.warm0 = step, x0, warm
        self.warm, self.i = warm, -1
        self.watch = common.FiniteWatch()

    def __call__(self):
        if self.i < 0:
            out, _ = self.step(self.x0, self.warm0)
        else:
            out, self.warm = self.step(self.x0 + PERTURB * (self.i + 1), self.warm)
        self.watch.see(out)
        self.i += 1


def main(B: int = BATCH, reps: int = REPS, names=None, device=None, out=None) -> dict:
    """The variants (all, or those of `names`) in turns; returns the record
    (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.controllers.spiraling import (
        get_control_rows,
        init_warmstart,
        sqp_solve_rows,
    )

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    s = setup(B, dev)
    cfgs = variants()
    warm = init_warmstart(s.params, s.bank, cfgs[FULL], s.c0)
    chains = {}
    for name, cfg in cfgs.items():
        def step(x, w, cfg=cfg):
            o = get_control_rows(s.params, s.bank, s.weights, cfg, x, s.x_ref, s.u_ref, w)
            return o, o.warm
        chains[name] = Chain(step, s.x0, warm)
    cfgs[SQP_ONLY] = cfgs[FULL]

    def sqp_step(c, w):
        w, info = sqp_solve_rows(s.params, s.bank, s.weights, cfgs[FULL], c, s.x_ref,
                                 s.u_ref, w)
        return (w, info), w
    chains[SQP_ONLY] = Chain(sqp_step, s.c0, warm)
    if names is not None:
        chains = {k: v for k, v in chains.items() if k in names}

    common.zero_counters()
    timed = profile_step.in_turns(chains, reps, dev)
    launches = common.read_counters()
    rows = []
    for name, chain in chains.items():
        chain.watch.require(f"ablate {name}")
        t = timed[name]
        ms = np.asarray(t["host_ms_rounds"])
        rows.append({"label": name, "ms_per_batch_step": t["host_ms"],
                     "ms_per_batch_step_mean": float(ms.mean()),
                     "ms_rounds": ms.tolist(), "ms_se": t["host_ms_se"],
                     "solves_per_s": None if name == SQP_ONLY else B * 1e3 / t["host_ms"],
                     "allocation": name != SQP_ONLY,
                     "config": common.config_record(cfgs[name])})
        print(f"{name:28s}: {t['host_ms']:9.3f} ms/batch-step"
              + ("" if name == SQP_ONLY else f"  ({B * 1e3 / t['host_ms']:9.1f} solves/s)"),
              flush=True)
    record = {"batch": B, "reps": reps, "horizon": HORIZON, "rows": rows,
              "launches": launches, **ident}
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    print(json.dumps(main(device=a.device, out=a.out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
