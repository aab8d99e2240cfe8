"""The randomized (fault x initial state x inertia) bank on the card, the
measuring half of `benchmarks/randomized.py`.

`build_randomized_bank(params0, n, seed=0)` draws for every row a fault
pattern (healthy, all singles, all doubles), a plant (mass +-15%, per-axis
inertia +-20%) and a tumbling initial state; the dynamics, spiral
parameters, compensation wrenches and terminal ingredients use each row's
own plant.  The deployed configuration of `randomized.py:65-81` (2 SQP
iterations, ADMM 60x1 at rho 50 and clip 1.5, 3 Newton steps, cleanup
600x3 on K = max(256, n/8) rows, `FT_MPC_RAND_ROUNDS` worst-K rounds,
default 1) then runs one warm-up window of 10 chained steps and 8 timed
windows of 10 (bench.py's statistic, `common.chained_windows`).
n is `FT_MPC_RAND_N`, default 10240.

    python -m ft_mpc_torch.benchmarks.randomized [--device cuda|cpu]
        [--out FILE]

Prints the record as one JSON line, last; --out writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ft_mpc_torch.benchmarks import common

N_SCENARIOS = 10240
HORIZON = 15
WINDOWS = 8
STEPS_PER_WINDOW = 10


def config(n: int):
    """randomized.py:68-80."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    return MPCConfig(
        horizon=HORIZON,
        sqp_iters=2,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
        newton_iters=3,
        cleanup_iters=600,
        cleanup_k=max(256, n // 8) if n >= 256 else n,  # bench-parity coverage
        cleanup_phases=3,
        cleanup_rounds=int(os.environ.get("FT_MPC_RAND_ROUNDS", 1)),
    )


def main(n: int | None = None, device=None, out=None) -> dict:
    """Build the bank, run the windows; returns the record (and writes it to
    `out`).  n defaults to FT_MPC_RAND_N, else 10240."""
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.controllers.spiraling import (
        MPCWeights,
        get_control_batch,
        init_warmstart_batch,
    )
    from ft_mpc_torch.geometry.scenario import build_randomized_bank
    from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center

    dev = resolve_device(device)
    windows, steps_per_window = WINDOWS, STEPS_PER_WINDOW
    if n is None:
        n = int(os.environ.get("FT_MPC_RAND_N", N_SCENARIOS))
    f32 = torch.float32
    ident = common.card_identity(dev)
    params0 = BodyParams.default(common.DT, dtype=f32, device="cpu")
    t0 = time.perf_counter()
    bank, params, x0 = build_randomized_bank(params0, n, seed=0, device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0
    bank = bank.scenarios
    weights = MPCWeights.from_diagonals([1, 1, 1, 1, 1, 1, 2, 2, 2],
                                        [0.1, 0.1, 0.1, 0.01, 0.01, 0.01],
                                        dtype=f32, device=dev)
    cfg = config(n)
    x_ref, u_ref = common.hover_refs(HORIZON, 5.0, dev, mass=float(params0.mass))
    x0 = x0.to(f32)
    warm = init_warmstart_batch(params, bank, weights, cfg, robot_to_center(bank.r, x0),
                                x_ref, u_ref)

    def step(w):
        return get_control_batch(params, bank, weights, cfg, x0, x_ref, u_ref, w)

    common.zero_counters()
    samples, out_step = common.chained_windows(step, warm, windows, steps_per_window, dev)
    counted = common.read_launches((common.WARMUP_WINDOWS + windows) * steps_per_window)
    if not bool(torch.isfinite(out_step.u_phys).all()):
        raise RuntimeError("randomized bank: non-finite thruster commands")
    p50 = float(np.percentile(samples, 50))
    rp = out_step.info.r_prim.double().cpu().numpy()
    gaps = out_step.info.term_gap.double().cpu().numpy()
    mass = params.mass.double().cpu().numpy()
    record = {
        "n_scenarios": n,
        "pool": "healthy + 16 singles + 120 doubles",
        "mass_range_kg": [float(mass.min()), float(mass.max())],
        "inertia_scale_range": [0.8, 1.2],
        "bank_build_s": build_s,
        "solves_per_s": n * 1e3 / p50,
        "per_step_latency_p50_ms": p50,
        "per_step_latency_p99_ms": float(np.percentile(samples, 99)),
        "latency_samples_ms": samples.tolist(),
        "latency_windows": windows,
        "steps_per_window": steps_per_window,
        "warmup_windows": common.WARMUP_WINDOWS,
        "cleanup_k": cfg.cleanup_k,
        "cleanup_rounds": cfg.cleanup_rounds,
        "max_r_prim": float(rp.max()),
        "p99_r_prim": float(np.percentile(rp, 99)),
        "median_r_prim": float(np.median(rp)),
        "max_term_gap": float(np.nanmax(gaps)),
        "n_restoration_gap": int((gaps > 1e-3).sum()),
        "newton_rescues": counted["newton_rescues"],
        "launches_per_step": counted["launches_per_step"],
        **ident,
    }
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
