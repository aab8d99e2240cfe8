"""The batched control step at long horizons on three QP backends,
counterpart of `benchmarks/long_horizon.py`.

`get_control_batch` (SQP + QP + allocation, warm-started steady state) at Nt
in {15, 60, 240}:
  * condensed        -- the ADMM kernel and the worst-K cleanup (the Nt=15
                        deployed backend; its metric is (Nt*nu)^2 dense, so
                        it is skipped where Nt*nu exceeds --condensed-max-n);
  * stagewise        -- Riccati-in-ADMM, the per-scenario sequential
                        factored re-solve (mode 'scan') + worst-K cleanup;
  * stagewise-lanes  -- the same solver with the batched re-solve (mode
                        'lanes'): every ADMM x-update is one launch of
                        `riccati_split_f32` for the whole bank (both sweeps),
                        on a per-phase `riccati_prepare_f32`.

All backends run elastic terminal rows and the cleanup (K = B/8, 2 phases).
The bank is the JAX script's: healthy and the (10, 11) double fault
alternated, built by the port from the terminal cache with DEFAULT_TUNING
for the float32 plant; the states are `long_horizon.py:97-100`'s seed-0
positions at rest.  Each point runs one warm-up window of `reps` chained
steps, then one timed window of `reps` (host clock to a device synchronize).

    python -m ft_mpc_torch.benchmarks.long_horizon [--batch 512]
        [--horizons 15 60 240] [--reps 3] [--device cuda|cpu] [--out FILE]

Prints one line a point and the record as one JSON line, last.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

from ft_mpc_torch.benchmarks import common

BACKENDS = ("condensed", "stagewise", "stagewise-lanes")
DEFAULTS = dict(batch=512, horizons=(15, 60, 240), reps=3, sqp_iters=2, iters=60,
                cleanup=300, condensed_max_n=120)


def run(horizon: int, backend: str, B: int, args, device) -> dict:
    """One (Nt, backend, B) point: `args` carries sqp_iters, iters, cleanup
    and reps, as the JAX script's `run` takes them.  Returns solves/s, ms a
    step, max_r_prim, max_term_gap of the timed window, and the kernels'
    launches a step over both windows; raises on non-finite outputs."""
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiraling import (
        MPCConfig,
        MPCWeights,
        get_control_batch,
        init_warmstart_batch,
    )
    from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig
    from ft_mpc_torch.utils.faults import BrokenThruster

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    f32 = torch.float32
    scs = common.build_scenarios([[], [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)]])
    bank = common.tiled_bank(scs, B, dev)
    params = BodyParams.default(common.DT, dtype=f32, device=dev)
    weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], dtype=f32,
                                        device=dev)
    cfg = MPCConfig(
        horizon=horizon,
        sqp_iters=args.sqp_iters,
        qp_backend="condensed" if backend == "condensed" else "stagewise",
        admm=StructuredADMMConfig(iters=args.iters, phases=1, rho=50.0, adapt_clip=1.5),
        stagewise=StagewiseConfig(iters=args.iters, phases=1, rho=50.0, adapt_clip=1.5,
                                  mode="lanes" if backend == "stagewise-lanes" else "scan"),
        newton_iters=3,
        cleanup_iters=args.cleanup,
        cleanup_k=max(1, B // 8),
        cleanup_phases=2,
    )
    x_ref, u_ref = common.hover_refs(horizon, max(30, (horizon + 2) * common.DT), dev)
    x0 = torch.as_tensor(common.long_horizon_x0(B), device=dev)
    warm = init_warmstart_batch(params, bank, weights, cfg, robot_to_center(bank.r, x0),
                                x_ref, u_ref)

    def window(w):
        out = None
        for _ in range(args.reps):
            out = get_control_batch(params, bank, weights, cfg, x0, x_ref, u_ref, w)
            w = out.warm
        return out

    common.zero_counters()
    out = window(warm)
    common.sync(dev)
    t0 = time.perf_counter()
    out = window(out.warm)
    common.sync(dev)
    elapsed = time.perf_counter() - t0
    counted = common.read_launches(2 * args.reps)
    if not bool(torch.isfinite(out.u_phys).all()):
        raise RuntimeError(f"Nt={horizon} {backend} B={B}: non-finite thruster commands")
    return {
        "solves_per_s": B * args.reps / elapsed,
        "max_r_prim": float(out.info.r_prim.max()),
        "max_term_gap": float(out.info.term_gap.max()),
        "ms_per_step": 1e3 * elapsed / args.reps,
        "counted_steps": 2 * args.reps,
        "launches_per_step": counted["launches_per_step"],
        "riccati_launches_by_design": counted["riccati_launches_by_design"],
        "admm_launches_by_design": counted["admm_launches_by_design"],
        "newton_rescues": counted["newton_rescues"],
    }


def backends_at(nt: int, condensed_max_n: int) -> list[str]:
    """long_horizon.py:141-145: the condensed backend only where Nt*nu <=
    condensed_max_n."""
    return list(BACKENDS if nt * 6 <= condensed_max_n else BACKENDS[1:])


def main(batch: int = DEFAULTS["batch"], horizons=DEFAULTS["horizons"],
         reps: int = DEFAULTS["reps"], sqp_iters: int = DEFAULTS["sqp_iters"],
         iters: int = DEFAULTS["iters"], cleanup: int = DEFAULTS["cleanup"],
         condensed_max_n: int = DEFAULTS["condensed_max_n"], device=None, out=None) -> dict:
    """Every backend at every horizon (the skip rule above); returns the
    record (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    args = SimpleNamespace(sqp_iters=sqp_iters, iters=iters, cleanup=cleanup, reps=reps)
    results = {}
    for nt in horizons:
        row = {}
        backends = backends_at(nt, condensed_max_n)
        if "condensed" not in backends:
            row["condensed"] = "skipped: (Nt*nu)^2 metric impractical"
        for backend in backends:
            r = run(nt, backend, batch, args, dev)
            row[backend] = r
            print(f"Nt={nt:4d} {backend:16s}: {r['solves_per_s']:10.1f} solves/s, "
                  f"{r['ms_per_step']:.1f} ms a step (max_r_prim {r['max_r_prim']:.2e}, "
                  f"term_gap {r['max_term_gap']:.2e})", flush=True)
        results[str(nt)] = row
    record = {"long_horizon": results, "batch": batch,
              "budgets": {**vars(args), "cleanup_k": max(1, batch // 8)},
              **common.card_identity(dev)}
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=DEFAULTS["batch"])
    ap.add_argument("--horizons", type=int, nargs="+", default=list(DEFAULTS["horizons"]))
    ap.add_argument("--reps", type=int, default=DEFAULTS["reps"])
    ap.add_argument("--sqp-iters", type=int, default=DEFAULTS["sqp_iters"])
    ap.add_argument("--iters", type=int, default=DEFAULTS["iters"])
    ap.add_argument("--cleanup", type=int, default=DEFAULTS["cleanup"])
    ap.add_argument("--condensed-max-n", type=int, default=DEFAULTS["condensed_max_n"],
                    help="skip the condensed backend when Nt*nu exceeds this")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    record = main(a.batch, a.horizons, a.reps, a.sqp_iters, a.iters, a.cleanup,
                  a.condensed_max_n, a.device, a.out)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
