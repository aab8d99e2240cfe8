"""Where max_r_prim comes from, geometry by geometry, counterpart of
`benchmarks/diag_residual.py`.

The JAX script's nine runs (`diag_residual.py:118-129`) on the bench's bank
tiled to B=128 (`--batch`; the script reads FT_MPC_BENCH_BATCH), the seed-0
tumbling states and the hover references, each `init_warmstart`, then 10
chained steps from the same states, the warm start carried.  Its docstring
pairs a "lanes" run with a "condensed" one at the same budget to tell apart
(a) the float32 kernel floor, (b) the inexact Newton-refreshed K^-1 and (c)
a few hard scenarios; in the JAX package both names now reach the same
batched path.  Here the pair runs as that docstring means it:
  * "lanes"     -> `get_control_batch` (the condensing, ADMM and allocation
                   kernels, K^-1 refreshed by Newton steps);
  * "condensed" -> `get_control_rows` (the per-scenario `solve_mpc_qp`, an
                   exact inverse a phase, no kernel).
Neither passes `qp_backend="lanes"`, which the port refuses.

Per run: max, p50 and p95 of r_prim, the largest r_dual, and the five
geometries (bank rows modulo the 32 patterns) with the largest row maximum
(`:103-112`), each with its fault pattern; the ms a step (host clock to a
device synchronize over the steps) and the kernels' launches a step.

`--backend stagewise` runs the stagewise leg instead: `get_control_batch`
with `qp_backend="stagewise"`, mode 'lanes' (the Riccati re-solve kernel),
at chip_smoke's section-5 configuration: B=512, Nt=240, healthy and the
(10, 11) double fault alternating, `benchmarks/long_horizon.py:97-100`'s
states, ADMM 60x1 at rho 50 and clip 1.5, cleanup 300x2 at K=B/8; the same
breakdown over its two geometries.  Every tensor of every step's output
must be finite, else the run raises.

    python -m ft_mpc_torch.benchmarks.diag_residual [--backend condensed|stagewise]
        [--batch B] [--device cuda|cpu] [--out FILE]

Prints two lines a run and the record as one JSON line, last.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from ft_mpc_torch.benchmarks import bench, common

BATCH = 128
STEPS = 10
WORST = 5
# (path, sqp iters, admm iters, phases, newton iters, rho, clip): :118-129
RUNS = (
    ("lanes", 2, 40, 1, 3, 50.0, 1.5),
    ("condensed", 2, 40, 1, 3, 50.0, 1.5),
    ("lanes", 2, 160, 1, 3, 50.0, 1.5),
    ("condensed", 2, 160, 1, 3, 50.0, 1.5),
    ("lanes", 2, 160, 2, 3, 50.0, 1.5),
    ("condensed", 2, 160, 2, 3, 50.0, 1.5),
    ("lanes", 2, 160, 2, 8, 50.0, 1.5),
    ("lanes", 2, 80, 1, 3, 200.0, 5.0),
    ("condensed", 2, 80, 1, 3, 200.0, 5.0),
)
PATHS = {"lanes": "get_control_batch", "condensed": "get_control_rows"}
STAGEWISE = dict(batch=512, horizon=240, iters=60, cleanup=300, cleanup_phases=2)
STAGEWISE_PATTERNS = ((), (10, 11))


def run_config(spec):
    """diag_residual.py:80-89 (qp_backend left at 'condensed')."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    _, sqp, iters, phases, newton, rho, clip = spec
    return MPCConfig(horizon=bench.HORIZON, sqp_iters=sqp,
                     admm=StructuredADMMConfig(iters=iters, phases=phases, rho=rho,
                                               adapt_clip=clip),
                     newton_iters=newton)


def stagewise_config(B: int):
    """chip_smoke section 5's (`benchmarks/long_horizon.py:73-86`)."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig

    it = STAGEWISE["iters"]
    return MPCConfig(
        horizon=STAGEWISE["horizon"], sqp_iters=2, qp_backend="stagewise",
        admm=StructuredADMMConfig(iters=it, phases=1, rho=50.0, adapt_clip=1.5),
        stagewise=StagewiseConfig(iters=it, phases=1, rho=50.0, adapt_clip=1.5, mode="lanes"),
        newton_iters=3, cleanup_iters=STAGEWISE["cleanup"], cleanup_k=max(1, B // 8),
        cleanup_phases=STAGEWISE["cleanup_phases"],
    )


def per_geometry(r_prim, n_geo: int) -> np.ndarray:
    """Each geometry's largest r_prim: row i is geometry i % n_geo (those
    the batch has)."""
    rp = np.asarray(r_prim, dtype=np.float64)
    return np.array([rp[g::n_geo].max() for g in range(min(n_geo, len(rp)))])


def breakdown(r_prim, r_dual, patterns) -> dict:
    """diag_residual.py:103-112: max, p50, p95 of r_prim, the largest
    r_dual, the `WORST` geometries by their row maximum, largest first."""
    rp = np.asarray(r_prim, dtype=np.float64)
    geo = per_geometry(rp, len(patterns))
    worst = np.argsort(geo)[::-1][:WORST]
    return {"max": float(rp.max()), "p50": float(np.median(rp)),
            "p95": float(np.percentile(rp, 95)),
            "r_dual_max": float(np.max(np.asarray(r_dual))),
            "worst_geometries": [{"geometry": int(g), "r_prim": float(geo[g]),
                                  "pattern": common.pattern_name(patterns[g])}
                                 for g in worst]}


def run(s, spec, steps: int = STEPS):
    """One run (a row of `RUNS`) on the inputs `s` (`bench.inputs`): (its
    record, its last output)."""
    from ft_mpc_torch.controllers import spiraling as sp

    cfg = run_config(spec)
    path = spec[0]
    if path == "lanes":
        warm = sp.init_warmstart_batch(s.params, s.bank, s.weights, cfg, s.c0, s.x_ref,
                                       s.u_ref)
        fn = sp.get_control_batch
    elif path == "condensed":
        warm = sp.init_warmstart(s.params, s.bank, cfg, s.c0, weights=s.weights)
        fn = sp.get_control_rows
    else:
        raise ValueError(f"unknown path {path!r}")
    step = lambda w: fn(s.params, s.bank, s.weights, cfg, s.x0, s.x_ref, s.u_ref, w)
    _, sqp, iters, phases, newton, rho, clip = spec
    what = f"[{path}] sqp={sqp} iters={iters} ph={phases} nw={newton} rho={rho} clip={clip}"
    timing, out = common.drive_chain(step, warm, steps, s.x0.device, what)
    rec = {"path": path, "function": PATHS[path], "label": what,
           **breakdown(out.info.r_prim.cpu().numpy(), out.info.r_dual.cpu().numpy(),
                       common.bench_patterns()),
           **timing, "config": common.config_record(cfg)}
    return rec, out


def stagewise_inputs(B: int, device):
    """The stagewise leg's inputs, as `bench.inputs` gives the condensed
    runs theirs."""
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiraling import MPCWeights
    from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center
    from ft_mpc_torch.utils.faults import BrokenThruster

    f32 = torch.float32
    patterns = [[BrokenThruster(i, 1.0) for i in p] for p in STAGEWISE_PATTERNS]
    s = SimpleNamespace(patterns=patterns, cfg=stagewise_config(B))
    t0 = time.perf_counter()
    s.bank = common.tiled_bank(common.build_scenarios(patterns), B, device)
    s.build_s = time.perf_counter() - t0
    s.params = BodyParams.default(common.DT, dtype=f32, device=device)
    s.weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], dtype=f32,
                                          device=device)
    Nt = STAGEWISE["horizon"]
    s.x_ref, s.u_ref = common.hover_refs(Nt, max(30, (Nt + 2) * common.DT), device)
    s.x0 = torch.as_tensor(common.long_horizon_x0(B), device=device)
    s.c0 = robot_to_center(s.bank.r, s.x0)
    return s


def run_stagewise(s, steps: int = STEPS):
    """The stagewise leg on `stagewise_inputs`: (its record, its last output)."""
    from ft_mpc_torch.controllers.spiraling import get_control_batch, init_warmstart_batch

    cfg = s.cfg
    warm = init_warmstart_batch(s.params, s.bank, s.weights, cfg, s.c0, s.x_ref, s.u_ref)
    step = lambda w: get_control_batch(s.params, s.bank, s.weights, cfg, s.x0, s.x_ref,
                                       s.u_ref, w)
    what = (f"[stagewise] B={len(s.x0)} Nt={cfg.horizon} iters={cfg.stagewise.iters} "
            f"cleanup={cfg.cleanup_iters}x{cfg.cleanup_phases}@K{cfg.cleanup_k}")
    timing, out = common.drive_chain(step, warm, steps, s.x0.device, what)
    rec = {"path": "stagewise", "function": "get_control_batch", "label": what,
           **breakdown(out.info.r_prim.cpu().numpy(), out.info.r_dual.cpu().numpy(),
                       s.patterns),
           "max_term_gap": float(out.info.term_gap.max()),
           **timing, "config": common.config_record(cfg)}
    return rec, out


def lines(r: dict) -> str:
    """diag_residual.py:105-111's two lines."""
    worst = [(w["geometry"], f"{w['r_prim']:.2e}", w["pattern"]) for w in r["worst_geometries"]]
    return (f"{r['label']}: max={r['max']:.2e} p50={r['p50']:.2e} p95={r['p95']:.2e} "
            f"r_dual_max={r['r_dual_max']:.2e} ({r['ms_per_step']:.3f} ms a step)\n"
            f"    worst geometries: {worst}")


def main(B: int | None = None, runs=RUNS, steps: int = STEPS, backend: str = "condensed",
         device=None, out=None) -> dict:
    """The nine runs (`backend` 'condensed') or the stagewise leg; returns
    the record (and writes it to `out`).  B defaults to 128, on the
    stagewise leg to 512."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    if backend == "condensed":
        B = BATCH if B is None else B
        s = bench.inputs(B, dev)
        rows = []
        for r in runs:
            rec, _ = run(s, r, steps)
            print(lines(rec), flush=True)
            rows.append(rec)
    elif backend == "stagewise":
        B = STAGEWISE["batch"] if B is None else B
        s = stagewise_inputs(B, dev)
        rec, _ = run_stagewise(s, steps)
        print(lines(rec), flush=True)
        rows = [rec]
    else:
        raise ValueError(f"unknown backend {backend!r}")
    record = {"backend": backend, "batch": B, "steps": steps, "runs": rows,
              "bank_build_s": s.build_s, **ident}
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="condensed", choices=("condensed", "stagewise"))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    print(json.dumps(main(B=a.batch, backend=a.backend, device=a.device, out=a.out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
