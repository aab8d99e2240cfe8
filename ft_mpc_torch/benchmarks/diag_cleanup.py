"""How the residual tail of the condensed step depends on the worst-K
cleanup's budget, counterpart of `benchmarks/diag_cleanup.py`.

The five runs of `diag_cleanup.py:104-108`, each 2 SQP iterations, ADMM at
rho 50 and clip 1.5, 3 Newton steps, on the bench's inputs at B=2048 (the
32-pattern bank tiled, the seed-0 tumbling states, the hover references):
(ADMM iterations, cleanup iterations, cleanup K, cleanup phases) =
(60, 0, 0, 1), (60, 300, 256, 1), (60, 300, 256, 2), (60, 300, 512, 1),
(80, 400, 512, 1).  Each run takes `init_warmstart_batch`, then 10 chained
`get_control_batch` steps from the same states, the warm start carried (the
script's `fori_loop`, `:84-91`).  Its record: r_prim sorted from the
largest, read at ranks 0, 1, 4, 16, 64, 255 and 511, the counts above 1e-3
and above 1e-2 (`:93-101`), the largest r_dual, the ms a step by the host
clock to a device synchronize over the 10 steps, the kernels' launches a
step and the `newton_kinv` rescues.  Every tensor of every step's output
must be finite, else the run raises.

    python -m ft_mpc_torch.benchmarks.diag_cleanup [--device cuda|cpu] [--out FILE]

Prints one line a run and the record as one JSON line, last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ft_mpc_torch.benchmarks import bench, common

BATCH = 2048
STEPS = 10
# (admm iters, cleanup iters, cleanup K, cleanup phases): diag_cleanup.py:104-108
RUNS = (
    (60, 0, 0, 1),  # no cleanup: the raw tail
    (60, 300, 256, 1),
    (60, 300, 256, 2),
    (60, 300, 512, 1),
    (80, 400, 512, 1),
)
RANKS = (0, 1, 4, 16, 64, 255, 511)


def run_config(budget):
    """diag_cleanup.py:72-81."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    iters, cl_iters, cl_k, cl_ph = budget
    return MPCConfig(
        horizon=bench.HORIZON, sqp_iters=2,
        admm=StructuredADMMConfig(iters=iters, phases=1, rho=50.0, adapt_clip=1.5),
        newton_iters=3, cleanup_iters=cl_iters, cleanup_k=cl_k, cleanup_phases=cl_ph,
    )


def tail(r_prim) -> dict:
    """diag_cleanup.py:93-101: r_prim sorted from the largest at `RANKS`
    (the ranks the batch has), and the counts above 1e-3 and 1e-2."""
    rp = np.sort(np.asarray(r_prim, dtype=np.float64))[::-1]
    return {"max": float(rp[0]),
            "ranked": {str(k): float(rp[k]) for k in RANKS if k < len(rp)},
            "n_above_1e-3": int(np.sum(rp > 1e-3)), "n_above_1e-2": int(np.sum(rp > 1e-2))}


def run(s, budget, steps: int = STEPS):
    """One run (a row of `RUNS`) on the inputs `s` (`bench.inputs`): (its
    record, its last output)."""
    from ft_mpc_torch.controllers.spiraling import get_control_batch, init_warmstart_batch

    cfg = run_config(budget)
    warm = init_warmstart_batch(s.params, s.bank, s.weights, cfg, s.c0, s.x_ref, s.u_ref)
    step = lambda w: get_control_batch(s.params, s.bank, s.weights, cfg, s.x0, s.x_ref,
                                       s.u_ref, w)
    iters, cl_iters, cl_k, cl_ph = budget
    timing, out = common.drive_chain(
        step, warm, steps, s.x0.device,
        f"diag_cleanup iters={iters} cleanup={cl_iters}x{cl_ph}@K{cl_k}")
    rec = {"admm_iters": iters, "cleanup_iters": cl_iters, "cleanup_k": cl_k,
           "cleanup_phases": cl_ph, **timing,
           "r_prim": tail(out.info.r_prim.double().cpu().numpy()),
           "max_r_dual": float(out.info.r_dual.max()),
           "max_term_gap": float(out.info.term_gap.max()),
           "config": common.config_record(cfg)}
    return rec, out


def line(r: dict) -> str:
    """diag_cleanup.py:94-100's line."""
    t = r["r_prim"]
    top = [f"{v:.1e}" for v in t["ranked"].values()]
    return (f"iters={r['admm_iters']} cleanup={r['cleanup_iters']}x{r['cleanup_phases']}"
            f"@K{r['cleanup_k']}: max={t['max']:.2e} top{top}"
            f" n>1e-3={t['n_above_1e-3']} n>1e-2={t['n_above_1e-2']}"
            f" ({r['ms_per_step']:.3f} ms a step)")


def main(B: int = BATCH, runs=RUNS, steps: int = STEPS, device=None, out=None) -> dict:
    """The runs; returns the record (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    s = bench.inputs(B, dev)
    rows = []
    for r in runs:
        rec, _ = run(s, r, steps)
        print(line(rec), flush=True)
        rows.append(rec)
    record = {"batch": B, "steps": steps, "ranks": list(RANKS), "runs": rows,
              "bank_build_s": s.build_s, **ident}
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
