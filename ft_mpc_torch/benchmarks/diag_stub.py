"""The stubborn row of the condensed step and its QP probed directly,
counterpart of `benchmarks/diag_stub.py`.

The run: the bench's inputs at B=2048 (the 32-pattern bank tiled, the
seed-0 tumbling states, the hover references), 2 SQP iterations, ADMM 60x1
at rho 50 and clip 1.5, 3 Newton steps, cleanup 300x1 at K=256
(`diag_stub.py:73-77`), `init_warmstart_batch` and 10 chained
`get_control_batch` steps from the same states.  Its worst row by r_prim is
named with its geometry (row modulo 32), fault pattern, r_prim, r_dual and
rho (`:97-102`).

Its QP is assembled again at the final iterate by `_assemble_condensed_batch`
on the row's own scenario, with `_masked_geometry` and the per-scenario
reference `sqp_solve_batch` gives the assembly (the JAX script passes the
shared (Nt+1, 9) window, which that function's (B, Nt+1, 9) reference
cannot take); the record gives the terminal rows' h_term on the active rows:
its min and the count of negatives (`:104-115`), a negative row being one
the state cannot reach.  Then the per-scenario `solve_mpc_qp` (an exact
inverse a phase) probes it at rho in {1, 10, 50, 250, 1000} and budgets
{300x1, 300x4, 1000x4} with clip 5.0 (`:117-125`): r_prim, r_dual and the
rho it ends at, 15 solves, which tell an ADMM floor from infeasibility.
Every tensor of every step's output must be finite, else the run raises.

    python -m ft_mpc_torch.benchmarks.diag_stub [--device cuda|cpu] [--out FILE]

Prints the row, its QP, one line a probe and the record as one JSON line,
last.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ft_mpc_torch.benchmarks import bench, common, diag_cleanup

BATCH = 2048
STEPS = 10
RUN = (60, 300, 256, 1)  # diag_cleanup's (admm iters, cleanup iters, K, phases)
RHOS = (1.0, 10.0, 50.0, 250.0, 1000.0)
BUDGETS = ((300, 1), (300, 4), (1000, 4))
PROBE_CLIP = 5.0


def row_qp(s, warm, i: int, assemble=None):
    """Row i's QP at the warm start's iterate (`warm.X`, `warm.U`), as
    `sqp_solve_batch` assembles it, without the batch axis.  `assemble`
    defaults to `_assemble_condensed_batch` (the condensing kernel)."""
    from ft_mpc_torch.controllers import spiraling as sp
    from ft_mpc_torch.solvers.mpc_qp import StructuredMPCQP

    assemble = sp._assemble_condensed_batch if assemble is None else assemble
    rows = torch.tensor([i], device=warm.X.device)
    bank = sp.take_rows(s.bank, rows)
    x_ref = sp._per_scenario_ref(bank, s.x_ref, 1)
    qp, *_ = assemble(s.params, bank, s.weights, s.cfg, warm.X[rows], warm.U[rows], x_ref,
                      s.u_ref, *sp._masked_geometry(bank))
    return StructuredMPCQP(*(t[0] for t in qp))


def probe(qp, rhos=RHOS, budgets=BUDGETS) -> list[dict]:
    """`solve_mpc_qp` on one QP at each rho and budget (clip PROBE_CLIP)."""
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig, solve_mpc_qp

    res = []
    for rho in rhos:
        for iters, phases in budgets:
            c = StructuredADMMConfig(iters=iters, phases=phases, rho=rho,
                                     adapt_clip=PROBE_CLIP)
            t0 = time.perf_counter()
            sol = solve_mpc_qp(qp, c)
            r = {"rho": rho, "iters": iters, "phases": phases,
                 "r_prim": float(sol.r_prim), "r_dual": float(sol.r_dual),
                 "rho_out": float(sol.rho), "finite": bool(torch.isfinite(sol.x).all()),
                 "host_ms": 1e3 * (time.perf_counter() - t0)}
            print(f"  rho={rho:6.1f} {iters}x{phases}: r_prim={r['r_prim']:.3e} "
                  f"r_dual={r['r_dual']:.3e} rho_out={r['rho_out']:.3g}", flush=True)
            res.append(r)
    return res


def main(B: int = BATCH, steps: int = STEPS, rhos=RHOS, budgets=BUDGETS, device=None,
         out=None) -> dict:
    """The run, its worst row, its QP and the probe; returns the record
    (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    s = bench.inputs(B, dev)
    s.cfg = diag_cleanup.run_config(RUN)
    run, last = diag_cleanup.run(s, RUN, steps)
    rp = last.info.r_prim
    i = int(torch.argmax(rp))
    geo = i % common.BENCH_PATTERNS
    worst = {"index": i, "geometry": geo,
             "pattern": common.pattern_name(common.bench_patterns()[geo]),
             "r_prim": float(rp[i]), "r_dual": float(last.info.r_dual[i]),
             "rho": float(last.warm.rho[i])}
    print(f"stubborn scenario: idx={i} geometry={geo} faults={worst['pattern']} "
          f"r_prim={worst['r_prim']:.3e} r_dual={worst['r_dual']:.3e} "
          f"rho={worst['rho']:.3g}", flush=True)

    qp = row_qp(s, last.warm, i)
    active = s.bank.term_mask[i] > 0.5
    ht = qp.h_term[: active.shape[0]][active]
    h_term = {"active_rows": int(active.sum()), "min": float(ht.min()),
              "n_negative": int((ht < 0).sum())}
    print(f"h_term (active rows): min={h_term['min']:.3e} "
          f"n_negative={h_term['n_negative']}", flush=True)
    probes = probe(qp, rhos, budgets)
    if not all(p["finite"] for p in probes):
        raise RuntimeError("diag_stub: a probe's solution is not finite")
    record = {"batch": B, "steps": steps, "run": run, "worst_row": worst,
              "h_term": h_term, "probe_clip": PROBE_CLIP, "probes": probes,
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
