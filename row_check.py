#!/usr/bin/env python3
"""Row by row, the program's control step against the plain reference in a
cell of the benchmark, with the reference in float32 as a second witness.

    python3 row_check.py --workload condensed_h15.census137_closed \
        --seeds 2150020203 2150020219 --periods 30 [--every 1] [--out F]

From the root of a checkout, on one NVIDIA GPU (on the host's CPU where
there is none: period 0 of a census seed takes seconds there).  The cell's closed loop is
flown as `perfbench/run.py` flies it (the program's bank, the harness's
plant, states and noise from the seed, the first warm start), for
`--periods` periods; every `--every`-th period is then solved again by the
reference (`perfbench/check.py:Reference`) in float64 and in float32 from
the same inputs and warm start.  For each compared period:

* the rows whose command the program leaves more than 0.1 N from the
  float64 reference, and what sets each apart: its rho ended more than 1%
  from the reference's (a rho split, ROADMAP C4); the worst-K cleanup
  re-solved it on one side only; its SQP iterate agrees within 1e-3 and
  only the allocation differs (a branch at a hull facet, C1); or none of
  these.  The same counts for the float32 reference;
* the rows of the largest command gaps: fault pattern, the program's gap
  and the float32 reference's on the same row, the iterate's gap, the
  three rhos, which of the above holds, and the number of hull facets in
  the program's bank and in the reference's;
* where the configuration has a state box or a wrench-rate bound: how many
  of its dense rows are active (dual above 1e-6) or at the elastic cap, in
  the float64 reference's and in the program's last QP, in how many bank
  rows, and the largest predicted velocity against the box.

Where the float32 reference's own step fails on the card (`linalg.eigh`
not converging in float32), that period's float32 reference is solved on
the host instead, and the line says so.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GAP_N = 0.1  # a row whose command is this far off is a row the fault census sees
SPLIT = 1e-2  # relative rho difference that counts as a split
ACTIVE = 1e-6  # a dense row's dual above this is active
U_SAME = 1e-3  # an iterate this close is the same QP answer
TOP = 5


class _CleanupRows:
    """`torch` as the controller module sees it, with `topk` recorded: the
    rows each worst-K cleanup re-solves."""

    def __init__(self, torch):
        self._torch, self.idx = torch, []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def topk(self, *args, **kwargs):
        got = self._torch.topk(*args, **kwargs)
        self.idx.append(got[1].clone())
        return got


def rows_of(u, U, rho, cleaned, a):
    """Per row, against the float64 reference step `a`: the largest command
    gap, the iterate's largest gap, whether rho ended more than SPLIT apart,
    whether the cleanup re-solved the row on one side only."""
    h = lambda t: t.detach().cpu().double()
    du = (h(u) - h(a.u_phys)).abs().amax(1)
    dU = (h(U) - h(a.warm.U)).abs().amax((1, 2))
    rel = (h(rho) - h(a.warm.rho)).abs() / h(a.warm.rho)
    return du, dU, rel > SPLIT, cleaned.cpu() != a.info.cleaned.cpu()


def why(du, dU, split, clean):
    """Counts of the rows over GAP_N by what sets them apart (first that holds)."""
    over = du > GAP_N
    alloc = over & ~split & ~clean & (dU <= U_SAME)
    return {"rows_over": int(over.sum()), "split": int((over & split).sum()),
            "cleanup": int((over & ~split & clean).sum()), "alloc": int(alloc.sum()),
            "rest": int((over & ~split & ~clean & (dU > U_SAME)).sum())}


def bound_rows(y, X, ub, Nt, T0, n_box, ym):
    """Active and capped dense rows after the T0 terminal rows: the box's
    first n_box rows (both sides), then the rate rows."""
    ext = y.double()[:, T0:]
    box, rate = ext[:, :n_box], ext[:, n_box:]
    v = X.double()[:, 1:Nt, 3:6]
    out = {"box_active": int((box > ACTIVE).sum()), "rate_active": int((rate > ACTIVE).sum()),
           "box_capped": int((box >= 0.999 * ym).sum()) if ym > 0 else 0,
           "rate_capped": int((rate >= 0.999 * ym).sum()) if ym > 0 else 0,
           "crafts_box_active": int((box > ACTIVE).any(1).sum()),
           "crafts_rate_active": int((rate > ACTIVE).any(1).sum()),
           "v_max": float(v.max())}
    if ub is not None:
        out["v_within_1mm_s_of_box"] = int((v >= ub[3:6].double() - 1e-3).sum())
    return out


def check_seed(workload: str, seed: int, periods: int, every: int, device,
               bench_path: Path | None = None, data: Path | None = None) -> dict:
    """One seed's compared periods (`bench_path`, `data`: another
    `BENCHMARK.json` and data directory, as `perfbench.cell.load` takes)."""
    import torch

    from perfbench import cell as cells, check, plant, system
    from perfbench import reference as ref
    from perfbench.run import REF_ROWS, Loop

    from ft_mpc_torch.controllers import spiraling

    c = cells.load(workload, bench_path, data)
    cfg, tr = c.config, c.traffic
    B, Nt = tr["batch"], cfg["mpc"]["horizon"]
    sut = system.build(cfg, tr, device)
    loop = Loop(sut, c, plant.initial_states(tr["initial_state"], B, seed), seed, device)
    kept = []
    spiraling.torch = rec = _CleanupRows(torch)
    try:
        for p in range(periods):
            rec.idx.clear()
            _, out, _, t = loop.period()
            if p % every == 0:
                s = check.snapshot(t.p, t.x, t.start, t.warm_in, t.prev, out)
                s.rho, s.y_term, s.X = (out.warm.rho.clone(), out.warm.y_term.clone(),
                                        out.warm.X.clone())
                s.cleaned = torch.zeros(B, dtype=torch.bool, device=device)
                for idx in rec.idx:
                    s.cleaned[idx] = True
                kept.append(s)
    finally:
        spiraling.torch = torch
    facets = sut.bank.hull_mask.sum(-1).cpu()
    del loop, sut
    r64 = check.Reference(cfg, tr, ROOT, device)
    facets_f64 = r64.bank.hull_mask.sum(-1).cpu()
    r32 = check.Reference(cfg, tr, ROOT, device, dtype=torch.float32)
    r32_host = None
    xr, ur = plant.hover_refs(REF_ROWS + Nt + 1, tr["reference"]["position"],
                              tr["reference"]["omega_des"])
    patterns = [tr["patterns"][i] for i in cells.bank_rows(tr)]
    bounded = cells.extra_rows(cfg) > 0
    T0 = cfg["padding"]["terminal_rows"]
    n_box = 2 * (Nt - 1) * ref.N_X * ref.has_box(r64.W)
    ym = r64.cfg.admm.elastic_y_max
    found = []
    for s in kept:
        win = slice(s.start, s.start + Nt + 1)
        as_t = lambda a, dt: torch.as_tensor(a[win], dtype=dt, device=device)
        a = r64.step(s, as_t(xr, torch.float64), as_t(ur, torch.float64))
        f32_on = device.type
        try:
            b = r32.step(s, as_t(xr, torch.float32), as_t(ur, torch.float32))
        except torch.linalg.LinAlgError:
            if r32_host is None:
                r32_host = check.Reference(cfg, tr, ROOT, torch.device("cpu"), torch.float32)
            b = r32_host.step(s, as_t(xr, torch.float32), as_t(ur, torch.float32))
            f32_on = "cpu"
        du, dU, split, clean = rows_of(s.u, s.U, s.rho, s.cleaned, a)
        du32, dU32, split32, clean32 = rows_of(b.u_phys, b.warm.U, b.warm.rho,
                                               b.info.cleaned, a)
        top = du.argsort(descending=True)[:TOP].tolist()
        got = {"p": s.p, "program": why(du, dU, split, clean),
               "f32": why(du32, dU32, split32, clean32), "f32_on": f32_on,
               "split": int(split.sum()), "f32_split": int(split32.sum()),
               "cleaned": int(s.cleaned.sum()), "cleaned_f64": int(a.info.cleaned.sum()),
               "both_over": int(((du > GAP_N) & (du32 > GAP_N)).sum()),
               "du_max": float(du.max()), "du_max_f32": float(du32.max()),
               "dU_max": float(dU.max()), "dU_max_f32": float(dU32.max()),
               "top": [{"row": i, "pattern": patterns[i], "du": float(du[i]),
                        "du_f32": float(du32[i]), "dU": float(dU[i]),
                        "dU_f32": float(dU32[i]), "split": bool(split[i]),
                        "cleanup_differs": bool(clean[i]), "rho": float(s.rho[i]),
                        "rho_f64": float(a.warm.rho[i]), "rho_f32": float(b.warm.rho[i]),
                        "hull_facets": int(facets[i]), "hull_facets_f64": int(facets_f64[i])}
                       for i in top]}
        if bounded:
            ub = r64.W.x_ub
            got["bounds_f64"] = bound_rows(a.warm.y_term, a.warm.X, ub, Nt, T0, n_box, ym)
            got["bounds_program"] = bound_rows(s.y_term, s.X, ub, Nt, T0, n_box, ym)
        found.append(got)
    return {"workload": workload, "seed": seed, "B": B, "periods": periods,
            "every": every, "compared": found}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--periods", type=int, required=True)
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    from perfbench import run

    run.environment()
    import torch

    torch.set_num_threads(1)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    lines = []
    for seed in args.seeds:
        line = json.dumps(check_seed(args.workload, seed, args.periods, args.every, device))
        print(line, flush=True)
        lines.append(line + "\n")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
