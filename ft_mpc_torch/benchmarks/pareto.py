"""The accuracy/throughput frontier of the condensed step on one card,
counterpart of `benchmarks/pareto.py`.

The six points of `pareto.py:25-32`, (SQP iterations, ADMM iterations,
phases, Newton steps, cleanup iterations, cleanup K), run on the bench's
inputs (`ft_mpc_torch.benchmarks.bench`: B=2048, Nt=15, the 32-pattern
bank, the seed-0 tumbling states, the hover references, ADMM at rho 50 and
clip 1.5, the cleanup's 3 phases).  The JAX script runs one subprocess a
point for a fresh compile each; the port compiles nothing, and its host's
speed drifts between calls, so every point runs in one process, in turns:
the bank is built once, each point gets its own `init_warmstart_batch` and
its own chain of warm starts, one untimed window of 10 chained steps, then
`rounds` rounds in which every point runs one window of 10 chained steps,
the order of the points reversed every other round
(`profile_step.in_turns`).  A window is timed by the host clock to a device
synchronize; each sample is its per-step mean.  Per point: p50 and p99 over
its samples, solves/s = B / p50, the spread of its samples, and its ratio
to the deployed point in the same round (median over the rounds); from its
last step max_r_prim, the largest r_dual, max_term_gap and the gap rows;
its kernel launches a step and `newton_kinv` rescues over all its windows.

The restoration-gap gate is off (the JAX script sets
FT_MPC_BENCH_GAP_GATE=10): a sweep measures residuals.  Every tensor of
every step's output must be finite, else the run raises.  The frontier
table has `pareto.py:91-106`'s columns (with p99 and the spread added);
the gap rows are listed once beside it.  The record names the fastest
point at max_r_prim <= 1e-3 and whether its p50 meets the 100 ms control
period; it sets no throughput target.  Nothing is written unless `--out`
is given (the JAX script writes into `benchmarks/`; this never does).

    python -m ft_mpc_torch.benchmarks.pareto [--device cuda|cpu] [--out FILE]
    ft-mpc-torch-pareto                        # the same entry point

Prints the frontier table and the record as one JSON line, last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ft_mpc_torch.benchmarks import bench, common, profile_step

# (sqp_iters, admm_iters, phases, newton_iters, cleanup_iters, cleanup_k);
# cleanup_iters 0 turns the worst-K cleanup off
CONFIGS = (
    (2, 40, 1, 3, 0, 0),
    (2, 60, 1, 3, 0, 0),
    (2, 60, 1, 3, 300, 256),
    (2, 60, 1, 3, 450, 256),
    (2, 60, 1, 3, 600, 256),  # the deployed configuration (the bench's)
    (3, 80, 1, 3, 600, 256),
)
DEPLOYED = (2, 60, 1, 3, 600, 256)
ROUNDS = 12
STEPS_PER_WINDOW = 10
CLEANUP_PHASES = 3
R_PRIM_CLASS = 1e-3  # the reference's IPOPT tolerance (pareto.py:7)
GAP_GATE = 10.0  # off: pareto.py:47


def point_config(point):
    """The MPCConfig of one point: the bench's with the point's budget."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    sqp, iters, phases, newton, cleanup, cleanup_k = point
    return MPCConfig(
        horizon=bench.HORIZON, sqp_iters=sqp,
        admm=StructuredADMMConfig(iters=iters, phases=phases, rho=50.0, adapt_clip=1.5),
        newton_iters=newton, cleanup_iters=cleanup, cleanup_k=cleanup_k,
        cleanup_phases=CLEANUP_PHASES,
    )


def label(point) -> str:
    sqp, iters, phases, newton, cleanup, cleanup_k = point
    cl = f"{cleanup}@K{cleanup_k}" if cleanup else "off"
    return f"sqp {sqp}, admm {iters}x{phases}, newton {newton}, cleanup {cl}"


class Chain:
    """One point's own chain of warm starts: each call runs one window of
    chained steps and counts the kernels' launches and the `newton_kinv`
    rescues in it."""

    def __init__(self, cfg, step, warm, steps: int):
        self.cfg, self.step, self.warm, self.steps = cfg, step, warm, steps
        self.watch = common.FiniteWatch()
        self.windows, self.launches, self.rescues = 0, {}, 0
        self.out = None

    def __call__(self):
        from ft_mpc_torch.solvers.lanes_qp import newton_kinv

        before, rescues = common.read_counters(), newton_kinv.rescues
        self.out = common.chained_steps(self.step, self.warm, self.steps, self.watch)
        self.warm = self.out.warm
        for k, v in common.read_counters().items():
            self.launches[k] = self.launches.get(k, 0) + v - before[k]
        self.rescues += newton_kinv.rescues - rescues
        self.windows += 1


def point_record(point, chain: Chain, timed: dict, deployed_rounds, B: int,
                 init_ms: float) -> dict:
    """One point's record from its chain and its `in_turns` times."""
    rounds = np.asarray(timed["host_ms_rounds"])
    samples = rounds / chain.steps
    p50 = float(np.percentile(samples, 50))
    info = chain.out.info
    gaps = info.term_gap.double().cpu().numpy()
    gap_rows = [int(r) for r in np.flatnonzero(gaps > bench.GAP_ROW_TOL)]
    steps = chain.windows * chain.steps
    sqp, iters, phases, newton, cleanup, cleanup_k = point
    return {
        "sqp_iters": sqp, "admm_iters": iters, "phases": phases, "newton_iters": newton,
        "cleanup_iters": cleanup, "cleanup_k": cleanup_k, "label": label(point),
        "latency_p50_ms": p50,
        "latency_p99_ms": float(np.percentile(samples, 99)),
        "solves_per_s": B * 1e3 / p50,
        "latency_samples_ms": samples.tolist(),
        "spread": {"min_ms": float(samples.min()), "max_ms": float(samples.max()),
                   "max_over_min": float(samples.max() / samples.min())},
        "vs_deployed_same_round": float(np.median(rounds / np.asarray(deployed_rounds))),
        "meets_control_period": p50 <= bench.PERIOD_MS,
        "max_r_prim": float(info.r_prim.max()),
        "max_r_dual": float(info.r_dual.max()),
        "max_term_gap": float(np.nanmax(gaps)),
        "gap_rows": gap_rows,
        "gap_patterns": sorted({r % common.BENCH_PATTERNS for r in gap_rows}),
        "launches_per_step": {k: v / steps for k, v in chain.launches.items()},
        "counted_steps": steps,
        "newton_rescues": chain.rescues,
        "init_ms": init_ms,
        "config": common.config_record(chain.cfg),
    }


def frontier(points: list[dict]) -> list[str]:
    """pareto.py:91-121: the frontier table, then the gap rows once."""
    md = ["| sqp | admm iters | cleanup | solves/s | max_r_prim | ms/step (p50) | p99 | "
          "spread max/min |", "|---|---|---|---|---|---|---|---|"]
    for r in points:
        cl = f"{r['cleanup_iters']}@K{r['cleanup_k']}" if r["cleanup_iters"] else "off"
        md.append(f"| {r['sqp_iters']} | {r['admm_iters']}x{r['phases']} | {cl} | "
                  f"{r['solves_per_s']:.1f} | {r['max_r_prim']:.3e} | "
                  f"{r['latency_p50_ms']:.3f} | {r['latency_p99_ms']:.3f} | "
                  f"{r['spread']['max_over_min']:.3f} |")
    gaps = sorted({(tuple(r["gap_rows"]), round(r["max_term_gap"], 4)) for r in points})
    md += ["", "Restoration gaps (apart from the frontier; rows of the bench bank):"]
    md += [f"- rows {list(g)}, max gap {m}" for g, m in gaps]
    return md


def fastest_accurate(points: list[dict]) -> dict | None:
    """The point of least p50 among those at max_r_prim <= 1e-3."""
    ok = [r for r in points if r["max_r_prim"] <= R_PRIM_CLASS]
    if not ok:
        return None
    r = min(ok, key=lambda r: r["latency_p50_ms"])
    return {"label": r["label"], "latency_p50_ms": r["latency_p50_ms"],
            "solves_per_s": r["solves_per_s"], "max_r_prim": r["max_r_prim"],
            "meets_control_period": r["meets_control_period"]}


def main(B: int = bench.BATCH, configs=CONFIGS, rounds: int = ROUNDS,
         steps_per_window: int = STEPS_PER_WINDOW, device=None, out=None) -> dict:
    """The sweep; returns the record (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.controllers.spiraling import get_control_batch, init_warmstart_batch

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    s = bench.inputs(B, dev)
    chains, init_ms = {}, {}
    for point in configs:
        cfg = point_config(point)
        common.sync(dev)
        t0 = time.perf_counter()
        warm = init_warmstart_batch(s.params, s.bank, s.weights, cfg, s.c0, s.x_ref, s.u_ref)
        common.sync(dev)
        init_ms[point] = 1e3 * (time.perf_counter() - t0)
        step = (lambda w, cfg=cfg: get_control_batch(s.params, s.bank, s.weights, cfg, s.x0,
                                                     s.x_ref, s.u_ref, w))
        chains[point] = Chain(cfg, step, warm, steps_per_window)
    # in_turns runs each chain's untimed warm-up window, then the rounds
    timed = profile_step.in_turns({label(p): c for p, c in chains.items()}, rounds, dev)
    for point, chain in chains.items():
        chain.watch.require(f"pareto {label(point)}")
    ref = DEPLOYED if DEPLOYED in chains else configs[0]
    points = [point_record(p, c, timed[label(p)], timed[label(ref)]["host_ms_rounds"], B,
                           init_ms[p]) for p, c in chains.items()]
    table = frontier(points)
    record = {
        "batch": B, "rounds": rounds, "steps_per_window": steps_per_window,
        "warmup_windows": 1, "gap_gate": GAP_GATE, "reference_point": label(ref),
        "points": points, "frontier_md": table,
        "fastest_at_r_prim_1e-3": fastest_accurate(points),
        "bank_build_s": s.build_s, **ident,
    }
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    record = main(device=a.device, out=a.out)
    print("\n".join(record["frontier_md"]))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
