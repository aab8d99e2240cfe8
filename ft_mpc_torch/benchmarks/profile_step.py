"""Component times of the batched control step on one card, counterpart of
`benchmarks/profile_step.py`.

The JAX script profiles `vmap(get_control)`; this profiles the port's
batched main path, `get_control_batch` at the bench's configuration and
inputs (`ft_mpc_torch.benchmarks.bench`: B=2048, Nt=15, the 32-pattern
bank, the seed-0 tumbling states):
  (a) the full step;
  (b) `sqp_solve_batch` only, and the worst-K cleanup inside it (the
      difference from `sqp_solve_batch` with cleanup_iters=0);
  (c) `allocate_thrusters_lanes` only, on the step's own wrenches;
  (d) `_linearize` only (one SQP iteration's jacobians);
  (e) `_assemble_condensed_batch` (linearization, condensing, assembly);
  (f) `solve_mpc_qp_lanes` on the fixed QP of (e), as an SQP iteration
      calls it (carried duals, rho and K^-1, Newton refresh);
  (g) `exact_kinv` and `newton_kinv` on that QP's metric;
  (h) the full step at B=4096 and 8192 (the bank tiled, bench.py's states);
  (i) `_merit_alpha`, the line search, on (e)'s trajectory and the step
      (f)'s solution gives it (`benchmarks/profile_batch.py:163-179` times
      it on random steps).

The warm start is the one after the bench's warm-up window (10 chained
steps from `init_warmstart_batch`).  Each component runs once untimed; then
`reps` rounds call every component once in turn (the order reversed every
other round), so that the host's drift within a run falls on all of them
alike.  Each call is timed two ways at once: by the host clock ending in a
device synchronize (what the step pays) and by CUDA events around it (the
stream's span: once the host waits on the device, as `newton_kinv` does
every step, the span takes in the host's gaps too).  A component's times
are the medians of its rounds; the `newton_kinv` whole-batch rescues among
its calls are counted.  After every component is timed, one more call of
each runs under torch.profiler, whose kernel times are the device's busy
time; `dispatch_ms` = host - device busy.  For the full steps that call
also gives the host ms of each of the port's ranges (ft_mpc.linearize,
.cleanup, ...): a split inside one step, so a part never reads above its
whole, though the profiler's tracing slows the host.  Peak device memory for (a) and
each point of (h): the most a call allocated above what was allocated when
its peak was reset (`max_memory_allocated() - memory_allocated()`), so the
other components' inputs, resident throughout, do not count.

Each median has its standard error from the rounds' spread (median
absolute deviation).  For each pair of `CONTAINS` ((b) within (a), the
cleanup no more than the rest of (b), ...) the record gives the part's
median less its whole's with the standard error of that difference; a
part above its whole by more than twice that error is listed under
`unresolved`: that run's split cannot be read.  A pair closer than the
error (such as (b) and (a), which differ by the allocation, under 1 ms) is
simply not ordered by the run.

    python -m ft_mpc_torch.benchmarks.profile_step [--reps 15] [--device cuda|cpu]
        [--out FILE]

Prints one line a component and the record as one JSON line, last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ft_mpc_torch.benchmarks import bench, common

SWEEP = (4096, 8192)
WARMUP_STEPS = bench.STEPS_PER_WINDOW
CLEANUP = "cleanup (b - b0)"
MAD_SD = 1.4826  # standard deviation / median absolute deviation, normal noise
MEDIAN_SE = 1.2533  # standard error of a median / that of a mean, normal noise
# (part, whole): a call of the whole runs the part; the cleanup (one
# worst-K pass on 256 rows) is held to no more than the two SQP iterations
# on all B rows that it follows
CONTAINS = (
    ("(b) sqp_solve_batch", "(a) full step"),
    ("(c) allocate_thrusters_lanes", "(a) full step"),
    ("(b0) sqp_solve_batch without cleanup", "(b) sqp_solve_batch"),
    ("(e) _assemble_condensed_batch", "(b0) sqp_solve_batch without cleanup"),
    ("(f) solve_mpc_qp_lanes", "(b0) sqp_solve_batch without cleanup"),
    ("(d) _linearize", "(e) _assemble_condensed_batch"),
    (CLEANUP, "(b0) sqp_solve_batch without cleanup"),
    ("(i) _merit_alpha", "(b0) sqp_solve_batch without cleanup"),
)


def profiled(fn, device, ranges: bool) -> dict:
    """One call of `fn` under torch.profiler: the device's busy time (its
    kernel time; None on the CPU) and, with `ranges`, the call's host ms
    under the profiler and the host ms and count of each of the port's
    ranges (ft_mpc.*) in it, nested as the code nests them.  The ranges
    also appear as device-side spans, which would count their kernels
    twice in the busy time."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    res = {"device_busy_ms": None}
    if not (cuda or ranges):
        return res
    common.sync(device)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        fn()
        common.sync(device)
        host = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kind = lambda e: getattr(e, "device_type", None)
    if cuda:
        res["device_busy_ms"] = 1e-3 * sum(
            getattr(e, "self_device_time_total", 0) for e in events
            if kind(e) == torch.autograd.DeviceType.CUDA and not e.key.startswith("ft_mpc."))
    if ranges:
        res["profiled_host_ms"] = host
        res["ranges"] = {e.key: {"host_ms": 1e-3 * e.cpu_time_total, "calls": e.count}
                         for e in events if e.key.startswith("ft_mpc.")
                         and kind(e) == torch.autograd.DeviceType.CPU}
    return res


def timed_call(fn, device, memory: bool = False) -> dict:
    """One call of `fn`: ms by the host clock to a device synchronize and
    by CUDA events around it, the `newton_kinv` rescues in it; with
    `memory`, the most it allocated above what was allocated before it."""
    from ft_mpc_torch.solvers.lanes_qp import newton_kinv

    cuda = device.type == "cuda"
    common.sync(device)
    if memory and cuda:
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
    rescues = newton_kinv.rescues
    if cuda:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
    t0 = time.perf_counter()
    fn()
    if cuda:
        b.record()
    common.sync(device)
    res = {"host_ms": 1e3 * (time.perf_counter() - t0),
           "event_ms": a.elapsed_time(b) if cuda else None,
           "newton_rescues": newton_kinv.rescues - rescues}
    if memory and cuda:
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device) - resident
    return res


def in_turns(calls: dict, reps: int, device, memory=()) -> dict:
    """Each call once untimed, then `reps` rounds of one timed call each,
    in order and reversed by turns; per call the median host and event ms,
    the host median's standard error, the host ms of every round, the
    rescues in all rounds, and for the names in `memory` the largest
    peak."""
    for fn in calls.values():
        fn()
    rounds = {name: [] for name in calls}
    names = list(calls)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            rounds[name].append(timed_call(calls[name], device, name in memory))
    res = {}
    for name, rs in rounds.items():
        med = lambda k: None if rs[0][k] is None else float(np.median([x[k] for x in rs]))
        host = np.array([x["host_ms"] for x in rs])
        mad = float(np.median(np.abs(host - np.median(host))))
        res[name] = {"host_ms": med("host_ms"), "event_ms": med("event_ms"),
                     "host_ms_se": float(MEDIAN_SE * MAD_SD * mad / np.sqrt(reps)),
                     "host_ms_rounds": host.tolist(),
                     "newton_rescues": sum(x["newton_rescues"] for x in rs)}
        if "peak_mem_bytes" in rs[0]:
            res[name]["peak_mem_bytes"] = max(x["peak_mem_bytes"] for x in rs)
    return res


def containment(res: dict) -> list[dict]:
    """Each `CONTAINS` pair: the part's host ms less its whole's, and the
    standard error of that difference."""
    return [{"part": part, "whole": whole,
             "diff_ms": res[part]["host_ms"] - res[whole]["host_ms"],
             "se_ms": float(np.hypot(res[part]["host_ms_se"], res[whole]["host_ms_se"]))}
            for part, whole in CONTAINS]


def unresolved(pairs: list[dict]) -> list[str]:
    """The pairs whose part reads above its whole by more than twice the
    standard error of the difference: a split the run cannot read."""
    return [f"{c['part']} above {c['whole']} by {c['diff_ms']:.3f} ms "
            f"(standard error {c['se_ms']:.3f} ms)"
            for c in pairs if c["diff_ms"] > 2 * c["se_ms"]]


def setup(B: int, device):
    """The bench's inputs at B rows (`bench.inputs`) and the warm start
    after `WARMUP_STEPS` chained steps from `init_warmstart_batch` (the
    bench's warm-up window): (the inputs with `warm`, the last step's
    output)."""
    from ft_mpc_torch.controllers.spiraling import init_warmstart_batch

    s = bench.inputs(B, device)
    s.warm = init_warmstart_batch(s.params, s.bank, s.weights, s.cfg, s.c0, s.x_ref, s.u_ref)
    for _ in range(WARMUP_STEPS):
        out = s.step(s.warm)
        s.warm = out.warm
    return s, out


def components(s, out) -> dict:
    """name -> a call of that component on the bench's steady-state inputs."""
    from ft_mpc_torch.controllers import spiraling as sp
    from ft_mpc_torch.solvers.lanes_alloc import allocate_thrusters_lanes
    from ft_mpc_torch.solvers.lanes_qp import (
        build_K,
        exact_kinv,
        newton_kinv,
        solve_mpc_qp_lanes,
    )

    cfg, w, bank, p = s.cfg, s.warm, s.bank, s.params
    B = s.x0.shape[0]
    X = torch.cat([s.c0[:, None], w.X[:, 1:]], dim=1)
    x_ref = sp._per_scenario_ref(bank, s.x_ref, B)
    geo = sp._masked_geometry(bank)
    qp, S_all, phi_all, _ = sp._assemble_condensed_batch(p, bank, s.weights, cfg, X, w.U,
                                                          x_ref, s.u_ref, *geo)
    K, _ = build_K(qp, w.rho.to(torch.float32), cfg.admm.sigma)
    # the SQP iteration's step (sqp_solve_batch), which the line search scales
    sol = solve_mpc_qp_lanes(qp, cfg.admm, y_hull0=w.y_hull, y_term0=w.y_term, rho0=w.rho,
                             kinv0=w.kinv, newton_iters=cfg.newton_iters)
    dU = sol.x.reshape(B, cfg.horizon, -1)
    dX = torch.einsum("btin,bn->bti", S_all, sol.x) + phi_all
    sqp = lambda c: sp.sqp_solve_batch(p, bank, s.weights, c, s.c0, s.x_ref, s.u_ref, w)
    return {
        "(a) full step": lambda: s.step(w),
        "(b) sqp_solve_batch": lambda: sqp(cfg),
        "(b0) sqp_solve_batch without cleanup": lambda: sqp(cfg._replace(cleanup_iters=0)),
        "(c) allocate_thrusters_lanes": lambda: allocate_thrusters_lanes(
            out.wrench, p.D, bank.u_ub, bank.faulty_force_gen, bank.hull_A, bank.hull_b,
            bank.hull_mask, bank.gen_G, bank.gen_c, bank.gen_L, p.max_thrust),
        "(d) _linearize": lambda: sp._linearize(p, bank, cfg, X, w.U, s.u_ref),
        "(e) _assemble_condensed_batch": lambda: sp._assemble_condensed_batch(
            p, bank, s.weights, cfg, X, w.U, x_ref, s.u_ref, *geo),
        "(f) solve_mpc_qp_lanes": lambda: solve_mpc_qp_lanes(
            qp, cfg.admm, y_hull0=w.y_hull, y_term0=w.y_term, rho0=w.rho, kinv0=w.kinv,
            newton_iters=cfg.newton_iters),
        "(g) exact_kinv": lambda: exact_kinv(K),
        "(g) newton_kinv": lambda: newton_kinv(K, w.kinv, cfg.newton_iters),
        "(i) _merit_alpha": lambda: sp._merit_alpha(p, bank, s.weights, cfg, X, w.U, dX, dU,
                                                    x_ref, s.u_ref, *geo),
    }


def main(B: int = bench.BATCH, reps: int = 15, sweep=SWEEP, device=None, out=None) -> dict:
    """Components (a)-(g) at B and the full step at each batch of `sweep`,
    timed in turns over `reps` rounds and profiled once, each from the warm
    start after `WARMUP_STEPS` chained steps; returns the record (and
    writes it to `out`).  Every host and event time is taken before the
    first profiler session, whose tracing would slow the host's later
    launches."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    s, first = setup(B, dev)
    calls = components(s, first)
    for Bs in sweep:
        s2 = setup(Bs, dev)[0]
        calls[f"(h) full step B={Bs}"] = lambda s2=s2: s2.step(s2.warm)
    full = [name for name in calls if name.startswith(("(a)", "(h)"))]
    res = in_turns(calls, reps, dev, memory=full)
    for Bs in sweep:
        r = res[f"(h) full step B={Bs}"]
        r["solves_per_s"] = Bs * 1e3 / r["host_ms"]
    for name, fn in calls.items():
        r = res[name]
        r.update(profiled(fn, dev, ranges=name in full))
        r["dispatch_ms"] = None if r["device_busy_ms"] is None else (
            r["host_ms"] - r["device_busy_ms"])
    b, b0 = res["(b) sqp_solve_batch"], res["(b0) sqp_solve_batch without cleanup"]
    res[CLEANUP] = {k: None if b[k] is None else b[k] - b0[k]
                    for k in ("host_ms", "event_ms", "device_busy_ms", "dispatch_ms")}
    res[CLEANUP]["host_ms_se"] = float(np.hypot(b["host_ms_se"], b0["host_ms_se"]))
    for name, r in res.items():
        print(f"{name:40s} " + json.dumps(r), flush=True)
    pairs = containment(res)
    record = {"batch": B, "reps": reps, "warmup_steps": WARMUP_STEPS, "components": res,
              "containment": pairs, "unresolved": unresolved(pairs), **ident}
    if record["unresolved"]:
        print("unresolved: " + "; ".join(record["unresolved"]), flush=True)
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    print(json.dumps(main(reps=a.reps, device=a.device, out=a.out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
