"""Accuracy harness: the deployed controller configurations against a
float64 golden, counterpart of `benchmarks/accuracy.py`.

Along the golden's closed loop from the reference demo's aggressive initial
state ((10, 11) double fault, DEFAULT_TUNING, hover), three measures:
  1. same-state deviation: each deployed configuration evaluated at the
     golden's recorded states (teacher-forced, the warm start shifted to the
     next recorded state), |u_cfg(x_t) - u_gold(x_t)| per step: the
     per-scenario configuration in float64 and the lanes configuration
     (`get_control_batch` at B=1, the condensing, ADMM and allocation
     kernels on the card) in float32;
  2. closed-loop deviation of the per-scenario configuration's own rollout;
  3. the chaos floor: the golden against itself under a 1e-9 perturbation
     of the initial state (the restoration phase forks within a few steps).

Gates (the JAX harness's, constants here):
    same-state steady (steps 40+)   <= 1e-3 N (float64) / <= 2.5e-3 N (lanes float32)
    same-state steps 20-39          <= 5e-3 N / <= 2e-2 N
    closed loop steps 115-119       <= 1e-3 N
A run of fewer steps checks the gates whose steps it reaches.

    python -m ft_mpc_torch.benchmarks.accuracy [--steps N] [--device cuda|cpu] [--out FILE]
        [--float64-device cpu|cuda] [--jobs N]

The legs are independent rollouts of a launch-bound step (on an H100 a
golden step takes 25 SQP iterations of 900 eager ADMM iterations, about
8 s), so on a one-card machine the full run puts the float64 legs on the
host's cores (`--float64-device cpu --jobs 3`) and the lanes leg on the card.

Prints the summary JSON; the full record (per-step curves, the golden's states
and controls) goes only to --out.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

DT = 0.1
STEPS = 120
NT = 15
GATE_STEADY = 1e-3  # N, same-state from step STEADY_FROM, float64
GATE_STEADY_LANES = 2.5e-3  # N, the same for the lanes float32 leg
GATE_RECOVERY = 5e-3  # N, same-state steps RECOVERY[0]..RECOVERY[1]-1
GATE_RECOVERY_LANES = 2e-2
GATE_FINAL = 1e-3  # N, closed loop over FINAL (the last 5 of STEPS)
STEADY_FROM = 40
RECOVERY = (20, 40)
FINAL = (STEPS - 5, STEPS)


def configs():
    """(golden, per-scenario, lanes) MPCConfigs, as the JAX harness sets them."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    strong = StructuredADMMConfig(iters=150, phases=6, rho=1.0)
    golden = MPCConfig(horizon=NT, sqp_iters=5, admm=strong, refine_iters=20,
                       refine_tol=1e-6)
    fast = MPCConfig(
        horizon=NT, sqp_iters=2,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
        refine_iters=12, refine_tol=1e-4, refine_admm=strong,
    )
    lanes = MPCConfig(
        horizon=NT, sqp_iters=2,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
        cleanup_iters=300, cleanup_k=1, cleanup_phases=2, newton_iters=3,
        cleanup_rounds=4,
    )
    return golden, fast, lanes


def same_state_controls(params, sc, weights, cfg, states, x_ref_full, u_ref_full):
    """A configuration along a RECORDED state trajectory (teacher-forced):
    the warm start is carried and shifted toward the next recorded state, as
    a deployed controller would see this state sequence.  (T, 16) numpy."""
    from ft_mpc_torch.controllers.spiraling import get_control, init_warmstart, shift_warmstart
    from ft_mpc_torch.ops.dynamics import robot_to_center
    from ft_mpc_torch.sim.env import _window

    nxt = torch.cat([states[1:], states[-1:]])
    warm = init_warmstart(params, sc, cfg, robot_to_center(sc.r, states[0]),
                          weights=weights)
    us = []
    for i in range(states.shape[0]):
        out = get_control(params, sc, weights, cfg, states[i], _window(x_ref_full, i, NT + 1),
                          _window(u_ref_full, i, NT + 1), warm)
        warm = shift_warmstart(out.warm, robot_to_center(sc.r, nxt[i]))
        us.append(out.u_phys)
    return torch.stack(us).cpu().numpy()


def same_state_controls_lanes(params, sc, weights, cfg, states, x_ref_full, u_ref_full):
    """The batched controller (`get_control_batch`, B=1) along the recorded
    trajectory; every input in the plant's dtype.  (T, 16) numpy."""
    from torch.utils._pytree import tree_map

    from ft_mpc_torch.controllers.spiraling import (
        get_control_batch,
        init_warmstart_batch,
        shift_warmstart,
    )
    from ft_mpc_torch.ops.dynamics import robot_to_center
    from ft_mpc_torch.sim.env import _window

    bank = tree_map(lambda x: x[None], sc)
    nxt = torch.cat([states[1:], states[-1:]])
    warm = init_warmstart_batch(params, bank, weights, cfg,
                                robot_to_center(bank.r, states[:1]),
                                x_ref_full[: NT + 1], u_ref_full[: NT + 1])
    us = []
    for i in range(states.shape[0]):
        out = get_control_batch(params, bank, weights, cfg, states[i : i + 1],
                                _window(x_ref_full, i, NT + 1),
                                _window(u_ref_full, i, NT + 1), warm)
        warm = shift_warmstart(out.warm, robot_to_center(bank.r, nxt[i : i + 1]))
        us.append(out.u_phys[0])
    return torch.stack(us).cpu().numpy()


def setup(device, dtype):
    """The harness's plant, (10, 11) scenario (DEFAULT_TUNING, from the
    terminal cache, built for the plant of `dtype`), weights, references and
    initial state, on `device`."""
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.controllers.spiraling import MPCWeights
    from ft_mpc_torch.examples.sim import demo_x0
    from ft_mpc_torch.ops.dynamics import BodyParams, host_array
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    params = BodyParams.default(DT, dtype=dtype, device=device)
    sc = build_scenario_with_terminal(
        params, [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)], DEFAULT_TUNING,
        device=device, dtype=dtype,
    )
    weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                        dtype=dtype, device=device)
    traj = generate_trajectory("hover", DT, 30)
    x_ref, u_ref = prepare_center_trajectory(traj, host_array(sc.omega_des), 16.8, DT,
                                             NT + 1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return params, sc, weights, t(x_ref), t(u_ref), t(demo_x0())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gates(result: dict) -> list[str]:
    """The failed gates among those the run's step count reaches."""
    steps = result["steps"]
    dss = np.asarray(result["per_step_same_state_dev_N"])
    dln = np.asarray(result["lanes_per_step_same_state_dev_N"])
    dcl = np.asarray(result["per_step_closed_loop_dev_N"])
    failed = []
    if steps > STEADY_FROM:
        if not dss[STEADY_FROM:].max() <= GATE_STEADY:
            failed.append(f"same-state steady {dss[STEADY_FROM:].max()} > {GATE_STEADY} N")
        if not dln[STEADY_FROM:].max() <= GATE_STEADY_LANES:
            failed.append(f"lanes same-state steady {dln[STEADY_FROM:].max()} > "
                          f"{GATE_STEADY_LANES} N")
    if steps > RECOVERY[0]:
        a, b = RECOVERY
        if not dss[a:b].max() <= GATE_RECOVERY:
            failed.append(f"same-state steps {a}-{b - 1}: {dss[a:b].max()} > {GATE_RECOVERY} N")
        if not dln[a:b].max() <= GATE_RECOVERY_LANES:
            failed.append(f"lanes same-state steps {a}-{b - 1}: {dln[a:b].max()} > "
                          f"{GATE_RECOVERY_LANES} N")
    if steps >= FINAL[1]:
        a, b = FINAL
        if not dcl[a:b].max() <= GATE_FINAL:
            failed.append(f"closed loop steps {a}-{b - 1}: {dcl[a:b].max()} > {GATE_FINAL} N")
    return failed


def run_leg(leg: str, steps: int, device: str, states=None) -> dict:
    """One leg of the harness on `device`, numpy out: 'golden', 'perturbed'
    (the golden from x0 + 1e-9 e_x) and 'closed_loop' (the per-scenario
    configuration) roll the loop out; 'same_state' and 'lanes' evaluate
    their configuration along the golden's `states` (float64 (T, 13)).  The
    legs share nothing, so they may run in separate processes."""
    from torch.utils._pytree import tree_map

    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.sim.env import SimConfig, rollout

    dev = resolve_device(device)
    golden_cfg, fast_cfg, lanes_cfg = configs()
    params, sc, weights, x_ref, u_ref, x0 = setup(dev, torch.float64)
    _sync(dev)
    t0 = time.perf_counter()
    res = {}
    if leg in ("golden", "perturbed", "closed_loop"):
        if leg == "perturbed":
            x0 = x0.clone()
            x0[0] += 1e-9
        cfg = fast_cfg if leg == "closed_loop" else golden_cfg
        h = rollout(params, sc, weights, cfg, SimConfig(steps=steps, noise_mode="none"),
                    x0, x_ref, u_ref)
        res["state"] = h.state.cpu().numpy()
        res["final_pos_err_m"] = float(torch.linalg.vector_norm(h.c0[-1, 0:3]
                                                                - h.x_ref0[-1, 0:3]))
        u = h.u_phys
    elif leg == "same_state":
        u = same_state_controls(params, sc, weights, fast_cfg,
                                torch.as_tensor(states, dtype=torch.float64, device=dev),
                                x_ref, u_ref)
    elif leg == "lanes":  # the golden's scenario, plant, weights, references in float32
        f32 = lambda tree: tree_map(lambda x: x.to(torch.float32) if x is not None
                                    and x.is_floating_point() else x, tree)
        u = same_state_controls_lanes(f32(params), f32(sc), f32(weights), lanes_cfg,
                                      torch.as_tensor(states, dtype=torch.float32,
                                                      device=dev),
                                      x_ref.float(), u_ref.float())
    else:
        raise ValueError(f"unknown leg {leg!r}")
    res["u"] = np.asarray(u.cpu().numpy() if isinstance(u, torch.Tensor) else u)
    _sync(dev)
    res["step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    return res


def _legs(calls, jobs: int) -> list[dict]:
    """run_leg over `calls` ((leg, steps, device, states) tuples), in `jobs`
    spawned worker processes (one torch thread each) when jobs > 1."""
    if jobs <= 1:
        return [run_leg(*c) for c in calls]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(1,)) as pool:
        return list(pool.map(run_leg, *zip(*calls)))


def main(steps: int = STEPS, device=None, out: str | Path | None = None,
         float64_device=None, jobs: int = 1) -> dict:
    """Run the harness for `steps` steps; returns the full record with its
    failed gates under "failed_gates".  The lanes leg runs on `device`
    (default cuda), the float64 legs on `float64_device` (default
    `device`); with `jobs` > 1 the legs run in that many worker processes,
    the three rollouts at once, then the two same-state legs."""
    from ft_mpc_torch import resolve_device

    device = str(resolve_device(device))
    f64 = device if float64_device is None else str(resolve_device(float64_device))
    gold, pert, loop = _legs([("golden", steps, f64, None), ("perturbed", steps, f64, None),
                              ("closed_loop", steps, f64, None)], jobs)
    ss, lane = _legs([("same_state", steps, f64, gold["state"]),
                      ("lanes", steps, device, gold["state"])], jobs)

    u_gold = gold["u"]
    dss = np.abs(ss["u"] - u_gold)
    dss_lane = np.abs(lane["u"] - u_gold)
    du_cl = np.abs(loop["u"] - u_gold)
    steady = slice(STEADY_FROM, None)
    result = {
        "metric": f"control deviation vs float64 golden ({steps} steps, aggressive "
                  "reference-demo initial state)",
        "steps": steps,
        "device": device,
        "float64_device": f64,
        "jobs": jobs,
        "same_state_max_dev_N": float(dss.max()),
        "same_state_steady_dev_N": float(dss[steady].max()) if steps > STEADY_FROM else None,
        "same_state_mean_dev_N": float(dss.mean()),
        "lanes_same_state_max_dev_N": float(dss_lane.max()),
        "lanes_same_state_steady_dev_N": (float(dss_lane[steady].max())
                                          if steps > STEADY_FROM else None),
        "per_step_same_state_dev_N": [float(v) for v in dss.max(axis=1)],
        "lanes_per_step_same_state_dev_N": [float(v) for v in dss_lane.max(axis=1)],
        "closed_loop_max_dev_N": float(du_cl.max()),
        "closed_loop_final5_dev_N": float(du_cl[-5:].max()),
        "per_step_closed_loop_dev_N": [float(v) for v in du_cl.max(axis=1)],
        "per_step_golden_state": gold["state"].tolist(),
        "per_step_golden_u_phys": u_gold.tolist(),
        "chaos_floor_N": float(np.abs(pert["u"] - u_gold).max()),
        "final_pos_err_fast_m": loop["final_pos_err_m"],
        "final_pos_err_golden_m": gold["final_pos_err_m"],
        "golden_step_ms": gold["step_ms"],
        "fast_step_ms": loop["step_ms"],
        "same_state_step_ms": ss["step_ms"],
        "lanes_step_ms": lane["step_ms"],
    }
    result["failed_gates"] = gates(result)
    print(json.dumps({k: v for k, v in result.items() if not k.startswith(
        ("per_step", "lanes_per_step"))}, indent=2))
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1) + "\n")
    return result


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the full record (JSON) here")
    ap.add_argument("--float64-device", default=None,
                    help="device of the float64 legs (default: --device)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the legs (default 1: in turn)")
    args = ap.parse_args(argv)
    result = main(args.steps, args.device, args.out, args.float64_device, args.jobs)
    if result["failed_gates"]:
        print("accuracy gates FAILED: " + "; ".join(result["failed_gates"]))
        return 1
    print(f"accuracy gates ok ({args.steps} steps; chaos floor "
          f"{result['chaos_floor_N']:.3f} N)")
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
