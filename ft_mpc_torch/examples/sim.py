"""End-to-end demo: the closed-loop micro-orbiting MPC under thruster
faults, counterpart of `examples/sim.py`.

Loads a reactive.yaml-style configuration, builds the faulted plant and the
spiraling controller, runs the closed loop (`ft_mpc_torch.sim.env.rollout`,
or `batched_rollout` for --batch N > 1: the configuration's faults plus
N - 1 random single and double faults drawn from default_rng(seed)), and
exports the 67-column CSV.

    python -m ft_mpc_torch.examples.sim [--config path.yaml] [--batch N]
        [--no-anim] [--csv path] [--device cuda|cpu] [--cache-dir DIR]

Fault patterns whose terminal ingredients are not cached run the offline
pipeline first (`ft_mpc_torch.api`); --cache-dir puts the cache elsewhere
than the port's own.  Unless --no-anim, the first scenario's rollout is
animated (`ft_mpc_torch.viz.animate_rollout`) into sim_anim_torch.gif beside
the CSV; without matplotlib the animation is skipped.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def demo_x0() -> np.ndarray:
    """The reference demo's initial state: 1.4 m off the orbit, tumbling."""
    from scipy.spatial.transform import Rotation

    x0 = np.zeros(13)
    x0[0:3] = [1, 0, 1]
    x0[3:6] = [1, 0.5, 0]
    x0[6:10] = Rotation.from_euler("zyx", [50, 30, -10], degrees=True).as_quat()
    x0[10:13] = [0.3, 0.8, -0.1]
    return x0


def main(argv=None) -> dict:
    """Run the demo; returns the first scenario and its history, and the
    numbers printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="reactive.yaml-style config")
    ap.add_argument("--batch", type=int, default=None, help="scenario batch size")
    ap.add_argument("--no-anim", action="store_true")
    ap.add_argument("--csv", default="data/debug_data_torch.csv")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cache-dir", default=None,
                    help="terminal cache to read and fill (default: the committed "
                         "cache, then the port's own)")
    args = ap.parse_args(argv)

    from torch.utils._pytree import tree_map

    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.api import (
        DEFAULT_TUNING,
        build_scenario_with_terminal,
        cached_terminal_path,
    )
    from ft_mpc_torch.controllers.spiraling import MPCConfig, MPCWeights
    from ft_mpc_torch.geometry.scenario import stack_scenarios
    from ft_mpc_torch.ops.dynamics import BodyParams, host_array
    from ft_mpc_torch.sim.env import SimConfig, batched_rollout, rollout
    from ft_mpc_torch.sim.history import export_csv
    from ft_mpc_torch.utils.config import load_config
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_torch.utils.trajectory import (
        generate_trajectory,
        prepare_center_trajectory,
    )

    cfg_run = load_config(args.config)
    if args.batch is not None:
        cfg_run.batch = args.batch
    cfg_run.apply_debug_flags()
    device = resolve_device(args.device)
    f32 = torch.float32

    params = BodyParams.default(cfg_run.time_step, dtype=f32, device=device)
    tuning = {**DEFAULT_TUNING, **cfg_run.tuning}

    t0_faults = [f for f in cfg_run.faults if f.start_time == 0]
    later = [f for f in cfg_run.faults if f.start_time != 0]
    if later:
        print(
            f"note: {len(later)} fault(s) with start_time != 0; use the "
            "SimulationEnvironment API for mid-run injection."
        )

    patterns = [t0_faults]
    if cfg_run.batch > 1:
        rng = np.random.default_rng(cfg_run.seed)
        for _ in range(cfg_run.batch - 1):
            k = rng.integers(0, 3)
            idx = rng.choice(16, size=k, replace=False)
            patterns.append([BrokenThruster(int(i), 1.0) for i in idx])
    t_build = time.perf_counter()
    misses = 0
    scenarios = []
    for p in patterns:
        misses += cached_terminal_path(params, p, tuning, args.cache_dir) is None
        scenarios.append(build_scenario_with_terminal(
            params, p, tuning, cache_dir=args.cache_dir, device=device, dtype=f32))
    build_s = time.perf_counter() - t_build
    print(f"built {len(patterns)} scenario(s) in {build_s:.2f}s; {misses} terminal "
          "cache miss(es) computed by the offline pipeline")
    scenario = scenarios[0]
    weights = MPCWeights.from_diagonals(tuning["Q"], tuning["R"], dtype=f32, device=device)
    mpc_cfg = MPCConfig(horizon=int(tuning["horizon"]))

    traj = generate_trajectory(cfg_run.traj_shape, cfg_run.time_step, cfg_run.traj_duration)
    x_ref, u_ref = prepare_center_trajectory(
        traj, host_array(scenario.omega_des), float(host_array(params.mass)),
        cfg_run.time_step, mpc_cfg.horizon + 1,
    )
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=device)
    x0 = demo_x0()
    sim_cfg = SimConfig(steps=cfg_run.steps, noise_mode=cfg_run.noise_mode)
    gen = torch.Generator(device=device).manual_seed(cfg_run.seed)

    t_start = time.perf_counter()
    if cfg_run.batch <= 1:
        hist0 = rollout(params, scenario, weights, mpc_cfg, sim_cfg, as_t(x0),
                        as_t(x_ref), as_t(u_ref), gen)
    else:
        bank = stack_scenarios(scenarios, device=device, dtype=f32).scenarios
        hist = batched_rollout(params, bank, weights, mpc_cfg, sim_cfg,
                               as_t(np.tile(x0, (cfg_run.batch, 1))), as_t(x_ref),
                               as_t(u_ref), gen)
        hist0 = tree_map(lambda x: x[0], hist)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t_start

    B = max(cfg_run.batch, 1)
    n_solves = cfg_run.steps * B
    print(
        f"simulated {cfg_run.traj_duration}s x {B} scenario(s) "
        f"in {elapsed:.2f}s ({n_solves/elapsed:.0f} MPC solves/s) on {device.type}"
    )
    final_err = float(torch.linalg.vector_norm(hist0.c0[-1, 0:3] - hist0.x_ref0[-1, 0:3]))
    print(f"final orbit-center position error: {final_err:.4f} m")

    csv_path = Path(args.csv)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    export_csv(hist0, host_array(params.D), str(csv_path))
    print(f"history exported to {csv_path}")
    if not args.no_anim:
        anim_path = csv_path.parent / "sim_anim_torch.gif"
        try:
            from ft_mpc_torch.viz.animate import animate_rollout

            animate_rollout(hist0, scenario, save_path=str(anim_path))
            print(f"animation saved to {anim_path}")
        except ImportError as e:  # no matplotlib on this host
            print(f"animation skipped: {e}")
    return {"history": hist0, "scenario": scenario, "final_error_m": final_err,
            "elapsed_s": elapsed, "build_s": build_s, "misses": misses, "scenarios": B,
            "steps": cfg_run.steps}


if __name__ == "__main__":
    main()
