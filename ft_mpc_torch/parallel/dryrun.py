"""Multi-shard dry run of the scenario-sharded control step, counterpart of
`__graft_entry__.py:dryrun_multichip`.

`dryrun_multichip(n_shards, device)` builds a mesh of `n_shards` shards on
`device` (a device may carry several shards) and runs the JAX dry run's
three legs on tiny shapes (horizon 5, B = 2 n, ADMM 120 x 2, no cleanup),
float32:
  * lanes: the sharded `get_control_batch` equals the unsharded one at
    atol 2e-3 on u_phys and wrench;
  * per-scenario: `sharded_control_step`'s mean cost agrees with the lanes
    leg's to 1e-3 relative, and both legs' max_term_gap are <= 1e-3;
  * box and rate rows (x_ub[3:6] = 0.5, du_max = 5): sharded equals
    unsharded at atol 2e-3.
A failed leg raises AssertionError.

`entry(device)`, counterpart of `__graft_entry__.py:entry`, returns the
single-scenario control step and its example arguments: `fn(x0, warm)`
gives (u_phys, wrench, cost) of `get_control` on the (10, 11) double fault
at horizon 8 (2 SQP iterations, ADMM 10 x 2 at rho 1), `example_args` is
(x0, `init_warmstart`) on the device.  It runs eagerly, as the port's
other entry points do.

    python -m ft_mpc_torch.parallel.dryrun [N] [--device cuda|cpu]
    python -m ft_mpc_torch.parallel.dryrun --entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _setup(device, horizon=8, sqp_iters=2, admm_iters=10, admm_phases=2,
           dtype=torch.float32):
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.controllers.spiraling import MPCConfig, MPCWeights
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_torch.utils.trajectory import (
        generate_trajectory,
        prepare_center_trajectory,
    )

    dt = 0.1
    # the float32 plant keys the committed terminal cache, whatever dtype runs
    plant = BodyParams.default(dt, dtype=torch.float32, device=device)
    scenario = build_scenario_with_terminal(
        plant, [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)], DEFAULT_TUNING,
        device=device, dtype=dtype,
    )
    params = BodyParams.default(dt, dtype=dtype, device=device)
    weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                        dtype=dtype, device=device)
    cfg = MPCConfig(
        horizon=horizon,
        sqp_iters=sqp_iters,
        admm=StructuredADMMConfig(iters=admm_iters, phases=admm_phases, rho=1.0),
    )
    traj = generate_trajectory("hover", dt, 5)
    x_ref, u_ref = prepare_center_trajectory(
        traj, np.array([0.0, 0.0, 0.6]), 16.8, dt, horizon + 1
    )
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    x0 = np.zeros(13)
    x0[0:3] = [0.5, 0.2, -0.3]
    x0[3:6] = [0.1, 0.0, 0.05]
    x0[9] = 1.0
    x0[10:13] = [0.0, 0.0, 0.3]
    return params, scenario, weights, cfg, t(x0), t(x_ref[: horizon + 1]), t(u_ref[: horizon + 1])


def entry(device=None, dtype=torch.float32):
    """(fn, example_args): the single-scenario control step and its
    arguments on `device` (default cuda), `__graft_entry__.py:63-75`."""
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.controllers.spiraling import get_control, init_warmstart
    from ft_mpc_torch.ops.dynamics import robot_to_center

    dev = resolve_device(device)
    params, scenario, weights, cfg, x0, x_ref, u_ref = _setup(dev, dtype=dtype)
    warm = init_warmstart(params, scenario, cfg, robot_to_center(scenario.r, x0))

    def forward(x0, warm):
        out = get_control(params, scenario, weights, cfg, x0, x_ref, u_ref, warm)
        return out.u_phys, out.wrench, out.info.cost

    return forward, (x0, warm)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Scenario-sharded batched control steps on an `n_shards` mesh of
    `device` (default cuda); returns the legs' numbers."""
    from torch.utils._pytree import tree_map

    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.controllers.spiraling import (
        get_control_batch,
        init_warmstart,
        init_warmstart_batch,
    )
    from ft_mpc_torch.ops.dynamics import robot_to_center
    from ft_mpc_torch.parallel.mesh import (
        make_scenario_mesh,
        shard_scenario_batch,
        sharded_control_step,
        sharded_control_step_lanes,
    )

    dev = resolve_device(device)
    mesh = make_scenario_mesh([dev] * n_shards)
    dev = mesh.devices[0]
    # Convergent budget: 120 ADMM iterations x 2 phases at horizon 5 bring
    # the QP residual to the 1e-3 class on these states, so the checks
    # below have teeth.
    params, scenario, weights, cfg, x0, x_ref, u_ref = _setup(
        dev, horizon=5, sqp_iters=2, admm_iters=120, admm_phases=2
    )
    B = 2 * n_shards
    scenarios = tree_map(lambda x: x.expand((B,) + x.shape).contiguous(), scenario)
    x0s = x0.expand(B, 13) + torch.linspace(0, 0.01, B, dtype=x0.dtype,
                                            device=dev)[:, None]

    # --- deployed path: the batched backend (kernels on a card), sharded
    c0s = robot_to_center(scenarios.r, x0s)
    warms_b = init_warmstart_batch(params, scenarios, weights, cfg, c0s, x_ref, u_ref)
    sc_sh = shard_scenario_batch(mesh, scenarios)
    x0_sh = shard_scenario_batch(mesh, x0s)
    _, metrics_l = sharded_control_step_lanes(
        mesh, params, sc_sh, weights, cfg, x0_sh, x_ref, u_ref,
        shard_scenario_batch(mesh, warms_b),
    )
    u_l = metrics_l.u_phys.gather(dev)
    _check(u_l.shape == (B, 16) and bool(torch.isfinite(u_l).all()),
           f"sharded lanes step: u_phys {tuple(u_l.shape)}, finite "
           f"{bool(torch.isfinite(u_l).all())}")

    # Sharded == unsharded: the same batched call on the whole batch.  The
    # Newton-metric rescue predicate is batch-global, so shards may take
    # the exact factorization where the whole batch refreshed: solutions
    # then agree to ADMM tolerance; a sharding bug (wrong rows, garbled
    # reductions) shows up at O(1) N.
    out_ref = get_control_batch(params, scenarios, weights, cfg, x0s, x_ref, u_ref,
                                warms_b)
    err_lanes = max(float((u_l - out_ref.u_phys).abs().max()),
                    float((metrics_l.wrench.gather(dev) - out_ref.wrench).abs().max()))
    np.testing.assert_allclose(
        u_l.cpu().numpy(), out_ref.u_phys.cpu().numpy(), rtol=0, atol=2e-3,
        err_msg="sharded lanes step != unsharded batched step",
    )
    np.testing.assert_allclose(
        metrics_l.wrench.gather(dev).cpu().numpy(), out_ref.wrench.cpu().numpy(),
        rtol=0, atol=2e-3,
    )

    # --- per-scenario path, sharded (get_control_rows on every shard)
    warms = init_warmstart(params, scenarios, cfg, c0s)
    _, metrics = sharded_control_step(
        mesh, params, sc_sh, weights, cfg, x0_sh, x_ref, u_ref,
        shard_scenario_batch(mesh, warms),
    )
    u = metrics.u_phys.gather(dev)
    _check(u.shape == (B, 16) and bool(torch.isfinite(u).all()),
           f"sharded per-scenario step: u_phys {tuple(u.shape)}, finite "
           f"{bool(torch.isfinite(u).all())}")

    # Both backends solve the same QPs: at this convergent budget their
    # mean costs agree.
    mc_l, mc_x = float(metrics_l.mean_cost), float(metrics.mean_cost)
    _check(abs(mc_l - mc_x) <= 1e-3 * max(1.0, abs(mc_x)),
           f"lanes mean_cost {mc_l} vs per-scenario mean_cost {mc_x}")
    # Elastic terminal rows must not be silently absorbing a constraint
    # violation on these (feasible, certified) scenarios.
    for name, m in (("lanes", metrics_l), ("per-scenario", metrics)):
        gap = float(m.max_term_gap)
        _check(gap <= 1e-3, f"{name} max_term_gap {gap:.2e} > 1e-3")

    # --- stage-constraint rows under sharding: the state box and wrench
    # rate rows enlarge the dense terminal block and the warm dual vector.
    xub = np.full(13, 1e8)
    xub[3:6] = 0.5  # mild velocity box (feasible at these states)
    weights_box = weights._replace(
        x_ub=torch.as_tensor(xub, dtype=x_ref.dtype, device=dev),
        du_max=torch.full((6,), 5.0, dtype=x_ref.dtype, device=dev),
    )
    warms_box = init_warmstart_batch(params, scenarios, weights_box, cfg, c0s, x_ref, u_ref)
    out_box_ref = get_control_batch(params, scenarios, weights_box, cfg, x0s, x_ref, u_ref,
                                    warms_box)
    _, metrics_box = sharded_control_step_lanes(
        mesh, params, sc_sh, weights_box, cfg, x0_sh, x_ref, u_ref,
        shard_scenario_batch(mesh, warms_box),
    )
    u_box = metrics_box.u_phys.gather(dev)
    _check(bool(torch.isfinite(u_box).all()), "sharded boxed step is not finite")
    err_box = float((u_box - out_box_ref.u_phys).abs().max())
    np.testing.assert_allclose(
        u_box.cpu().numpy(), out_box_ref.u_phys.cpu().numpy(), rtol=0, atol=2e-3,
        err_msg="sharded boxed step != unsharded boxed step",
    )
    res = {
        "shards": n_shards, "device": str(dev), "B": B,
        "lanes_mean_cost": mc_l, "lanes_max_r_prim": float(metrics_l.max_r_prim),
        "per_scenario_mean_cost": mc_x, "per_scenario_max_r_prim": float(metrics.max_r_prim),
        "max_term_gap": max(float(metrics_l.max_term_gap), float(metrics.max_term_gap)),
        "lanes_vs_unsharded": err_lanes, "box_vs_unsharded": err_box,
    }
    print(
        f"dryrun_multichip ok: {n_shards} shards on {dev}, "
        f"lanes mean_cost={mc_l:.4f} max_r_prim={res['lanes_max_r_prim']:.2e}; "
        f"per-scenario mean_cost={mc_x:.4f} max_r_prim={res['per_scenario_max_r_prim']:.2e}; "
        f"sharded==unsharded atol 2e-3 (plain {err_lanes:.2e}, state-box/rate rows "
        f"{err_box:.2e}), lanes-vs-per-scenario cost rtol<=1e-3"
    )
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--entry", action="store_true",
                    help="run entry()'s step once and print its output shapes")
    a = ap.parse_args()
    if a.entry:
        fn, args = entry(a.device)
        out = fn(*args)
        print("entry ok:", [list(o.shape) for o in out[:2]])
    else:
        dryrun_multichip(a.n_shards, a.device)
