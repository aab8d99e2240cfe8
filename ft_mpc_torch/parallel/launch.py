"""Multi-process launch of the scenario-sharded control step (one process
per host or per card), counterpart of `ft_mpc_tpu/parallel/launch.py`.

Each process builds ONLY its own rows of the global scenario bank (healthy
and the (10, 11) double fault alternating row by row, DEFAULT_TUNING, from
the terminal cache on the float32 plant), shards them over its devices, and
every step runs the deployed batched backend (`get_control_batch`) on each
shard, with the scalar metrics all-reduced over the processes.  Rank 0
prints one JSON line: processes, devices (the number of shards over every
process), global_batch, solves_per_s, mean_cost, max_r_prim, max_term_gap.

    # process 0                                 # process 1
    python -m ft_mpc_torch.parallel.launch \\    python -m ft_mpc_torch.parallel.launch \\
        --coordinator host0:1234 \\                 --coordinator host0:1234 \\
        --num-processes 2 --process-id 0            --num-processes 2 --process-id 1

Devices: this process's card (`cuda:{LOCAL_RANK}`) unless `--devices`
lists others (`cuda:0,cuda:0` runs two shards on one card) or
`--cpu-devices N` asks for N CPU shards.  Backend: 'nccl' on a CUDA mesh,
'gloo' on a CPU mesh, unless `--backend` names one; NCCL needs a card per
rank, so two processes that share a card need `--backend gloo`.  With no
coordinator the run is a single process on its local devices.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--per-device", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=15)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--admm-iters", type=int, default=40)
    ap.add_argument("--admm-phases", type=int, default=1)
    ap.add_argument(
        "--cpu-devices", type=int, default=None,
        help="N CPU shards per process (multi-process CPU runs; gloo collectives)",
    )
    ap.add_argument(
        "--devices", default=None,
        help="comma-separated devices of this process, e.g. cuda:0,cuda:0 "
        "(default: this process's card)",
    )
    ap.add_argument(
        "--backend", default=None, choices=("nccl", "gloo"),
        help="torch.distributed backend (default: nccl on a CUDA mesh, gloo on a "
        "CPU mesh); processes sharing a card need gloo",
    )
    ap.add_argument(
        "--dump", default=None,
        help="process 0 writes the globally-gathered u_phys/wrench and metrics "
        "to this .npz (cross-configuration equality checks)",
    )
    args = ap.parse_args(argv)
    if args.cpu_devices and args.devices:
        ap.error("--cpu-devices and --devices exclude each other")
    if args.cpu_devices and args.backend == "nccl":
        ap.error("nccl needs a CUDA mesh; --cpu-devices runs on gloo")
    return args


def main(argv=None) -> dict | None:
    """Run the launch; rank 0 prints (and returns) the JSON line."""
    args = _parse(argv)
    import torch.distributed as dist

    import ft_mpc_torch
    from ft_mpc_torch.parallel.distributed import (
        initialize_distributed,
        make_host_scenario_mesh,
    )

    if args.cpu_devices:
        devices = ["cpu"] * args.cpu_devices
    elif args.devices:
        devices = args.devices.split(",")
    else:
        devices = None
    mesh = make_host_scenario_mesh(devices)
    dev0 = mesh.devices[0]
    backend = args.backend or ("nccl" if dev0.type == "cuda" else "gloo")
    if dev0.type == "cuda":
        torch.cuda.set_device(dev0)
    ft_mpc_torch.pin_fp32_matmuls()
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           backend=backend)
    try:
        return _run(args, mesh, dev0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, mesh, dev0) -> dict | None:
    from torch.utils._pytree import tree_map

    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.controllers.spiraling import MPCConfig, MPCWeights
    from ft_mpc_torch.geometry.scenario import take_rows
    from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center
    from ft_mpc_torch.parallel.distributed import (
        global_scenario_array,
        global_shard_count,
        local_scenario_range,
        process_allgather,
        process_count,
        process_index,
    )
    from ft_mpc_torch.parallel.mesh import (
        map_shards,
        sharded_control_step_lanes,
        sharded_init_warmstart,
    )
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_torch.utils.trajectory import (
        generate_trajectory,
        prepare_center_trajectory,
    )

    f32 = torch.float32
    cpu = torch.device("cpu")
    n_shards = global_shard_count(mesh)
    B = args.per_device * n_shards
    lo, hi = local_scenario_range(B)

    dt = 0.1
    params = BodyParams.default(dt, dtype=f32, device=cpu)
    # Two geometries (healthy + the reference's double fault), alternating;
    # each process materializes only rows [lo, hi) of the global bank.
    uniq = [
        build_scenario_with_terminal(params, f, DEFAULT_TUNING, device=cpu, dtype=f32)
        for f in [[], [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)]]
    ]
    pair = tree_map(lambda *xs: torch.stack(xs), *uniq)
    bank_local = take_rows(pair, torch.arange(lo, hi) % 2)

    rng = np.random.default_rng(0)
    x0_g = np.zeros((B, 13), np.float32)
    x0_g[:, 9] = 1.0
    x0_g[:, 0:3] = rng.uniform(-1, 1, (B, 3))

    scenarios = global_scenario_array(mesh, bank_local)
    x0 = global_scenario_array(mesh, torch.from_numpy(x0_g[lo:hi]))

    weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                        dtype=f32, device=cpu)
    cfg = MPCConfig(
        horizon=args.horizon, sqp_iters=args.sqp_iters,
        admm=StructuredADMMConfig(
            iters=args.admm_iters, phases=args.admm_phases,
            rho=50.0, adapt_clip=1.5,
        ),
        newton_iters=3,
    )
    traj = generate_trajectory("hover", dt, 5)
    x_ref, u_ref = prepare_center_trajectory(
        traj, np.array([0, 0, 0.6]), 16.8, dt, args.horizon + 1
    )
    x_ref = torch.as_tensor(x_ref[: args.horizon + 1], dtype=f32)
    u_ref = torch.as_tensor(u_ref[: args.horizon + 1], dtype=f32)

    c0 = map_shards(mesh, lambda sc, x: robot_to_center(sc.r, x), (scenarios, x0))
    warm = sharded_init_warmstart(mesh, params, scenarios, weights, cfg, c0, x_ref, u_ref)

    def sync():
        for d in set(mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    out, metrics = sharded_control_step_lanes(
        mesh, params, scenarios, weights, cfg, x0, x_ref, u_ref, warm
    )
    sync()

    t0 = time.perf_counter()
    w = out._replace(shards=tuple(o.warm for o in out.shards))
    for _ in range(args.reps):
        out, metrics = sharded_control_step_lanes(
            mesh, params, scenarios, weights, cfg, x0, x_ref, u_ref, w
        )
        w = out._replace(shards=tuple(o.warm for o in out.shards))
    float(metrics.mean_cost)  # waits for the last step on every shard
    sync()
    elapsed = (time.perf_counter() - t0) / args.reps

    if args.dump:
        # Gather the full sharded outputs onto every process; process 0
        # writes them so a test can assert 2-process == 1-process.
        u_phys_g = process_allgather(metrics.u_phys.gather(dev0))
        wrench_g = process_allgather(metrics.wrench.gather(dev0))
        if process_index() == 0:
            np.savez(
                args.dump,
                u_phys=u_phys_g.cpu().numpy(),
                wrench=wrench_g.cpu().numpy(),
                mean_cost=float(metrics.mean_cost),
                max_r_prim=float(metrics.max_r_prim),
                max_term_gap=float(metrics.max_term_gap),
            )

    if process_index() != 0:
        return None
    line = {
        "processes": process_count(),
        "devices": n_shards,
        "global_batch": B,
        "solves_per_s": round(B / elapsed, 1),
        "mean_cost": float(metrics.mean_cost),
        "max_r_prim": float(metrics.max_r_prim),
        "max_term_gap": float(metrics.max_term_gap),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
