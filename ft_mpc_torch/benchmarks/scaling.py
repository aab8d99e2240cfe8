"""Batch and shard scaling of the batched control step, counterpart of
`benchmarks/scaling.py`.

Two sweeps:
  * batch sweep (`scaling.py:122-148`): the bench (`ft_mpc_torch.benchmarks.bench`)
    at B = 256, 512, 1024, 2048 and 4096 on one card, each reporting
    solves/s, ms a step (the bench's windowed p50) and max_r_prim, with the
    bench's window statistic and its FT_MPC_BENCH_WINDOWS override;
  * device sweep (`scaling.py:38-119, 169-185`): the scenario-sharded step
    (`parallel.mesh.make_scenario_mesh`, `sharded_control_step_lanes`) on
    meshes of 1, 2, 4, 8 and all cards, each shard `per_device` rows of the
    bank of healthy and the (10, 11) double fault alternating, states from
    `default_rng(0)`, ADMM 40x1 at rho 50 and clip 1.5, 3 Newton steps, no
    cleanup; `sharded_init_warmstart`, one warm-up step, then `reps`
    chained steps with x0 + 1e-4 (i + 1), timed by the host clock to a
    synchronize of every card; solves/s and the weak-scaling efficiency
    solves/s / (the first mesh's x shards / its shards).  A mesh may list a
    card twice: on one card the sweep runs 1 shard and 2 shards of cuda:0,
    which checks the sharded path, not a speed-up.

    python -m ft_mpc_torch.benchmarks.scaling [--batches 256 512 ...]
        [--devices cuda:0 cuda:0,cuda:0 ...] [--per-device 256]
        [--skip-batch-sweep] [--device cuda|cpu] [--out FILE]

Prints one line a point and the record as one JSON line, last; exits 1 when
a bench of the batch sweep fails a gate.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from ft_mpc_torch.benchmarks import bench, common

BATCHES = (256, 512, 1024, 2048, 4096)
PER_DEVICE = 256
HORIZON = 15
REPS = 5
PATTERNS = ((), (10, 11))  # the bank's two rows, alternating (scaling.py:62-67)


def config():
    """`scaling.py:69-74`: the deployed step with ADMM 40x1 and no cleanup."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    return MPCConfig(horizon=HORIZON, sqp_iters=2,
                     admm=StructuredADMMConfig(iters=40, phases=1, rho=50.0, adapt_clip=1.5),
                     newton_iters=3)


def x0_states(B: int) -> np.ndarray:
    """`scaling.py:84-87` exactly: seeded positions, identity attitude."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), np.float32)
    x0[:, 9] = 1.0
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    return x0


def inputs(B: int, device="cpu"):
    """The device sweep's inputs at B rows, whole, on `device`: `bank`,
    `params`, `weights`, `cfg`, `x0`, `x_ref`, `u_ref`."""
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiraling import MPCWeights
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.utils.faults import BrokenThruster

    f32 = torch.float32
    scs = common.build_scenarios([[BrokenThruster(i, 1.0) for i in p] for p in PATTERNS])
    s = SimpleNamespace(
        bank=common.tiled_bank(scs, B, device),
        params=BodyParams.default(common.DT, dtype=f32, device=device),
        weights=MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                          dtype=f32, device=device),
        cfg=config(), x0=torch.as_tensor(x0_states(B), device=device))
    s.x_ref, s.u_ref = common.hover_refs(HORIZON, 5.0, device)
    return s


def _sync(mesh) -> None:
    for d in set(mesh.devices):
        common.sync(d)


def run(devices, per_device: int = PER_DEVICE, reps: int = REPS) -> dict:
    """The sharded step on a mesh of `devices` (one shard each), per_device
    rows a shard: solves/s over `reps` chained steps after one warm-up step,
    ms a step, the last step's max_r_prim and the launches a step."""
    from ft_mpc_torch.ops.dynamics import robot_to_center
    from ft_mpc_torch.parallel.mesh import (
        make_scenario_mesh,
        map_shards,
        shard_scenario_batch,
        sharded_control_step_lanes,
        sharded_init_warmstart,
    )

    mesh = make_scenario_mesh(devices)
    B = per_device * mesh.size
    s = inputs(B)
    bank = shard_scenario_batch(mesh, s.bank)
    x0 = shard_scenario_batch(mesh, s.x0)
    c0 = map_shards(mesh, lambda sc, x: robot_to_center(sc.r, x), (bank, x0))
    step = lambda x, w: sharded_control_step_lanes(mesh, s.params, bank, s.weights, s.cfg,
                                                   x, s.x_ref, s.u_ref, w)
    warm = sharded_init_warmstart(mesh, s.params, bank, s.weights, s.cfg, c0, s.x_ref,
                                  s.u_ref)
    out, metrics = step(x0, warm)
    _sync(mesh)
    common.zero_counters()
    t0 = time.perf_counter()
    for i in range(reps):
        xi = map_shards(mesh, lambda x, d=1e-4 * (i + 1): x + d, (x0,))
        out, metrics = step(xi, out._replace(shards=tuple(o.warm for o in out.shards)))
    _sync(mesh)
    elapsed = (time.perf_counter() - t0) / reps
    counted = common.read_launches(reps)
    return {"devices": [str(d) for d in mesh.devices], "shards": mesh.size, "batch": B,
            "solves_per_s": B / elapsed, "ms_per_step": 1e3 * elapsed,
            "max_r_prim": float(metrics.max_r_prim), "launches_per_step":
            counted["launches_per_step"], "newton_rescues": counted["newton_rescues"]}


def default_device_lists(device) -> list[list[str]]:
    """Meshes of 1, 2, 4, 8 and all cards (`scaling.py:169-172`); on one
    card also 2 shards of it; on the CPU 1 and 2 CPU shards."""
    if device.type != "cuda":
        return [["cpu"], ["cpu", "cpu"]]
    n = torch.cuda.device_count()
    counts = sorted({d for d in (1, 2, 4, 8) if d <= n} | {n})
    lists = [[f"cuda:{i}" for i in range(c)] for c in counts]
    if n == 1:
        lists.append(["cuda:0", "cuda:0"])
    return lists


def device_sweep(device_lists, per_device: int = PER_DEVICE, reps: int = REPS) -> dict:
    """`run` on each mesh, with the weak-scaling efficiency of the JAX
    script (`scaling.py:179`) against the first."""
    rows = []
    for devices in device_lists:
        r = run(devices, per_device, reps=reps)
        base = rows[0] if rows else r
        r["efficiency"] = r["solves_per_s"] / (base["solves_per_s"] * r["shards"]
                                               / base["shards"])
        rows.append(r)
        print(f"{r['shards']} shard(s) on {r['devices']}: {r['solves_per_s']:.1f} solves/s, "
              f"{r['ms_per_step']:.3f} ms a step, weak-scaling efficiency "
              f"{r['efficiency']:.2%}", flush=True)
    return {"per_device": per_device, "reps": reps, "results": rows}


def batch_sweep(batches, device, windows: int | None = None) -> dict:
    """The bench at each B of `batches` on `device` (`scaling.py:122-148`)."""
    results = {}
    for B in batches:
        r = bench.main(B=B, device=device, windows=windows)
        results[str(B)] = {
            "solves_per_s": r["value"], "ms_per_step": r["latency_p50_ms"],
            "latency_p99_ms": r["latency_p99_ms"], "latency_windows": r["latency_windows"],
            "max_r_prim": r["max_r_prim"], "max_term_gap": r["max_term_gap"],
            "newton_rescues": r["newton_rescues"],
            "launches_per_step": r["launches_per_step"], "failed_gates": r["failed_gates"]}
        print(f"B={B:5d}: {r['value']:10.1f} solves/s ({r['latency_p50_ms']:.3f} ms/step, "
              f"max_r_prim {r['max_r_prim']:.2e})", flush=True)
    return results


def main(batches=BATCHES, devices=None, per_device: int = PER_DEVICE, reps: int = REPS,
         skip_batch_sweep: bool = False, windows: int | None = None, device=None,
         out=None) -> dict:
    """Both sweeps (`devices`: a list of device lists, default
    `default_device_lists`); returns the record (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    record = common.card_identity(dev)
    if not skip_batch_sweep:
        record["batch_sweep"] = batch_sweep(batches, dev, windows)
    record["device_sweep"] = device_sweep(devices or default_device_lists(dev), per_device,
                                          reps)
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--devices", nargs="+", default=None,
                    help="meshes, each a comma-separated device list (cuda:0,cuda:0)")
    ap.add_argument("--per-device", type=int, default=PER_DEVICE)
    ap.add_argument("--skip-batch-sweep", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    record = main(batches=a.batches, devices=a.devices and [d.split(",") for d in a.devices],
                  per_device=a.per_device, skip_batch_sweep=a.skip_batch_sweep,
                  device=a.device, out=a.out)
    print(json.dumps(record))
    failed = any(r["failed_gates"] for r in record.get("batch_sweep", {}).values())
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(cli())
