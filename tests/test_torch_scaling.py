"""The port's scaling script (`ft_mpc_torch.benchmarks.scaling`) against the
JAX package's recipe (`benchmarks/scaling.py`), on the CPU.

  * the device sweep's inputs: the bank of healthy and the (10, 11) double
    fault alternating, equal leaf for leaf to the JAX package's build; the
    seed-0 states, the hover references and the configuration: exact;
  * two CPU shards of the sharded step equal the unsharded
    `get_control_batch` on the same rows within 1e-6 N;
  * `main` on the CPU at a tiny depth (both sweeps), the default meshes,
    and without a card it refuses to run unless the CPU is asked for.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ft_mpc_torch.benchmarks import scaling
from ft_mpc_torch.convert import flatten_namedtuple
from torch_parity import np_

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_inputs_match_the_recipe(tmp_path):
    from ft_mpc_tpu.api import DEFAULT_TUNING, _build_scenario_with_terminal
    from ft_mpc_tpu.controllers.spiraling import MPCConfig
    from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
    from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_tpu.utils.faults import BrokenThruster
    from ft_mpc_tpu.utils.trajectory import generate_trajectory, prepare_center_trajectory

    B = 6
    s = scaling.inputs(B, device="cpu")
    # scaling.py:60-67, in float32 as the script runs, from a copy of the cache
    cache = tmp_path / "terminal_cache"
    shutil.copytree(REPO / "ft_mpc_tpu" / "config" / "terminal_cache", cache)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        uniq = [flatten_namedtuple(_build_scenario_with_terminal(
            JBodyParams.default(0.1), f, DEFAULT_TUNING, cache_dir=str(cache)))
            for f in [[], [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)]]]
    finally:
        jax.config.update("jax_enable_x64", x64)
    port = flatten_namedtuple(s.bank)
    assert sorted(port) == sorted(uniq[0])
    for k, v in port.items():
        want = np.stack([uniq[i % 2][k] for i in range(B)])
        np.testing.assert_array_equal(v, want.astype(v.dtype), err_msg=k)

    rng = np.random.default_rng(0)  # scaling.py:84-87
    x0 = np.zeros((B, 13), np.float32)
    x0[:, 9] = 1.0
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    np.testing.assert_array_equal(np_(s.x0), x0)

    x_ref, u_ref = prepare_center_trajectory(generate_trajectory("hover", 0.1, 5),
                                             np.array([0, 0, 0.6]), 16.8, 0.1, 16)
    np.testing.assert_array_equal(np_(s.x_ref), x_ref[:16].astype(np.float32))
    np.testing.assert_array_equal(np_(s.u_ref), u_ref[:16].astype(np.float32))

    ref = MPCConfig(horizon=15, sqp_iters=2,
                    admm=StructuredADMMConfig(iters=40, phases=1, rho=50.0, adapt_clip=1.5),
                    newton_iters=3)
    c = s.cfg
    for f in ("horizon", "sqp_iters", "newton_iters", "cleanup_iters", "cleanup_k",
              "cleanup_phases"):
        assert getattr(c, f) == getattr(ref, f), f
    for f in ("iters", "phases", "rho", "adapt_clip", "sigma", "alpha"):
        assert getattr(c.admm, f) == getattr(ref.admm, f), f


def _sharded_and_unsharded(dtype):
    """The device sweep's first step at B=8 (ADMM cut to 10 iterations) on
    two CPU shards, on each shard's rows alone and on all 8 rows unsharded."""
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiraling import (
        MPCWeights,
        get_control_batch,
        init_warmstart_batch,
    )
    from ft_mpc_torch.geometry.scenario import take_rows
    from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center
    from ft_mpc_torch.parallel.mesh import (
        make_scenario_mesh,
        map_shards,
        shard_scenario_batch,
        sharded_control_step_lanes,
        sharded_init_warmstart,
    )
    from torch_parity import to_device

    s = scaling.inputs(8, device="cpu")
    cfg = s.cfg._replace(admm=s.cfg.admm._replace(iters=10))
    bank = to_device(s.bank, "cpu", dtype)
    params = BodyParams.default(0.1, dtype=dtype, device="cpu")
    weights = MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], dtype=dtype,
                                        device="cpu")
    x0, x_ref, u_ref = (t.to(dtype) for t in (s.x0, s.x_ref, s.u_ref))
    mesh = make_scenario_mesh(["cpu", "cpu"])
    sb, sx = shard_scenario_batch(mesh, bank), shard_scenario_batch(mesh, x0)
    c0 = map_shards(mesh, lambda sc, x: robot_to_center(sc.r, x), (sb, sx))
    warm = sharded_init_warmstart(mesh, params, sb, weights, cfg, c0, x_ref, u_ref)
    _, metrics = sharded_control_step_lanes(mesh, params, sb, weights, cfg, sx, x_ref, u_ref,
                                            warm)

    def direct(rows):
        b = take_rows(bank, rows)
        w = init_warmstart_batch(params, b, weights, cfg, robot_to_center(b.r, x0[rows]), x_ref,
                                 u_ref)
        return get_control_batch(params, b, weights, cfg, x0[rows], x_ref, u_ref, w)

    own = [direct(torch.arange(lo, lo + 4)) for lo in (0, 4)]
    return metrics, own, direct(torch.arange(8))


def test_two_cpu_shards_equal_their_own_rows():
    """float32, as the script runs: each shard is `get_control_batch` on its
    rows (the rows a shard computes on a card, chip_smoke.py 9b's rule)."""
    metrics, own, _ = _sharded_and_unsharded(torch.float32)
    got = np_(metrics.u_phys.gather())
    np.testing.assert_allclose(got, np.concatenate([np_(o.u_phys) for o in own]), rtol=0,
                               atol=1e-6)
    assert float(metrics.max_r_prim) == max(float(o.info.r_prim.max()) for o in own)


def test_two_cpu_shards_equal_the_unsharded_step():
    """float64, so that no rounding of a batch-size-dependent reduction
    (float32 on this CPU: 7.7e-7 N in one row's wrench, 2.2e-4 N in its
    thrusters after the allocation) stands between the sharded step and the
    unsharded one on all 8 rows."""
    metrics, _, whole = _sharded_and_unsharded(torch.float64)
    np.testing.assert_allclose(np_(metrics.u_phys.gather()), np_(whole.u_phys), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np_(metrics.wrench.gather()), np_(whole.wrench), rtol=0,
                               atol=1e-6)
    assert float(metrics.max_r_prim) == pytest.approx(float(whole.info.r_prim.max()),
                                                      rel=1e-9)


def test_main_on_cpu(monkeypatch, tmp_path):
    """Both sweeps at a tiny depth: the bench at B=8 (one window of 2 steps),
    the device sweep on 1 and 2 CPU shards of 2 rows."""
    from ft_mpc_torch.benchmarks import bench

    for k, v in (("ITERS", "10"), ("CLEANUP", "20"), ("WINDOWS", "1")):
        monkeypatch.setenv(f"FT_MPC_BENCH_{k}", v)
    real = bench.main
    monkeypatch.setattr(bench, "main", lambda **kw: real(steps_per_window=2, **kw))
    rec = scaling.main(batches=(8,), per_device=2, reps=1, device="cpu",
                       out=tmp_path / "scaling.json")
    assert (tmp_path / "scaling.json").exists()
    b8 = rec["batch_sweep"]["8"]
    assert b8["solves_per_s"] == pytest.approx(8e3 / b8["ms_per_step"])
    assert b8["latency_windows"] == 1 and np.isfinite(b8["max_r_prim"])
    rows = rec["device_sweep"]["results"]
    assert [r["devices"] for r in rows] == [["cpu"], ["cpu", "cpu"]]
    assert [r["batch"] for r in rows] == [2, 4] and rows[0]["efficiency"] == 1.0
    r = rows[1]
    assert r["efficiency"] == pytest.approx(r["solves_per_s"] / (2 * rows[0]["solves_per_s"]))
    assert all(np.isfinite(r["max_r_prim"]) and r["ms_per_step"] > 0 for r in rows)
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["device_sweep"]["per_device"] == 2 and rec["device_sweep"]["reps"] == 1


def test_default_meshes(monkeypatch):
    assert scaling.default_device_lists(torch.device("cpu")) == [["cpu"], ["cpu", "cpu"]]
    cuda = torch.device("cuda")
    for n, want in ((1, [["cuda:0"], ["cuda:0", "cuda:0"]]),
                    (4, [["cuda:0"], ["cuda:0", "cuda:1"],
                         ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]]),
                    (3, [["cuda:0"], ["cuda:0", "cuda:1"], ["cuda:0", "cuda:1", "cuda:2"]])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        assert scaling.default_device_lists(cuda) == want


def test_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling.run(None, 2)
