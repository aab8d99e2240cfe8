"""Scenario sharding of ft_mpc_torch (`parallel/mesh.py`, `parallel/dryrun.py`)
against the JAX package and against the port's unsharded functions.

The port's mesh is a list of devices, and a device may repeat: `["cpu"] * 8`
stands in for the JAX suite's 8 virtual CPU devices.  The bank, states and
configuration are `tests/test_parallel.py`'s (healthy and the single faults
1-7, DEFAULT_TUNING, the float64 plant), the bank built by the port from the
committed terminal cache and handed to both packages as the same numpy
leaves:
  * the sharded lanes step against the JAX one on its 8 devices (x64 around
    its float32 Pallas kernels in interpret mode; the JAX side takes the
    port's warm start): u_phys and wrench at 2e-2, the lanes class of
    `tests/test_lanes.py:175-178`;
  * sharded against unsharded in the port at 5e-3 (the rescue predicate is
    batch-global), each shard against `get_control_batch` on its own rows
    at 1e-12, and the metrics against the reductions of the outputs;
  * `sharded_rollout` against `batched_rollout` with no noise at 1e-8;
  * `sharded_control_step`'s mean cost against the JAX one at rtol 1e-3;
  * the mesh's contracts (CUDA by default, even shards, each shard's call
    in its device's context) and `dryrun_multichip(2, device="cpu")`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.geometry.scenario import stack_scenarios, take_rows
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.parallel import mesh as tmesh
from ft_mpc_torch.parallel.dryrun import dryrun_multichip
from ft_mpc_torch.sim import env as tenv
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig as TCfg
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_torch.utils.faults import BrokenThruster
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.parallel import mesh as jmesh
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from torch_parity import F64, jax_bank, np_, t64

torch.set_num_threads(1)

DT = 0.1
B = 8
Q, R = DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"]
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def flat():
    """tests/test_parallel.py's bank: healthy, then single fault i (i < 8),
    built by the port on the float64 plant (every entry is in the committed
    cache, which is only read)."""
    plant = TBodyParams.default(DT, dtype=F64, device="cpu")
    scs = [build_scenario_with_terminal(plant, [] if i == 0 else [BrokenThruster(i, 1.0)],
                                        DEFAULT_TUNING, device="cpu", dtype=F64)
           for i in range(B)]
    return flatten_namedtuple(stack_scenarios(scs, device="cpu", dtype=F64).scenarios)


def _refs(horizon, rows=None):
    traj = ttraj.generate_trajectory("hover", DT, 5)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   DT, rows or horizon + 1)
    return x_ref[: rows or horizon + 1], u_ref[: rows or horizon + 1]


def _port():
    return (TBodyParams.default(DT, dtype=F64, device="cpu"),
            tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu"))


@pytest.fixture(scope="module")
def lanes(flat):
    """tests/test_parallel.py:100-168: the port's sharded lanes step on
    ["cpu"] * 8, the unsharded step and each shard's own step."""
    cfg_kw = dict(horizon=6, sqp_iters=2)
    admm = dict(iters=20, phases=1, rho=50.0, adapt_clip=1.5)
    x_ref, u_ref = _refs(cfg_kw["horizon"])
    rng = np.random.default_rng(3)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.2, 0.2, (B, 3))
    x0[:, 9] = 1.0
    x0[:, 12] = 0.5

    params, weights = _port()
    cfg = tsp.MPCConfig(admm=TCfg(**admm), **cfg_kw)
    bank = _bank(flat)
    c0 = tsp.robot_to_center(bank.r, t64(x0))
    warm = tsp.init_warmstart_batch(params, bank, weights, cfg, c0, t64(x_ref), t64(u_ref))
    mesh = tmesh.make_scenario_mesh(CPU8)
    out_sh, metrics = tmesh.sharded_control_step_lanes(
        mesh, params, tmesh.shard_scenario_batch(mesh, bank), weights, cfg,
        tmesh.shard_scenario_batch(mesh, t64(x0)), t64(x_ref), t64(u_ref),
        tmesh.shard_scenario_batch(mesh, warm),
    )
    ref = tsp.get_control_batch(params, bank, weights, cfg, t64(x0), t64(x_ref),
                                t64(u_ref), warm)
    own = [tsp.get_control_batch(params, take_rows(bank, [i]), weights, cfg,
                                 t64(x0[i:i + 1]), t64(x_ref), t64(u_ref),
                                 tsp._rows(warm, [i]))
           for i in range(B)]
    return dict(x0=x0, x_ref=x_ref, u_ref=u_ref, cfg_kw=cfg_kw, admm=admm, warm=warm,
                out=out_sh, metrics=metrics, ref=ref, own=own)


def _bank(flat):
    from ft_mpc_torch.convert import scenario_from_numpy

    return scenario_from_numpy(flat, device="cpu", dtype=F64)


def test_sharded_lanes_step_matches_jax(flat, lanes):
    jmesh_ = jmesh.make_scenario_mesh()
    assert len(jmesh_.devices.ravel()) == 8
    warm = jsp.WarmStart(*(jnp.asarray(np_(x)) for x in lanes["warm"]))
    _, jm = jmesh.sharded_control_step_lanes(
        jmesh_, JBodyParams.default(DT),
        jmesh.shard_scenario_batch(jmesh_, jax_bank(flat)),
        jsp.MPCWeights.from_diagonals(Q, R), jsp.MPCConfig(admm=JCfg(**lanes["admm"]),
                                                           **lanes["cfg_kw"]),
        jmesh.shard_scenario_batch(jmesh_, jnp.asarray(lanes["x0"])),
        jnp.asarray(lanes["x_ref"]), jnp.asarray(lanes["u_ref"]),
        jmesh.shard_scenario_batch(jmesh_, warm),
    )
    m = lanes["metrics"]
    np.testing.assert_allclose(np_(m.u_phys.gather()), np.asarray(jm.u_phys), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(np_(m.wrench.gather()), np.asarray(jm.wrench), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(float(m.mean_cost), float(jm.mean_cost), rtol=1e-3)


def test_sharded_lanes_step_matches_unsharded(lanes):
    """Not bit for bit: the rescue predicate is batch-global, so a shard may
    pick the exact factorization where the whole batch refreshed."""
    m, ref = lanes["metrics"], lanes["ref"]
    assert m.u_phys.gather().shape == (B, 16)
    np.testing.assert_allclose(np_(m.u_phys.gather()), np_(ref.u_phys), rtol=0, atol=5e-3)
    np.testing.assert_allclose(np_(m.wrench.gather()), np_(ref.wrench), rtol=0, atol=5e-3)


def test_each_shard_equals_its_own_batched_step(lanes):
    out = lanes["out"]
    assert len(out.shards) == 8 and out.global_batch == B
    for shard, own in zip(out.shards, lanes["own"]):
        for name in ("u_phys", "wrench"):
            np.testing.assert_allclose(np_(getattr(shard, name)), np_(getattr(own, name)),
                                       rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(np_(shard.warm.X), np_(own.warm.X), rtol=0, atol=1e-12)


def test_step_metrics_are_the_jax_reductions(lanes):
    """pmean of the shards' means, pmax of r_prim and term_gap."""
    out, m = lanes["out"], lanes["metrics"]
    cost = np.stack([np_(s.info.cost) for s in out.shards])
    assert float(m.mean_cost) == pytest.approx(cost.mean(axis=1).mean(), rel=1e-12)
    assert float(m.max_r_prim) == max(float(s.info.r_prim.max()) for s in out.shards)
    assert float(m.max_term_gap) == max(float(s.info.term_gap.max()) for s in out.shards)
    np.testing.assert_array_equal(np_(m.u_phys.gather()),
                                  np.concatenate([np_(s.u_phys) for s in out.shards]))


def test_sharded_rollout_matches_batched_rollout(flat):
    """tests/test_parallel.py:61-96 on the port: 5 steps, no noise."""
    params, weights = _port()
    cfg = tsp.MPCConfig(horizon=8, sqp_iters=2)
    sim_cfg = tenv.SimConfig(steps=5, noise_mode="none")
    x_ref, u_ref = _refs(8, rows=10)
    x0 = np.zeros((B, 13))
    x0[:, 9] = 1.0
    x0[:, 2] = np.linspace(-0.5, 0.5, B)
    bank = _bank(flat)
    mesh = tmesh.make_scenario_mesh(["cpu"] * 4)
    hist = tmesh.sharded_rollout(
        mesh, params, tmesh.shard_scenario_batch(mesh, bank), weights, cfg, sim_cfg,
        tmesh.shard_scenario_batch(mesh, t64(x0)), t64(x_ref), t64(u_ref),
    ).gather()
    local = tenv.batched_rollout(params, bank, weights, cfg, sim_cfg, t64(x0), t64(x_ref),
                                 t64(u_ref))
    assert hist.state.shape == (B, 5, 13)
    np.testing.assert_allclose(np_(hist.state), np_(local.state), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np_(hist.u_phys), np_(local.u_phys), rtol=0, atol=1e-8)


def test_sharded_control_step_mean_cost_matches_jax(flat):
    """tests/test_parallel.py:28-58: the per-scenario path, sharded; the
    port on ["cpu"] * 8 against the JAX package on its 8 devices."""
    cfg_kw = dict(horizon=8, sqp_iters=2)
    x_ref, u_ref = _refs(8)
    x0 = np.zeros((B, 13))
    x0[:, 9] = 1.0
    x0[:, 0] = np.linspace(0.1, 0.8, B)

    jp = JBodyParams.default(DT)
    jm_ = jmesh.make_scenario_mesh()
    jb = jmesh.shard_scenario_batch(jm_, jax_bank(flat))
    jx0 = jmesh.shard_scenario_batch(jm_, jnp.asarray(x0))
    jcfg = jsp.MPCConfig(**cfg_kw)
    jwarm = jax.vmap(lambda sc, x: jsp.init_warmstart(
        jp, sc, jcfg, jsp.robot_to_center(sc.r, x)))(jb, jx0)
    _, jmet = jmesh.sharded_control_step(jm_, jp, jb, jsp.MPCWeights.from_diagonals(Q, R),
                                         jcfg, jx0, jnp.asarray(x_ref), jnp.asarray(u_ref),
                                         jwarm)

    params, weights = _port()
    cfg = tsp.MPCConfig(**cfg_kw)
    mesh = tmesh.make_scenario_mesh(CPU8)
    bank = _bank(flat)
    warm = tsp.init_warmstart(params, bank, cfg, tsp.robot_to_center(bank.r, t64(x0)))
    _, met = tmesh.sharded_control_step(mesh, params, bank, weights, cfg, t64(x0),
                                        t64(x_ref), t64(u_ref), warm)
    u = met.u_phys.gather()
    assert u.shape == (B, 16) and bool(torch.isfinite(u).all())
    assert [s.device.type for s in met.u_phys.shards] == ["cpu"] * 8
    assert float(met.mean_cost) > 0
    np.testing.assert_allclose(float(met.mean_cost), float(jmet.mean_cost), rtol=1e-3)
    np.testing.assert_allclose(float(met.max_term_gap), float(jmet.max_term_gap), atol=1e-6)


def test_make_scenario_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_scenario_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_scenario_mesh(["cuda:0"])
    mesh = tmesh.make_scenario_mesh(CPU8)
    assert mesh.size == 8 and mesh.axis_name == tmesh.SCENARIO_AXIS == "scenario"
    assert mesh.devices == (torch.device("cpu"),) * 8


def test_uneven_batch_raises():
    mesh = tmesh.make_scenario_mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_scenario_batch(mesh, torch.zeros(8, 13))
    sh = tmesh.shard_scenario_batch(mesh, torch.arange(12.0)[:, None])
    assert [s[:, 0].tolist() for s in sh.shards] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                     [8, 9, 10, 11]]
    assert torch.equal(sh.gather(), torch.arange(12.0)[:, None])


def test_each_shard_runs_in_its_device_context(monkeypatch):
    """Kernels launch on the current CUDA device, so each shard's call must
    run inside its own device's context: a spy records, for every call of
    the shard function, the device whose context is open."""
    active, seen = [], []

    class Spy:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            active.append(self.dev)

        def __exit__(self, *exc):
            active.pop()

    monkeypatch.setattr(tmesh, "_device_context", Spy)
    mesh = tmesh.ScenarioMesh(devices=(torch.device("cpu"),) * 4)

    def fn(x, w):
        seen.append((tuple(active), x.device, float(x[0])))
        return x + w

    out = tmesh.map_shards(mesh, fn, (torch.arange(8.0),), (torch.ones(()),))
    assert [a for a, _, _ in seen] == [(torch.device("cpu"),)] * 4
    assert [first for _, _, first in seen] == [0.0, 2.0, 4.0, 6.0]
    assert torch.equal(out.gather(), torch.arange(8.0) + 1)
    # a CUDA shard's context is torch.cuda.device of its card (built, not entered)
    monkeypatch.undo()
    cuda_ctx = tmesh._device_context(torch.device("cuda", 1))
    assert isinstance(cuda_ctx, torch.cuda.device) and cuda_ctx.idx == 1


def test_rollout_generators_one_per_shard():
    mesh = tmesh.make_scenario_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="generators"):
        tmesh.sharded_rollout_lanes(mesh, None, None, None, None, None, None, None, None,
                                    generators=[torch.Generator()])


def test_dryrun_multichip_cpu():
    res = dryrun_multichip(2, device="cpu")
    assert res["shards"] == 2 and res["B"] == 4
    assert res["lanes_vs_unsharded"] <= 2e-3 and res["box_vs_unsharded"] <= 2e-3
    assert res["max_term_gap"] <= 1e-3
    assert abs(res["lanes_mean_cost"] - res["per_scenario_mean_cost"]) <= 1e-3 * max(
        1.0, abs(res["per_scenario_mean_cost"]))
