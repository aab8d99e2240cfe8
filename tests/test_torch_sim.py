"""The closed loop of ft_mpc_torch (`sim/env.py`, `sim/history.py`) vs the
JAX package.

The same numpy inputs go through `ft_mpc_tpu.sim` (x64) and the port on the
CPU.  The closed loop is chaotic: a 1e-9 perturbation of the golden forks it
by 0.1 N (ACCURACY_r05.json), so loops are compared step by step from the
same state, or over the few steps before rounding differences grow:
  * `rollout` from the demo's initial state (quadratic terminal), 10 steps:
    at every step the port's `get_control` takes the JAX loop's state and
    warm start; u_phys, wrench, warm start and diagnostics at 1e-6, the
    port's transition (plant, renormalization, `shift_warmstart`) at 1e-12;
    the port's own `rollout` follows the JAX loop at 1e-6 for 4 steps;
  * `batched_rollout` on healthy + the (10, 11) double fault, 3 steps, and
    `rollout_with_fault_schedule` switching at step 2 of 4: 1e-6;
  * `batched_rollout_lanes` in float32 at B=8 for 3 steps, against the JAX
    package's as its suite runs it (float32 Pallas kernels in interpret
    mode): 2e-2 on u_phys and wrench, u_phys on the rows whose allocation
    took the same branches (`tests/test_lanes.py:175-178`);
  * `history_to_table` and `CSV_HEADER` equal to the JAX package's; the
    range and mode semantics of the state noise.
All with noise 'none' unless said otherwise (float64 unless said otherwise).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import scenario_from_numpy
from ft_mpc_torch.geometry.scenario import DEMO_BANK, DEMO_TERMINAL_MODES
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_step as t_robot_step
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.ops.quaternion import quat_normalize as t_quat_normalize
from ft_mpc_torch.sim import env as tenv
from ft_mpc_torch.sim import history as thist
from ft_mpc_torch.solvers import lanes_alloc as tla
from ft_mpc_torch.solvers import lanes_condense as tlc
from ft_mpc_torch.solvers import lanes_qp as tlq
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig as TCfg
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_step as j_robot_step
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.ops.quaternion import quat_normalize as j_quat_normalize
from ft_mpc_tpu.sim import env as jenv
from ft_mpc_tpu.sim import history as jhist
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from torch_parity import F64, gentle_states, jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

Q = [1, 1, 1, 1, 1, 1, 2, 2, 2]  # DEFAULT_TUNING of the JAX package's api
R = [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]
TOL = dict(rtol=0, atol=1e-6)


def demo_initial_state() -> np.ndarray:
    """The initial condition of examples/sim.py:82-86."""
    x0 = np.zeros(13)
    x0[0:3] = [1, 0, 1]
    x0[3:6] = [1, 0.5, 0]
    x0[6:10] = Rotation.from_euler("zyx", [50, 30, -10], degrees=True).as_quat()
    x0[10:13] = [0.3, 0.8, -0.1]
    return x0


def demo_flat(mode: str) -> dict[str, np.ndarray]:
    """One row of the demo snapshot: the (10, 11) double fault in `mode`."""
    with np.load(DEMO_BANK) as z:
        return {k: z[k][DEMO_TERMINAL_MODES.index(mode)] for k in z.files}


def stack(*flats) -> dict[str, np.ndarray]:
    return {k: np.stack([f[k] for f in flats]) for k in flats[0]}


def healthy_flat() -> dict[str, np.ndarray]:
    return {k: v[0] for k, v in load_flat([0]).items()}


def hover_refs(omega_des, horizon=15, duration=30):
    traj = ttraj.generate_trajectory("hover", 0.1, duration)
    return ttraj.prepare_center_trajectory(traj, np.asarray(omega_des), 16.8, 0.1,
                                           horizon + 1)


def _plants():
    return (JBodyParams.default(0.1), TBodyParams.default(0.1, dtype=F64, device="cpu"),
            jsp.MPCWeights.from_diagonals(Q, R),
            tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu"))


# ---------------------------------------------------------------------------
# noise and history
# ---------------------------------------------------------------------------


def test_noise_vector_modes_and_ranges():
    cfg = tenv.SimConfig(steps=1, noise_position=1e-3, noise_velocity=2e-3,
                         noise_orientation=4e-3, noise_angular_velocity=8e-3)
    scales = np.repeat([1e-3, 2e-3, 4e-3, 8e-3], [3, 3, 4, 3])
    like = torch.zeros(20000, 13, dtype=F64)
    gen = torch.Generator().manual_seed(0)
    ref = np_(tenv._noise_vector(cfg, gen, like)) / scales
    assert ref.min() >= 0.0 and ref.max() < 1.0  # positively biased
    np.testing.assert_allclose(ref.mean(axis=0), 0.5, atol=0.01)
    zm = np_(tenv._noise_vector(cfg._replace(noise_mode="zero_mean"), gen, like)) / scales
    assert zm.min() >= -0.5 and zm.max() < 0.5
    np.testing.assert_allclose(zm.mean(axis=0), 0.0, atol=0.01)
    # same seed, same draws; the dtype is the state's
    a = tenv._noise_vector(cfg, torch.Generator().manual_seed(3), like[:4].float())
    b = tenv._noise_vector(cfg, torch.Generator().manual_seed(3), like[:4].float())
    assert a.dtype == torch.float32 and torch.equal(a, b)
    # 'none' draws nothing and needs no generator
    state = gen.get_state()
    none = tenv._noise_vector(cfg._replace(noise_mode="none"), gen, like[:2])
    assert torch.equal(none, torch.zeros(2, 13, dtype=F64))
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(tenv._noise_vector(cfg._replace(noise_mode="none"), None, like[:2]),
                       none)
    with pytest.raises(ValueError, match="unknown noise_mode"):
        tenv._noise_vector(cfg._replace(noise_mode="gauss"), gen, like[:2])
    with pytest.raises(ValueError, match="torch.Generator"):
        tenv._noise_vector(cfg, None, like[:2])
    # the JAX package's draws have the same support and scales
    jn = np.stack([np.asarray(jenv._noise_vector(jenv.SimConfig(
        steps=1, noise_position=1e-3, noise_velocity=2e-3, noise_orientation=4e-3,
        noise_angular_velocity=8e-3), k, jnp.float64))
        for k in jax.random.split(jax.random.key(0), 200)]) / scales
    assert jn.min() >= 0.0 and jn.max() < 1.0


def test_rollout_refuses_noise_without_generator():
    jp, tp, jw, tw = _plants()
    flat = demo_flat("quadratic")
    sc = scenario_from_numpy(flat, device="cpu", dtype=F64)
    x_ref, u_ref = hover_refs(flat["omega_des"], horizon=4, duration=2)
    cfg = tsp.MPCConfig(horizon=4, sqp_iters=1)
    args = (tp, sc, tw, cfg, tenv.SimConfig(steps=2), t64(demo_initial_state()),
            t64(x_ref), t64(u_ref))
    with pytest.raises(ValueError, match="torch.Generator"):
        tenv.rollout(*args)
    # with a generator the noise is drawn and moves the state
    noisy = tenv.rollout(*args, torch.Generator().manual_seed(0))
    quiet = tenv.rollout(*args[:4], tenv.SimConfig(steps=2, noise_mode="none"), *args[5:])
    assert noisy.state.shape == (2, 13)
    np.testing.assert_array_equal(np_(noisy.state[0]), np_(quiet.state[0]))
    d = np_(noisy.state[1]) - np_(quiet.state[1])
    assert (d[:6] > 0).all() and np.abs(d).max() < 2e-3


def test_history_table_matches_jax(rng, tmp_path):
    T = 6
    leaves = {name: rng.standard_normal((T, k)) if k else rng.standard_normal(T)
              for name, k in zip(tenv.RolloutHistory._fields,
                                 (0, 13, 13, 16, 6, 9, 0, 0, 0, 0, 0, 0))}
    D = rng.standard_normal((6, 16))
    ref = jhist.history_to_table(jenv.RolloutHistory(**leaves), D)
    out = thist.history_to_table(tenv.RolloutHistory(**{k: t64(v) for k, v in leaves.items()}),
                                 t64(D))
    assert out.shape == (T, 67)
    np.testing.assert_array_equal(out, ref)
    assert thist.CSV_HEADER == jhist.CSV_HEADER and len(thist.CSV_HEADER) == 67
    path = tmp_path / "run.csv"
    thist.export_csv(tenv.RolloutHistory(**{k: t64(v) for k, v in leaves.items()}), D,
                     str(path))
    assert path.read_text().splitlines()[0].lstrip("# ").split(";") == jhist.CSV_HEADER


# ---------------------------------------------------------------------------
# rollouts against the JAX package
# ---------------------------------------------------------------------------


def _warm_to_torch(w):
    return tsp.WarmStart(*(None if a is None else t64(a) for a in w))


def test_rollout_step_by_step_matches_jax():
    jp, tp, jw, tw = _plants()
    flat = demo_flat("quadratic")
    jsc, tsc = jax_bank(flat), scenario_from_numpy(flat, device="cpu", dtype=F64)
    jcfg, tcfg = jsp.MPCConfig(horizon=15, sqp_iters=3), tsp.MPCConfig(horizon=15, sqp_iters=3)
    x_ref, u_ref = hover_refs(flat["omega_des"])
    steps, Nt = 10, 15

    @jax.jit
    def jstep(state, warm, xr, ur):
        out = jsp.get_control(jp, jsc, jw, jcfg, state, xr, ur, warm)
        x_new = j_robot_step(jp, jsc.fault, state, out.u_phys)
        x_new = x_new.at[6:10].set(j_quat_normalize(x_new[6:10]))
        return out, x_new, jsp.shift_warmstart(out.warm, j_robot_to_center(jsc.r, x_new))

    state = jnp.asarray(demo_initial_state())
    warm = jsp.init_warmstart(jp, jsc, jcfg, j_robot_to_center(jsc.r, state))
    states, us = [], []
    for i in range(steps):
        xr, ur = x_ref[i:i + Nt + 1], u_ref[i:i + Nt + 1]
        out, x_new, warm_next = jstep(state, warm, jnp.asarray(xr), jnp.asarray(ur))
        # the port's step from the same state and warm start
        got = tsp.get_control(tp, tsc, tw, tcfg, t64(state), t64(xr), t64(ur),
                              _warm_to_torch(warm))
        for name in ("u_phys", "wrench", "c0"):
            np.testing.assert_allclose(np_(getattr(got, name)), np.asarray(getattr(out, name)),
                                       **TOL, err_msg=f"step {i} {name}")
        for name in ("X", "U", "y_hull", "y_term", "rho"):
            np.testing.assert_allclose(np_(getattr(got.warm, name)),
                                       np.asarray(getattr(out.warm, name)), **TOL,
                                       err_msg=f"step {i} warm.{name}")
        for name in got.info._fields:
            np.testing.assert_allclose(np_(getattr(got.info, name)),
                                       np.asarray(getattr(out.info, name)), **TOL,
                                       err_msg=f"step {i} info.{name}")
        assert bool(got.alloc.was_clipped) == bool(out.alloc.was_clipped)
        # the port's transition from the JAX step's command
        t_new = t_robot_step(tp, tsc.fault, t64(state), t64(out.u_phys))
        t_new = torch.cat([t_new[:6], t_quat_normalize(t_new[6:10]), t_new[10:]])
        np.testing.assert_allclose(np_(t_new), np.asarray(x_new), rtol=0, atol=1e-12)
        shifted = tsp.shift_warmstart(_warm_to_torch(out.warm),
                                      t_robot_to_center(tsc.r, t_new))
        np.testing.assert_allclose(np_(shifted.X), np.asarray(warm_next.X), rtol=0, atol=1e-12)
        states.append(np.asarray(state))
        us.append(np.asarray(out.u_phys))
        state, warm = x_new, warm_next

    # the port's own loop follows the JAX one until rounding differences grow
    hist = tenv.rollout(tp, tsc, tw, tcfg, tenv.SimConfig(steps=4, noise_mode="none"),
                        t64(demo_initial_state()), t64(x_ref), t64(u_ref))
    assert hist.state.shape == (4, 13) and hist.time.shape == (4,)
    np.testing.assert_allclose(np_(hist.state), np.stack(states[:4]), **TOL)
    np.testing.assert_allclose(np_(hist.u_phys), np.stack(us[:4]), **TOL)
    np.testing.assert_allclose(np_(hist.time), 0.1 * np.arange(4), rtol=0, atol=1e-15)


def test_batched_rollout_matches_jax():
    """healthy + (10, 11), from the demo's state (`tests/test_mpc.py:108-124`)."""
    jp, tp, jw, tw = _plants()
    flat = stack(healthy_flat(), demo_flat("empc"))
    cfg = dict(horizon=15, sqp_iters=3)
    x_ref, u_ref = hover_refs(flat["omega_des"][0], duration=2)
    x0 = np.stack([demo_initial_state()] * 2)
    sim = dict(steps=3, noise_mode="none")
    ref = jenv.batched_rollout(jp, jax_bank(flat), jw, jsp.MPCConfig(**cfg),
                               jenv.SimConfig(**sim), jnp.asarray(x0), jnp.asarray(x_ref),
                               jnp.asarray(u_ref), jax.random.split(jax.random.key(0), 2))
    out = tenv.batched_rollout(tp, torch_bank(flat), tw, tsp.MPCConfig(**cfg),
                               tenv.SimConfig(**sim), t64(x0), t64(x_ref), t64(u_ref))
    assert out.state.shape == (2, 3, 13) and out.time.shape == (2, 3)
    for name in out._fields:
        np.testing.assert_allclose(np_(getattr(out, name)).astype(float),
                                   np.asarray(getattr(ref, name)).astype(float), **TOL,
                                   err_msg=name)
    # the faulted row never commands its broken thrusters
    assert np.abs(np_(out.u_phys)[1][:, 10:12]).max() < 1e-6


def test_fault_schedule_matches_jax():
    """healthy, then (10, 11) from step 2 of 4 (`tests/test_mpc.py:188-212`)."""
    jp, tp, jw, tw = _plants()
    flat = stack(healthy_flat(), demo_flat("empc"))
    cfg = dict(horizon=15, sqp_iters=3)
    x_ref, u_ref = hover_refs(flat["omega_des"][0], duration=2)
    x0 = np.zeros(13)
    x0[0:3] = [0.3, 0.1, -0.2]
    x0[9] = 1.0
    sim = dict(steps=4, noise_mode="none")
    ref = jenv.rollout_with_fault_schedule(
        jp, jax_bank(flat), jnp.asarray([0, 2]), jw, jsp.MPCConfig(**cfg),
        jenv.SimConfig(**sim), jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref),
        jax.random.key(0))
    out = tenv.rollout_with_fault_schedule(
        tp, torch_bank(flat), [0, 2], tw, tsp.MPCConfig(**cfg), tenv.SimConfig(**sim),
        t64(x0), t64(x_ref), t64(u_ref))
    assert out.u_phys.shape == (4, 16)
    for name in out._fields:
        np.testing.assert_allclose(np_(getattr(out, name)).astype(float),
                                   np.asarray(getattr(ref, name)).astype(float), **TOL,
                                   err_msg=name)
    u = np_(out.u_phys)
    assert np.abs(u[2:, 10:12]).max() < 1e-6


def test_batched_rollout_lanes_matches_jax_float32():
    """The batched controller's closed loop: the port in float32 on the CPU
    (the kernels' plain versions) against the JAX package as its own suite
    runs it (x64 around its float32 Pallas kernels, in interpret mode);
    configuration of `tests/test_lanes.py:113-136`."""
    rows = [0, 3, 10, 17, 22, 26, 30, 31]
    B = len(rows)
    flat = load_flat(rows)
    kw = dict(horizon=8, sqp_iters=2)
    admm = dict(iters=30, phases=1, rho=50.0, adapt_clip=1.5)
    traj = ttraj.generate_trajectory("hover", 0.1, 10)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   0.1, kw["horizon"] + 1)
    x0 = gentle_states(B)
    sim = dict(steps=3, noise_mode="none")
    ref = jenv.batched_rollout_lanes(
        JBodyParams.default(0.1), jax_bank(flat), jsp.MPCWeights.from_diagonals(Q, R),
        jsp.MPCConfig(admm=JCfg(**admm), **kw), jenv.SimConfig(**sim), jnp.asarray(x0),
        jnp.asarray(x_ref), jnp.asarray(u_ref), jax.random.split(jax.random.key(0), B))
    F32 = torch.float32
    t32 = lambda a: torch.as_tensor(np.asarray(a), dtype=F32)
    launches = (tlc.condense_lanes.launches, tlq.admm_lanes.launches,
                tla.allocate_thrusters_lanes.launches)
    out = tenv.batched_rollout_lanes(
        TBodyParams.default(0.1, dtype=F32, device="cpu"),
        scenario_from_numpy(flat, device="cpu", dtype=F32),
        tsp.MPCWeights.from_diagonals(Q, R, dtype=F32, device="cpu"),
        tsp.MPCConfig(admm=TCfg(**admm), **kw), tenv.SimConfig(**sim), t32(x0), t32(x_ref),
        t32(u_ref))
    # the CPU runs the kernels' plain versions: no launch is counted
    assert launches == (tlc.condense_lanes.launches, tlq.admm_lanes.launches,
                        tla.allocate_thrusters_lanes.launches)
    assert out.u_phys.shape == (B, 3, 16) and out.u_phys.dtype == F32
    assert torch.isfinite(out.state).all()
    np.testing.assert_allclose(np_(out.wrench), np.asarray(ref.wrench), rtol=0, atol=2e-2)
    same = np_(out.was_clipped) == np.asarray(ref.was_clipped)
    assert same.sum() >= same.size - 2
    np.testing.assert_allclose(np_(out.u_phys)[same], np.asarray(ref.u_phys)[same],
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(np_(out.state), np.asarray(ref.state), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_(out.x_ref0), np.asarray(ref.x_ref0), rtol=0, atol=1e-7)
