"""ft_mpc_torch quaternion / dynamics / linearization vs the JAX package.

Pure functions in float64 on both sides (the JAX side in the x64 test
environment): agreement to ~1e-10 is the bar, far above float64 rounding
of these short computations and far below any modelling difference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.ops import dynamics as tdyn
from ft_mpc_torch.ops import quaternion as tq
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops import dynamics as jdyn
from ft_mpc_tpu.ops import quaternion as jq
from torch_parity import F64, jax_bank, load_flat, np_, t64, to_device, torch_bank

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize(
    "name", ["rot_matrix", "rot_matrix_inv", "rot_full", "rot_full_inv", "quat_normalize"]
)
def test_quaternion_maps(rng, name):
    q = rng.standard_normal((7, 4)) * 2.0
    ref = getattr(jq, name)(jnp.asarray(q))
    out = getattr(tq, name)(t64(q))
    np.testing.assert_allclose(np_(out), np.asarray(ref), **TOL)


def test_omega_operator_and_kinematics(rng):
    q, w = _quats(rng, 9), rng.standard_normal((9, 3))
    np.testing.assert_allclose(
        np_(tq.omega_operator(t64(w))), np.asarray(jq.omega_operator(jnp.asarray(w))), **TOL
    )
    np.testing.assert_allclose(
        np_(tq.quat_kinematics(t64(q), t64(w))),
        np.asarray(jq.quat_kinematics(jnp.asarray(q), jnp.asarray(w))), **TOL,
    )


def _params_pair():
    jp = jdyn.BodyParams.default(0.1)
    tp = tdyn.BodyParams.default(0.1, dtype=F64, device="cpu")
    return jp, tp


def test_body_params_and_thruster_matrix():
    jp, tp = _params_pair()
    np.testing.assert_array_equal(tdyn.build_thruster_matrix(), jdyn.build_thruster_matrix())
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


def test_robot_and_center_dynamics(rng):
    jp, tp = _params_pair()
    n = 6
    x = np.concatenate(
        [rng.standard_normal((n, 6)), _quats(rng, n), rng.standard_normal((n, 3))], axis=1
    )
    c = np.concatenate(
        [rng.standard_normal((n, 9)), _quats(rng, n)], axis=1
    )
    u_phys = rng.uniform(0, 3.4, (n, 16))
    u_gen = rng.standard_normal((n, 6))
    ffg = rng.standard_normal((n, 6)) * 0.3
    r = rng.standard_normal((n, 3)) * 0.2
    broken = (rng.uniform(size=(n, 16)) < 0.2).astype(float)
    intensity = rng.uniform(size=(n, 16)) * broken
    jf = jdyn.FaultState(jnp.asarray(broken), jnp.asarray(intensity))
    tf = tdyn.FaultState(t64(broken), t64(intensity))

    def both(jfn, tfn, j_args, t_args):
        ref = jax.vmap(jfn)(*j_args)
        np.testing.assert_allclose(np_(tfn(*t_args)), np.asarray(ref), **TOL)

    J, T = jnp.asarray, t64
    both(lambda f, u: jdyn.body_wrench(jp, f, u), lambda f, u: tdyn.body_wrench(tp, f, u),
         (jf, J(u_phys)), (tf, T(u_phys)))
    both(lambda f, s, u: jdyn.robot_dx_dt(jp, f, s, u),
         lambda f, s, u: tdyn.robot_dx_dt(tp, f, s, u),
         (jf, J(x), J(u_phys)), (tf, T(x), T(u_phys)))
    both(lambda f, s, u: jdyn.robot_step(jp, f, s, u),
         lambda f, s, u: tdyn.robot_step(tp, f, s, u),
         (jf, J(x), J(u_phys)), (tf, T(x), T(u_phys)))
    both(lambda g, rr, s, u: jdyn.center_dx_dt(jp, g, rr, s, u),
         lambda g, rr, s, u: tdyn.center_dx_dt(tp, g, rr, s, u),
         (J(ffg), J(r), J(c), J(u_gen)), (T(ffg), T(r), T(c), T(u_gen)))
    both(lambda g, rr, s, u: jdyn.center_step(jp, g, rr, s, u),
         lambda g, rr, s, u: tdyn.center_step(tp, g, rr, s, u),
         (J(ffg), J(r), J(c), J(u_gen)), (T(ffg), T(r), T(c), T(u_gen)))
    both(jdyn.robot_to_center, tdyn.robot_to_center, (J(r), J(x)), (T(r), T(x)))
    both(jdyn.center_to_robot, tdyn.center_to_robot, (J(r), J(c)), (T(r), T(c)))
    np.testing.assert_allclose(
        np_(tf.faulty_force_generalized(tp)),
        np.asarray(jax.vmap(lambda f: f.faulty_force_generalized(jp))(jf)), **TOL,
    )


@pytest.mark.parametrize("batched_plant", [False, True])
def test_linearize_matches_jax(rng, batched_plant):
    """vmap(jacfwd) over flattened stages == the JAX vmap(_linearize), also
    with per-scenario mass/inertia (params_batch_axes)."""
    rows = [0, 3, 17, 25]
    flat = load_flat(rows)
    B, Nt = len(rows), 6
    jp, tp = _params_pair()
    if batched_plant:
        m = 16.8 * rng.uniform(0.85, 1.15, B)
        I = np.stack([np.diag(np.diag(np.asarray(jp.inertia)) * rng.uniform(0.8, 1.2, 3))
                      for _ in range(B)])
        jp = jp._replace(mass=m, inertia=I, inertia_inv=np.linalg.inv(I))
        tp = tp._replace(mass=t64(m), inertia=t64(I), inertia_inv=t64(np.linalg.inv(I)))
    X = np.concatenate(
        [rng.standard_normal((B, Nt + 1, 9)) * 0.3,
         np.stack([_quats(rng, Nt + 1) for _ in range(B)])], axis=2,
    )
    U = rng.standard_normal((B, Nt, 6)) * 0.5
    u_ref = rng.standard_normal((Nt + 1, 6))
    cfg_j = jsp.MPCConfig(horizon=Nt)
    cfg_t = tsp.MPCConfig(horizon=Nt)
    p_ax = jsp.params_batch_axes(jp)
    ref = jax.vmap(
        lambda p, sc, Xs, Us: jsp._linearize(p, sc, cfg_j, Xs, Us, jnp.asarray(u_ref)),
        in_axes=(p_ax, 0, 0, 0),
    )(jp, jax_bank(flat), jnp.asarray(X), jnp.asarray(U))
    out = tsp._linearize(tp, torch_bank(flat), cfg_t, t64(X), t64(U), t64(u_ref))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL)


def test_linearize_float32_stays_float32(rng):
    """The card runs the path in float32: forward-mode jacobians must not
    promote (a Python float times a 0-dim tensor under jacfwd would)."""
    rows = [0, 17]
    flat = load_flat(rows)
    B, Nt = len(rows), 4
    _, tp = _params_pair()
    X = np.concatenate(
        [rng.standard_normal((B, Nt + 1, 9)) * 0.3,
         np.stack([_quats(rng, Nt + 1) for _ in range(B)])], axis=2,
    )
    U = rng.standard_normal((B, Nt, 6)) * 0.5
    u_ref = rng.standard_normal((Nt + 1, 6))
    cfg = tsp.MPCConfig(horizon=Nt)
    ref = tsp._linearize(tp, torch_bank(flat), cfg, t64(X), t64(U), t64(u_ref))
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    tp32 = tdyn.BodyParams.default(0.1, device="cpu")
    bank32 = to_device(torch_bank(flat), "cpu", torch.float32)
    out = tsp._linearize(tp32, bank32, cfg, f32(X), f32(U), f32(u_ref))
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        # float32 rounding of an RK4 step and its jacobian
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-4, atol=1e-5)
