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


def _lin_case(rng, B=3, Nt=5, batched_plant=False):
    """(params, bank, X, U, u_ref) of B bench rows in float64 on the CPU."""
    flat = load_flat(list(range(B)))
    _, tp = _params_pair()
    if batched_plant:
        m = 16.8 * rng.uniform(0.85, 1.15, B)
        I = np.stack([np.diag(np.diag(np_(tp.inertia)) * rng.uniform(0.8, 1.2, 3))
                      for _ in range(B)])
        tp = tp._replace(mass=t64(m), inertia=t64(I), inertia_inv=t64(np.linalg.inv(I)),
                         dt=t64(np.full(B, 0.1)))
    X = np.concatenate(
        [rng.standard_normal((B, Nt + 1, 9)) * 0.3,
         np.stack([_quats(rng, Nt + 1) for _ in range(B)])], axis=2,
    )
    U = rng.standard_normal((B, Nt, 6)) * 0.5
    u_ref = rng.standard_normal((Nt + 2, 6))
    return tp, torch_bank(flat), t64(X), t64(U), t64(u_ref)


def test_linearize_lanes_runs_plain_on_cpu(rng):
    """CPU tensors take `linearize_plain` and count a plain call, no launch."""
    from ft_mpc_torch.ops import linearize as lin

    args = _lin_case(rng)
    n_launch, n_plain = lin.linearize_lanes.launches, lin.linearize_lanes.plain_calls
    out = lin.linearize_lanes(*args, 5)
    assert lin.linearize_lanes.plain_calls == n_plain + 1
    assert lin.linearize_lanes.launches == n_launch
    ref = lin.linearize_plain(*args, 5)
    for a, b in zip(out, ref):
        assert a.is_contiguous() and a.dtype == torch.float64
        assert torch.equal(a, b)


def _bad_inputs(case, params, bank, X, U, u_ref):
    """The inputs with one of them made wrong as `case` says."""
    if case == "X_stages":
        X = X[:, :-1]
    elif case == "X_width":
        X = torch.cat([X, X[..., :1]], dim=-1)
    elif case == "U_rows":
        U = U[:-1]
    elif case == "u_ref_short":
        u_ref = u_ref[:3]
    elif case == "mass_rows":
        params = params._replace(mass=params.mass.new_full((X.shape[0] + 1,), 16.8))
    elif case == "inertia_shape":
        params = params._replace(inertia=params.inertia[:2])
    elif case == "bank_shared":
        bank = bank._replace(r=bank.r[0])
    elif case == "X_strided":
        X = X.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "U_strided":
        U = torch.cat([U, U], dim=-1)[..., :6]
    elif case == "inertia_strided":
        params = params._replace(inertia=params.inertia.t())
    elif case == "u_comp_strided":
        bank = bank._replace(u_comp=torch.cat([bank.u_comp, bank.u_comp], 1)[:, ::2])
    elif case == "dtype":
        U = U.float()
    return params, bank, X, U, u_ref


@pytest.mark.parametrize("case", [
    "X_stages", "X_width", "U_rows", "u_ref_short", "mass_rows", "inertia_shape",
    "bank_shared", "X_strided", "U_strided", "inertia_strided", "u_comp_strided", "dtype",
])
def test_linearize_lanes_refuses_bad_inputs(rng, case):
    """The wrapper checks every input before either path runs."""
    from ft_mpc_torch.ops import linearize as lin

    args = _bad_inputs(case, *_lin_case(rng))
    n_plain = lin.linearize_lanes.plain_calls
    with pytest.raises(ValueError, match="linearize_lanes"):
        lin.linearize_lanes(*args, 5)
    assert lin.linearize_lanes.plain_calls == n_plain


def test_linearize_lanes_shared_and_row_params(rng):
    """A shared plant, the same plant given per row, and the gathered form
    (jacfwd of one stage at a time, each with its row's leaves) agree."""
    from ft_mpc_torch.ops import linearize as lin

    params, bank, X, U, u_ref = _lin_case(rng, B=3, Nt=4)
    B, Nt = 3, 4
    per_row = tdyn.BodyParams(
        mass=params.mass.expand(B).contiguous(),
        inertia=params.inertia.expand(B, 3, 3).contiguous(),
        inertia_inv=params.inertia_inv.expand(B, 3, 3).contiguous(),
        max_thrust=params.max_thrust, D=params.D, dt=params.dt.expand(B).contiguous(),
    )
    shared = lin.linearize_lanes(params, bank, X, U, u_ref, Nt)
    rowwise = lin.linearize_lanes(per_row, bank, X, U, u_ref, Nt)
    for a, b in zip(shared, rowwise):
        np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=1e-15)
    for b in range(B):
        p_b = lin.params_row(per_row, lin.params_batch_axes(per_row), b)
        sd = lin.StageData(bank.faulty_force_gen[b], bank.r[b], bank.u_comp[b])
        for t in range(Nt):
            f = lambda x, u: lin.stage_dynamics(p_b, sd, x, u, u_ref[t])
            A_bt, B_bt = torch.func.jacfwd(f, argnums=(0, 1))(X[b, t], U[b, t])
            np.testing.assert_allclose(np_(rowwise[0][b, t]), np_(A_bt), **TOL)
            np.testing.assert_allclose(np_(rowwise[1][b, t]), np_(B_bt), **TOL)
            np.testing.assert_allclose(np_(rowwise[2][b, t]),
                                       np_(f(X[b, t], U[b, t]) - X[b, t + 1]), **TOL)
