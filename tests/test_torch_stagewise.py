"""The stagewise (Riccati-in-ADMM) backend of ft_mpc_torch vs the JAX package.

The same numpy inputs (seeded) go through `ft_mpc_tpu` (x64, its Pallas
sweeps in interpret mode) and through the port on the CPU (plain sweeps):
the batched solver, the per-scenario solver, the QP assembly, and the whole
control step `get_control_batch(qp_backend='stagewise', mode='lanes')`.

Tolerances: float64 pure functions 1e-10 (assembly) and 1e-8 (the scan
solver, 80 ADMM iterations); the lanes solver, float32 inside its re-solve
on both sides, dU and r_prim atol 2e-5 and rho rtol 1e-4
(`tests/test_stagewise.py:399-407`); the whole step wrench and u_phys atol
2e-2 (`tests/test_lanes.py:175-178`), u_phys on rows whose allocation took
the same branches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import (
    flatten_namedtuple,
    stagewise_qp_from_numpy,
    warmstart_from_numpy,
)
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.solvers import lanes_riccati as tlr
from ft_mpc_torch.solvers import mpc_qp_stagewise as tsw
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.solvers import mpc_qp_stagewise as jsw
from torch_parity import F64, gentle_states, jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

Q = [1, 1, 1, 1, 1, 1, 2, 2, 2]
R = [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]
ROWS = [0, 3, 22]  # healthy, a single and a double fault of the snapshot
TOL64 = dict(rtol=0, atol=1e-10)


def synthetic_qp(rng, Nt=9, n=13, m=6, F=4, box=False, infeasible=False):
    """`tests/test_stagewise.py:_synthetic_stagewise_qp` in numpy, as a flat
    dict of one scenario's leaves; `box` adds an active state-row block."""
    T = np.zeros((2, n))
    T[:, 0] = [1.0, -1.0]  # dx_N[0] <= h1 and -dx_N[0] <= h2
    qp = dict(
        A=np.tile(np.eye(n) * 0.95, (Nt, 1, 1)) + rng.standard_normal((Nt, n, n)) * 0.02,
        B=rng.standard_normal((Nt, n, m)) * 0.3,
        c=rng.standard_normal((Nt, n)) * 0.01,
        Qx=np.eye(n) * 0.5,
        gx=rng.standard_normal((Nt + 1, n)) * 0.1,
        Ru=np.eye(m) * 0.2,
        gu=rng.standard_normal((Nt, m)) * 0.1,
        QxN=np.eye(n),
        hull_A=rng.standard_normal((F, m)),
        h_hull=np.tile(np.abs(rng.standard_normal(F)) + 0.5, (Nt, 1)),
        T=T,
        # dx_N[0] >= 5 AND <= -5 is impossible: the elastic rows saturate
        h_term=np.array([-5.0, -5.0]) if infeasible else np.array([10.0, 10.0]),
    )
    if box:
        qp["Cx"] = np.concatenate([np.eye(n)[:3], -np.eye(n)[:3]])
        qp["h_box"] = np.full((Nt, 6), 0.02)  # tight: some rows are active
    return qp


def stack(qps):
    return {k: np.stack([q[k] for q in qps]) for k in qps[0]}


def jax_qp(flat):
    return jsw.StagewiseMPCQP(**{k: jnp.asarray(v) for k, v in flat.items()})


@pytest.mark.parametrize("case", ["plain", "state-rows", "infeasible-terminal"])
def test_lanes_solver_matches_jax(case):
    rng = np.random.default_rng(11)
    flat = stack([synthetic_qp(rng, box=case == "state-rows",
                               infeasible=case == "infeasible-terminal")
                  for _ in range(3)])
    kw = dict(iters=40, phases=2, rho=10.0)
    jsol = jsw.solve_mpc_qp_stagewise_lanes(jax_qp(flat), jsw.StagewiseConfig(**kw))
    tqp = stagewise_qp_from_numpy(flat, device="cpu", dtype=F64)
    tsol = tsw.solve_mpc_qp_stagewise_lanes(tqp, tsw.StagewiseConfig(**kw))
    assert tsol.dU.dtype == F64 and tsol.rho.shape == (3,)
    np.testing.assert_allclose(np_(tsol.dU), np.asarray(jsol.dU), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(tsol.dX), np.asarray(jsol.dX), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(tsol.r_prim), np.asarray(jsol.r_prim), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(tsol.rho), np.asarray(jsol.rho), rtol=1e-4)
    np.testing.assert_allclose(np_(tsol.term_gap), np.asarray(jsol.term_gap), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(tsol.y_term), np.asarray(jsol.y_term), rtol=1e-4, atol=1e-3)
    if case == "infeasible-terminal":
        # the elastic branch ran: duals at the clamp, the gap reported
        assert float(tsol.term_gap.min()) > 4.0
        assert float(tsol.y_term.max()) == pytest.approx(1e3)
    else:
        assert float(tsol.term_gap.max()) == 0.0


def test_lanes_solver_carries_warm_duals_and_rho():
    """A second solve warm-started from the first one's duals and rho."""
    rng = np.random.default_rng(12)
    flat = stack([synthetic_qp(rng) for _ in range(2)])
    flat["h_hull"] = 0.01 * flat["h_hull"]  # active hull rows, so rho adapts
    kw = dict(iters=25, phases=1, rho=300.0, adapt_clip=1.5)
    jcfg, tcfg = jsw.StagewiseConfig(**kw), tsw.StagewiseConfig(**kw)
    j1 = jsw.solve_mpc_qp_stagewise_lanes(jax_qp(flat), jcfg)
    j2 = jsw.solve_mpc_qp_stagewise_lanes(jax_qp(flat), jcfg, y_hull0=j1.y_hull,
                                          y_term0=j1.y_term, rho0=j1.rho)
    tqp = stagewise_qp_from_numpy(flat, device="cpu", dtype=F64)
    t1 = tsw.solve_mpc_qp_stagewise_lanes(tqp, tcfg)
    t2 = tsw.solve_mpc_qp_stagewise_lanes(tqp, tcfg, y_hull0=t1.y_hull,
                                          y_term0=t1.y_term, rho0=t1.rho)
    np.testing.assert_allclose(np_(t2.dU), np.asarray(j2.dU), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(t2.rho), np.asarray(j2.rho), rtol=1e-4)
    assert not np.isclose(np_(t2.rho), 300.0).any()


@pytest.mark.parametrize("case", ["plain", "state-rows", "infeasible-terminal", "hard-rows"])
def test_scan_solver_matches_jax_f64(case):
    """The per-scenario solver (plain float64 re-solve) vs the JAX one."""
    rng = np.random.default_rng(7)
    flat = synthetic_qp(rng, box=case == "state-rows",
                        infeasible=case == "infeasible-terminal")
    kw = dict(iters=40, phases=2, rho=10.0,
              elastic_y_max=0.0 if case == "hard-rows" else 1e2)
    jsol = jsw.solve_mpc_qp_stagewise(jax_qp(flat), jsw.StagewiseConfig(**kw))
    tqp = stagewise_qp_from_numpy(flat, device="cpu", dtype=F64)
    tsol = tsw.solve_mpc_qp_stagewise(tqp, tsw.StagewiseConfig(**kw))
    assert tsol.dU.shape == (9, 6) and tsol.rho.shape == ()
    for name in tsol._fields:
        np.testing.assert_allclose(np_(getattr(tsol, name)), np.asarray(getattr(jsol, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("mode", ["assoc", "scan-assoc"])
def test_unported_modes_raise(mode):
    """The associative-scan modes of the per-scenario solver give what mode
    'scan' gives on the same QP, for one scenario and for a bank of three
    (`tests/test_torch_riccati_assoc.py` holds them against the JAX package)."""
    rng = np.random.default_rng(0)
    one = synthetic_qp(rng)
    bank = stack([one] + [synthetic_qp(rng) for _ in range(2)])
    for flat in (one, bank):
        tqp = stagewise_qp_from_numpy(flat, device="cpu", dtype=F64)
        got = tsw.solve_mpc_qp_stagewise(tqp, tsw.StagewiseConfig(mode=mode))
        ref = tsw.solve_mpc_qp_stagewise(tqp, tsw.StagewiseConfig(mode="scan"))
        for name in got._fields:
            np.testing.assert_allclose(np_(getattr(got, name)), np_(getattr(ref, name)),
                                       rtol=1e-8, atol=1e-8, err_msg=name)
    assert got.dU.shape == (3, 9, 6)


# ---------------------------------------------------------------------------
# controller level, on rows of the bank snapshot
# ---------------------------------------------------------------------------


def _refs(horizon):
    traj = ttraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = ttraj.prepare_center_trajectory(
        traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, horizon + 1
    )
    return x_ref[: horizon + 1], u_ref[: horizon + 1]


def _setup(bounds=None):
    bounds = bounds or {}
    flat = load_flat(ROWS)
    return dict(
        jbank=jax_bank(flat), tbank=torch_bank(flat),
        jp=JBodyParams.default(0.1), tp=TBodyParams.default(0.1, dtype=F64, device="cpu"),
        jw=jsp.MPCWeights.from_diagonals(Q, R, **bounds),
        tw=tsp.MPCWeights.from_diagonals(Q, R, **bounds, dtype=F64, device="cpu"),
        x0=gentle_states(len(ROWS)),
    )


def _velocity_box():
    x_lb, x_ub = np.full(13, -1e8), np.full(13, 1e8)
    x_ub[3] = 0.3  # one-sided: both sides are still built
    return dict(x_lb=x_lb, x_ub=x_ub)


def _configs(horizon, **kw):
    sw = dict(iters=30, rho=50.0, mode="lanes")
    base = dict(horizon=horizon, sqp_iters=2, qp_backend="stagewise", **kw)
    return (jsp.MPCConfig(stagewise=jsw.StagewiseConfig(**sw), **base),
            tsp.MPCConfig(stagewise=tsw.StagewiseConfig(**sw), **base))


@pytest.mark.parametrize("boxed", [False, True], ids=["no-box", "state-box"])
def test_assemble_stagewise_matches_jax(rng, boxed):
    Nt = 6
    s = _setup(_velocity_box() if boxed else None)
    jcfg, tcfg = _configs(Nt)
    x_ref, u_ref = _refs(Nt)
    B = len(ROWS)
    c0 = t_robot_to_center(s["tbank"].r, t64(s["x0"]))
    warm = tsp.init_warmstart(s["tp"], s["tbank"], tcfg, c0)
    X = np_(warm.X) + 0.01 * rng.standard_normal((B, Nt + 1, 13))
    U = 0.05 * rng.standard_normal((B, Nt, 6))

    jgeo = jax.vmap(jsp._masked_geometry)(s["jbank"])
    jxr = jnp.broadcast_to(jnp.asarray(x_ref), (B,) + x_ref.shape)
    jxr = jxr.at[:, :, 6:9].set(s["jbank"].omega_des[:, None, :])
    jqp, jdef = jax.vmap(
        lambda sc, xr, X_, U_, hA, hb, tA, tb: jsp._assemble_stagewise(
            s["jp"], sc, s["jw"], jcfg, X_, U_, xr, jnp.asarray(u_ref), hA, hb, tA, tb)
    )(s["jbank"], jxr, jnp.asarray(X), jnp.asarray(U), *jgeo)

    txr = tsp._per_scenario_ref(s["tbank"], t64(x_ref), B)
    tqp, tdef = tsp._assemble_stagewise(
        s["tp"], s["tbank"], s["tw"], tcfg, t64(X), t64(U), txr, t64(u_ref),
        *tsp._masked_geometry(s["tbank"]))
    np.testing.assert_allclose(np_(tdef), np.asarray(jdef), **TOL64)
    for name in tqp._fields:
        a, b = getattr(tqp, name), getattr(jqp, name)
        assert tuple(a.shape) == tuple(b.shape), name
        # h_box holds _BIG = 1e8 on the inert stage: compare relative there
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-12, atol=1e-10,
                                   err_msg=name)
    assert tqp.Cx.shape == (B, 26 if boxed else 0, 13)


def test_assemble_stagewise_refuses_rate_limits():
    Nt = 4
    s = _setup(dict(du_max=np.full(6, 0.5)))
    _, tcfg = _configs(Nt)
    x_ref, u_ref = (t64(a) for a in _refs(Nt))
    c0 = t_robot_to_center(s["tbank"].r, t64(s["x0"]))
    warm = tsp.init_warmstart(s["tp"], s["tbank"], tcfg, c0)
    with pytest.raises(NotImplementedError, match="du_max"):
        tsp._assemble_stagewise(
            s["tp"], s["tbank"], s["tw"], tcfg, warm.X, warm.U,
            tsp._per_scenario_ref(s["tbank"], x_ref, len(ROWS)), u_ref,
            *tsp._masked_geometry(s["tbank"]))


_jax_init = jax.jit(jsp.init_warmstart_batch, static_argnums=(3,))
_jax_step = jax.jit(jsp.get_control_batch, static_argnums=(3,))


@pytest.mark.parametrize("boxed", [False, True], ids=["no-box", "state-box"])
def test_stagewise_control_step_matches_jax(boxed):
    """Cold warm start, then two chained steps with a worst-1 cleanup, through
    both packages (the configuration of `tests/test_stagewise.py:410-449` on
    snapshot rows)."""
    Nt = 20
    s = _setup(_velocity_box() if boxed else None)
    jcfg, tcfg = _configs(Nt, cleanup_iters=50, cleanup_k=1, cleanup_phases=1)
    x_ref, u_ref = _refs(Nt)

    jx0 = jnp.asarray(s["x0"])
    jargs = (s["jp"], s["jbank"], s["jw"], jcfg)
    jxr, jur = jnp.asarray(x_ref), jnp.asarray(u_ref)
    jw0 = _jax_init(*jargs, jax.vmap(j_robot_to_center)(s["jbank"].r, jx0), jxr, jur)
    j1 = _jax_step(*jargs, jx0, jxr, jur, jw0)
    j2 = _jax_step(*jargs, jx0, jxr, jur, j1.warm)

    tx0 = t64(s["x0"])
    targs = (s["tp"], s["tbank"], s["tw"], tcfg)
    txr, tur = t64(x_ref), t64(u_ref)
    launches = (tlr.riccati_bwd_lanes.launches, tlr.riccati_fwd_lanes.launches)
    tw0 = tsp.init_warmstart_batch(*targs, t_robot_to_center(s["tbank"].r, tx0), txr, tur)
    t1 = tsp.get_control_batch(*targs, tx0, txr, tur, tw0)
    t2 = tsp.get_control_batch(*targs, tx0, txr, tur, t1.warm)
    assert launches == (tlr.riccati_bwd_lanes.launches, tlr.riccati_fwd_lanes.launches)

    assert tw0.kinv is None and jw0.kinv is None and t2.warm.kinv is None
    assert tw0.y_term.shape == jw0.y_term.shape  # T + E rows with a state box
    np.testing.assert_allclose(np_(tw0.X), np.asarray(jw0.X), **TOL64)
    # the JAX warm start crosses the data bridge with kinv=None
    carried = warmstart_from_numpy(flatten_namedtuple(jw0), device="cpu", dtype=F64)
    assert carried.kinv is None
    np.testing.assert_array_equal(np_(carried.X), np.asarray(jw0.X))

    for t, j in ((t1, j1), (t2, j2)):
        assert t.u_phys.dtype == F64 and torch.isfinite(t.u_phys).all()
        assert torch.isfinite(t.info.term_gap).all()
        np.testing.assert_allclose(np_(t.wrench), np.asarray(j.wrench), rtol=0, atol=2e-2)
        same = (np_(t.alloc.was_clipped) == np.asarray(j.alloc.was_clipped)) & (
            np_(t.alloc.used_fallback) == np.asarray(j.alloc.used_fallback))
        assert same.sum() >= len(ROWS) - 1
        np.testing.assert_allclose(np_(t.u_phys)[same], np.asarray(j.u_phys)[same],
                                   rtol=0, atol=2e-2)
        np.testing.assert_allclose(np_(t.c0), np.asarray(j.c0), **TOL64)
        np.testing.assert_allclose(np_(t.warm.U), np.asarray(j.warm.U), rtol=0, atol=2e-2)
        np.testing.assert_allclose(np_(t.warm.X), np.asarray(j.warm.X), rtol=0, atol=2e-3)
        np.testing.assert_allclose(np_(t.warm.rho), np.asarray(j.warm.rho), rtol=5e-2)
        np.testing.assert_allclose(np_(t.info.r_prim), np.asarray(j.info.r_prim),
                                   rtol=5e-2, atol=1e-3)
        np.testing.assert_allclose(np_(t.info.term_gap), np.asarray(j.info.term_gap),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(np_(t.info.cost), np.asarray(j.info.cost), rtol=1e-2)
        assert t.warm.y_term.shape == j.warm.y_term.shape


def test_controller_module_serves_stagewise():
    Nt = 6
    s = _setup()
    _, tcfg = _configs(Nt, cleanup_iters=10, cleanup_k=1, cleanup_phases=1)
    x_ref, u_ref = (t64(a) for a in _refs(Nt))
    ctrl = tsp.BatchSpiralingController(s["tp"], s["tbank"], s["tw"], tcfg, device="cpu")
    x0 = t64(s["x0"])
    warm = ctrl.init_warmstart(x0, x_ref, u_ref)
    assert warm.kinv is None
    out = ctrl(x0, x_ref, u_ref, warm)
    ref = tsp.get_control_batch(s["tp"], s["tbank"], s["tw"], tcfg, x0, x_ref, u_ref, warm)
    np.testing.assert_array_equal(np_(out.u_phys), np_(ref.u_phys))
    assert out.warm.kinv is None


@pytest.mark.parametrize("mode", ["scan", "scan-assoc", "assoc"])
def test_batched_non_lanes_modes_raise(mode):
    """`get_control_batch` on the stagewise backend in a mode other than
    'lanes' runs the per-scenario SQP on every row (the JAX package's vmap of
    `sqp_solve`), with the worst-1 cleanup: two rows against the JAX package
    in float64, the wrench and warm start at 1e-6.  Both packages allocate
    this step with the float32 allocation kernel (the port's plain version,
    the JAX one in interpret mode): u_phys at its class, 2e-3 N
    (`tests/test_lanes_alloc.py:75-78`)."""
    Nt = 4
    s = _setup()
    jcfg, tcfg = _configs(Nt, cleanup_iters=20, cleanup_k=1, cleanup_phases=1)
    jcfg = jcfg._replace(stagewise=jcfg.stagewise._replace(mode=mode))
    tcfg = tcfg._replace(stagewise=tcfg.stagewise._replace(mode=mode))
    x_ref, u_ref = _refs(Nt)
    rows = [0, 1]
    jbank = jax.tree.map(lambda a: a[jnp.asarray(rows)], s["jbank"])
    jx0 = jnp.asarray(s["x0"][rows])
    jargs = (s["jp"], jbank, s["jw"], jcfg)
    jxr, jur = jnp.asarray(x_ref), jnp.asarray(u_ref)
    jw0 = _jax_init(*jargs, jax.vmap(j_robot_to_center)(jbank.r, jx0), jxr, jur)
    j1 = _jax_step(*jargs, jx0, jxr, jur, jw0)

    tbank = tsp.take_rows(s["tbank"], torch.tensor(rows))
    x0 = t64(s["x0"][rows])
    targs = (s["tp"], tbank, s["tw"], tcfg)
    launches = (tlr.riccati_bwd_lanes.launches, tlr.riccati_fwd_lanes.launches)
    warm = tsp.init_warmstart_batch(*targs, t_robot_to_center(tbank.r, x0), t64(x_ref),
                                    t64(u_ref))
    t1 = tsp.get_control_batch(*targs, x0, t64(x_ref), t64(u_ref), warm)
    assert launches == (tlr.riccati_bwd_lanes.launches, tlr.riccati_fwd_lanes.launches)
    tol = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_(t1.wrench), np.asarray(j1.wrench), **tol)
    np.testing.assert_array_equal(np_(t1.alloc.was_clipped), np.asarray(j1.alloc.was_clipped))
    np.testing.assert_allclose(np_(t1.u_phys), np.asarray(j1.u_phys), rtol=0, atol=2e-3)
    for name in ("X", "U", "y_hull", "y_term", "rho"):
        np.testing.assert_allclose(np_(getattr(t1.warm, name)),
                                   np.asarray(getattr(j1.warm, name)), **tol, err_msg=name)
    np.testing.assert_allclose(np_(t1.info.r_prim), np.asarray(j1.info.r_prim), **tol)


def test_unknown_backend_raises():
    s = _setup()
    _, tcfg = _configs(4)
    x_ref, u_ref = (t64(a) for a in _refs(4))
    with pytest.raises(ValueError, match="qp_backend"):
        tsp.init_warmstart_batch(s["tp"], s["tbank"], s["tw"],
                                 tcfg._replace(qp_backend="banded"),
                                 t64(s["x0"]), x_ref, u_ref)
