"""The per-scenario control path of ft_mpc_torch vs the JAX package.

Same numpy inputs (seeded, snapshot rows) through `ft_mpc_tpu` (x64, its
XLA per-scenario path) and through the port on the CPU in float64:
`shift_warmstart`, the dense ADMM (`admm_solve`, `admm_refine`), the
allocation (`project_wrench_zonotope`, `clip_wrench`, `allocate_thrusters`),
the condensed assembly and `solve_mpc_qp`, and the whole step `get_control`
/ `sqp_solve` on the condensed backend, the stagewise one (mode 'scan') and
with gated refinement.  The JAX side runs one scenario per row under
`jax.vmap`; the port runs every row at once (`get_control_rows`) and one
scenario (`get_control`, `sqp_solve`).

Tolerances (float64 on both sides): `shift_warmstart` bit-equal; ADMM 1e-9;
allocation 1e-9 with the branch flags equal on rows clear of both branch
thresholds; the condensed assembly 1e-10; `solve_mpc_qp` 1e-8 (a few hundred
iterations of a map through an explicit inverse); a control step 1e-6 on
u_phys, wrench and warm start.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.geometry.scenario import load_demo_scenario
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.solvers import admm as tadmm
from ft_mpc_torch.solvers import allocation as talloc
from ft_mpc_torch.solvers import mpc_qp as tmq
from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig as TSWCfg
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.solvers import admm as jadmm
from ft_mpc_tpu.solvers import allocation as jalloc
from ft_mpc_tpu.solvers import mpc_qp as jmq
from ft_mpc_tpu.solvers.mpc_qp_stagewise import StagewiseConfig as JSWCfg
from torch_parity import F64, gentle_states, jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

Q = [1, 1, 1, 1, 1, 1, 2, 2, 2]  # DEFAULT_TUNING of the JAX package's api
R = [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]
ROWS = [0, 3, 22]  # healthy, a single and a double fault of the snapshot
HULL_MARGIN = 1e-7  # the allocation's hull test: A w <= b + 1e-7
FALLBACK_EQ_ERR = 1e-2  # the fallback replaces u only above this error


def _close(a, b, tol, name=""):
    np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=tol, err_msg=name)


def _refs(horizon):
    traj = ttraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = ttraj.prepare_center_trajectory(
        traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, horizon + 1
    )
    return x_ref[: horizon + 1], u_ref[: horizon + 1]


def _setup(rows=ROWS):
    flat = load_flat(rows)
    return dict(
        flat=flat, jbank=jax_bank(flat), tbank=torch_bank(flat),
        jp=JBodyParams.default(0.1), tp=TBodyParams.default(0.1, dtype=F64, device="cpu"),
        jw=jsp.MPCWeights.from_diagonals(Q, R),
        tw=tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu"),
        x0=gentle_states(len(rows)),
    )


# ---------------------------------------------------------------------------
# warm-start shift
# ---------------------------------------------------------------------------


def test_shift_warmstart_is_bit_equal(rng):
    B, Nt, F, T, n = 3, 7, 5, 4, 42
    leaves = dict(X=rng.standard_normal((B, Nt + 1, 13)), U=rng.standard_normal((B, Nt, 6)),
                  y_hull=rng.standard_normal((B, Nt, F)), y_term=rng.standard_normal((B, T)),
                  rho=rng.uniform(1, 9, B), kinv=rng.standard_normal((B, n, n)))
    c0 = rng.standard_normal((B, 13))
    jw = jsp.WarmStart(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tw = tsp.WarmStart(**{k: t64(v) for k, v in leaves.items()})
    ref = jax.vmap(jsp.shift_warmstart)(jw, jnp.asarray(c0))
    out = tsp.shift_warmstart(tw, t64(c0))  # a bank
    one = tsp.shift_warmstart(tsp.WarmStart(*(x[1] for x in tw)), t64(c0[1]))  # one scenario
    for name in jw._fields:
        np.testing.assert_array_equal(np_(getattr(out, name)), np.asarray(getattr(ref, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(np_(getattr(one, name)),
                                      np.asarray(getattr(ref, name))[1], err_msg=name)
    # the tail repeats the last stage; y_term, rho and kinv are not shifted
    np.testing.assert_array_equal(np_(out.X[:, -1]), leaves["X"][:, -1])
    np.testing.assert_array_equal(np_(out.y_term), leaves["y_term"])
    assert tsp.shift_warmstart(tw._replace(kinv=None), t64(c0)).kinv is None


# ---------------------------------------------------------------------------
# dense ADMM
# ---------------------------------------------------------------------------


def _random_qp(rng, B, n=8, m_box=8, m_eq=3):
    """Strongly convex QPs with a box and equality rows (l == u)."""
    L = rng.standard_normal((B, n, n))
    P = L @ L.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    E = rng.standard_normal((B, m_eq, n))
    A = np.concatenate([E, np.broadcast_to(np.eye(n)[:m_box], (B, m_box, n))], axis=1)
    w = rng.standard_normal((B, m_eq))
    lo = np.concatenate([w, np.full((B, m_box), -0.3)], axis=1)
    hi = np.concatenate([w, np.full((B, m_box), 0.3)], axis=1)
    return dict(P=P, q=rng.standard_normal((B, n)), A=A, l=lo, u=hi)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_admm_solve_and_refine_match_jax(rng, start):
    B = 3
    qp = _random_qp(rng, B)
    jqp = jadmm.QP(**{k: jnp.asarray(v) for k, v in qp.items()})
    tqp = tadmm.QP(**{k: t64(v) for k, v in qp.items()})
    cfg = dict(iters=40, phases=3, rho=0.5)
    x0 = y0 = None
    if start == "warm":
        x0, y0 = rng.standard_normal((B, 8)), rng.standard_normal((B, 11))
    jsol = jax.vmap(lambda q, x, y: jadmm.admm_solve(q, jadmm.ADMMConfig(**cfg), x, y))(
        jqp, None if x0 is None else jnp.asarray(x0), None if y0 is None else jnp.asarray(y0))
    tsol = tadmm.admm_solve(tqp, tadmm.ADMMConfig(**cfg), None if x0 is None else t64(x0),
                            None if y0 is None else t64(y0))
    for name in tsol._fields:
        _close(getattr(tsol, name), getattr(jsol, name), 1e-9, name)
    assert float(tsol.r_prim.max()) < 1e-2  # it converges

    jref = jax.vmap(lambda q, s: jadmm.admm_refine(q, s, jadmm.ADMMConfig(**cfg), 25))(jqp, jsol)
    tref = tadmm.admm_refine(tqp, tsol, tadmm.ADMMConfig(**cfg), 25)
    for name in tref._fields:
        _close(getattr(tref, name), getattr(jref, name), 1e-9, name)
    # one QP without a batch axis, as the JAX function takes it
    one = tadmm.admm_solve(tadmm.QP(*(x[0] for x in tqp)), tadmm.ADMMConfig(**cfg),
                           None if x0 is None else t64(x0[0]),
                           None if y0 is None else t64(y0[0]))
    _close(one.x, jsol.x[0], 1e-9)


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

ALLOC_ROWS = [0, 1, 5, 10, 11, 16, 17, 22, 30, 31] * 2


def _alloc_args(b, wr, gen):
    args = [wr, b.u_ub, b.faulty_force_gen, b.hull_A, b.hull_b, b.hull_mask]
    return args + ([b.gen_G, b.gen_c, b.gen_L] if gen else [])


def _clear_rows(flat, wr, eq_err):
    """Rows whose hull test and fallback test are decided by more than 1e-9
    (the equality error after the polish stands for the fallback's)."""
    hA = flat["hull_A"] * flat["hull_mask"][..., None]
    hb = np.where(flat["hull_mask"] > 0.5, flat["hull_b"], 1e8)
    slack = np.einsum("bfi,bi->bf", hA, wr + flat["faulty_force_gen"]) - hb - HULL_MARGIN
    return (np.abs(slack).min(axis=1) > 1e-9) & (np.abs(eq_err - FALLBACK_EQ_ERR) > 1e-9)


@pytest.mark.parametrize("gen", [True, False], ids=["zonotope", "halfspace-qp"])
def test_allocate_thrusters_matches_jax(rng, gen):
    flat = load_flat(ALLOC_ROWS)
    B = len(ALLOC_ROWS)
    # half small demands (mostly feasible), half large (clipped; on the
    # zonotope path some rows take the fallback)
    wr = np.concatenate([rng.uniform(-0.5, 0.5, (B // 2, 6)), rng.uniform(-4, 4, (B // 2, 6))])
    jb, tb = jax_bank(flat), torch_bank(flat)
    jparams = JBodyParams.default(0.1)
    tp = TBodyParams.default(0.1, dtype=F64, device="cpu")
    ref = jax.jit(jax.vmap(lambda w, u_ub, ff, hA, hb, hm, *g: jalloc.allocate_thrusters(
        w, jparams.D, u_ub, ff, hA, hb, hm, *g, max_thrust=jparams.max_thrust)))(
        *_alloc_args(jb, jnp.asarray(wr), gen))
    out = talloc.allocate_thrusters(*_alloc_args(tb, t64(wr), gen)[:1], tp.D,
                                    *_alloc_args(tb, t64(wr), gen)[1:],
                                    max_thrust=tp.max_thrust)
    clear = _clear_rows(flat, wr, np.asarray(ref.r_prim))
    assert clear.sum() >= B - 2
    was = np_(out.was_clipped)
    assert 0 < was.sum() < B  # both branches of the hull test
    np.testing.assert_array_equal(was[clear], np.asarray(ref.was_clipped)[clear])
    np.testing.assert_array_equal(np_(out.used_fallback)[clear],
                                  np.asarray(ref.used_fallback)[clear])
    if gen:
        assert np_(out.used_fallback).any()  # the fallback branch ran
    for name in ("u_phys", "wrench_clipped", "r_prim"):
        _close(getattr(out, name)[clear], np.asarray(getattr(ref, name))[clear], 1e-9, name)
    u = np_(out.u_phys)
    assert u.min() >= 0.0 and (u <= flat["u_ub"] + 1e-12).all()


def test_projection_and_clip_match_jax(rng):
    flat = load_flat(ALLOC_ROWS)
    B = len(ALLOC_ROWS)
    w = rng.uniform(-4, 4, (B, 6))
    jb, tb = jax_bank(flat), torch_bank(flat)
    jw, tw = jnp.asarray(w), t64(w)
    jp = jax.vmap(jalloc.project_wrench_zonotope)(jw, jb.gen_G, jb.gen_c, jb.gen_L)
    tp = talloc.project_wrench_zonotope(tw, tb.gen_G, tb.gen_c, tb.gen_L)
    for a, b in zip(tp, jp):
        _close(a, b, 1e-9)
    for gen in (True, False):
        extra = (lambda b: (b.gen_G, b.gen_c, b.gen_L)) if gen else (lambda b: ())
        jc = jax.vmap(jalloc.clip_wrench)(jw, jb.hull_A, jb.hull_b, jb.hull_mask, *extra(jb))
        tc = talloc.clip_wrench(tw, tb.hull_A, tb.hull_b, tb.hull_mask, *extra(tb))
        _close(tc[0], jc[0], 1e-9)
        np.testing.assert_array_equal(np_(tc[1]), np.asarray(jc[1]))


# ---------------------------------------------------------------------------
# condensed assembly and solve_mpc_qp
# ---------------------------------------------------------------------------


def _box_rate():
    x_lb, x_ub = np.full(13, -1e8), np.full(13, 1e8)
    x_lb[3], x_ub[3] = -0.3, 0.3
    return dict(x_lb=x_lb, x_ub=x_ub, du_max=np.full(6, 0.5))


@partial(jax.jit, static_argnums=(3,))
def _jax_assemble(params, bank, weights, cfg, X, U, x_ref, u_ref):
    """vmap of the JAX package's per-scenario `_assemble_condensed`."""
    x_ref = jnp.broadcast_to(x_ref, (X.shape[0],) + x_ref.shape)
    x_ref = x_ref.at[:, :, 6:9].set(bank.omega_des[:, None, :])
    return jax.vmap(
        lambda sc, xr, X_, U_, hA, hb, tA, tb: jsp._assemble_condensed(
            params, sc, weights, cfg, X_, U_, xr, u_ref, hA, hb, tA, tb)
    )(bank, x_ref, X, U, *jax.vmap(jsp._masked_geometry)(bank))


def _qp_inputs(rng, Nt, bounds):
    """Both packages' condensed QPs of a perturbed cold warm start."""
    s = _setup()
    jw = jsp.MPCWeights.from_diagonals(Q, R, **bounds)
    tw = tsp.MPCWeights.from_diagonals(Q, R, **bounds, dtype=F64, device="cpu")
    jcfg, tcfg = jsp.MPCConfig(horizon=Nt), tsp.MPCConfig(horizon=Nt)
    x_ref, u_ref = _refs(Nt)
    B = len(ROWS)
    warm = tsp.init_warmstart(s["tp"], s["tbank"], tcfg,
                              t_robot_to_center(s["tbank"].r, t64(s["x0"])))
    X = np_(warm.X) + 0.01 * rng.standard_normal((B, Nt + 1, 13))
    U = 0.05 * rng.standard_normal((B, Nt, 6))
    jqp = _jax_assemble(s["jp"], s["jbank"], jw, jcfg, jnp.asarray(X), jnp.asarray(U),
                        jnp.asarray(x_ref), jnp.asarray(u_ref))
    tqp = tsp._assemble_condensed(s["tp"], s["tbank"], tw, tcfg, t64(X), t64(U),
                                  tsp._per_scenario_ref(s["tbank"], t64(x_ref), B), t64(u_ref),
                                  *tsp._masked_geometry(s["tbank"]))
    return jqp, tqp


@pytest.mark.parametrize("bounds", [{}, _box_rate()], ids=["terminal-only", "box-and-rate"])
def test_assemble_condensed_matches_jax(rng, bounds):
    jout, tout = _qp_inputs(rng, 6, bounds)
    for ja, ta in zip(jout, tout):
        for name in getattr(ta, "_fields", [None]):
            a = ta if name is None else getattr(ta, name)
            b = ja if name is None else getattr(ja, name)
            assert tuple(a.shape) == tuple(b.shape), name
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-12, atol=1e-10,
                                       err_msg=str(name))


@pytest.mark.parametrize("case", ["cold", "warm", "hard-rows"])
def test_solve_mpc_qp_matches_jax(rng, case):
    (jqp, _, _, _), (tqp, _, _, _) = _qp_inputs(rng, 6, {})
    kw = dict(iters=60, phases=3, rho=50.0)
    if case == "hard-rows":
        kw["elastic_y_max"] = 0.0
    jcfg, tcfg = jmq.StructuredADMMConfig(**kw), tmq.StructuredADMMConfig(**kw)
    B = len(ROWS)
    warm = {}
    if case == "warm":
        warm = dict(y_hull0=np.abs(rng.standard_normal((B, 6, 32))),
                    y_term0=np.abs(rng.standard_normal((B, 64))),
                    rho0=rng.uniform(20.0, 80.0, B))
        jcfg, tcfg = jcfg._replace(adapt_clip=1.5), tcfg._replace(adapt_clip=1.5)
    jsol = jax.jit(jax.vmap(lambda q, *w: jmq.solve_mpc_qp(q, jcfg, *w)))(
        jqp, *(jnp.asarray(warm[k]) for k in ("y_hull0", "y_term0", "rho0") if k in warm))
    tsol = tmq.solve_mpc_qp(tqp, tcfg, **{k: t64(v) for k, v in warm.items()})
    for name in tsol._fields:
        _close(getattr(tsol, name), getattr(jsol, name), 1e-8 * max(
            1.0, float(np.abs(np.asarray(getattr(jsol, name))).max())), name)
    assert tsol.rho.shape == (B,)
    # one QP without a batch axis
    one = tmq.solve_mpc_qp(tmq.StructuredMPCQP(*(x[2] for x in tqp)), tcfg,
                           **{k: t64(v[2]) for k, v in warm.items()})
    _close(one.x, jsol.x[2], 1e-8)


# ---------------------------------------------------------------------------
# the control step
# ---------------------------------------------------------------------------


def _step_configs(case):
    kw = dict(horizon=8, sqp_iters=2)
    admm = dict(iters=30, phases=1, rho=50.0)
    if case == "stagewise-scan":
        kw = dict(horizon=10, sqp_iters=2, qp_backend="stagewise")
        sw = dict(iters=30, rho=50.0, mode="scan")
        return (jsp.MPCConfig(stagewise=JSWCfg(**sw), **kw),
                tsp.MPCConfig(stagewise=TSWCfg(**sw), **kw))
    if case == "refine":
        ref = dict(iters=80, phases=2, rho=50.0)
        kw.update(sqp_iters=1, refine_iters=2, refine_tol=1e-4)
        return (jsp.MPCConfig(admm=jmq.StructuredADMMConfig(**admm),
                              refine_admm=jmq.StructuredADMMConfig(**ref), **kw),
                tsp.MPCConfig(admm=tmq.StructuredADMMConfig(**admm),
                              refine_admm=tmq.StructuredADMMConfig(**ref), **kw))
    return (jsp.MPCConfig(admm=jmq.StructuredADMMConfig(**admm), **kw),
            tsp.MPCConfig(admm=tmq.StructuredADMMConfig(**admm), **kw))


@pytest.mark.parametrize("case", ["condensed", "stagewise-scan", "refine"])
def test_get_control_matches_jax(case):
    s = _setup()
    jcfg, tcfg = _step_configs(case)
    Nt = tcfg.horizon
    x_ref, u_ref = _refs(Nt)
    B = len(ROWS)
    jx0 = jnp.asarray(s["x0"])
    jwarm = jax.vmap(lambda sc, c: jsp.init_warmstart(s["jp"], sc, jcfg, c, weights=s["jw"]))(
        s["jbank"], jax.vmap(j_robot_to_center)(s["jbank"].r, jx0))
    ref = jax.jit(jax.vmap(lambda sc, x, w: jsp.get_control(
        s["jp"], sc, s["jw"], jcfg, x, jnp.asarray(x_ref), jnp.asarray(u_ref), w)))(
        s["jbank"], jx0, jwarm)

    x0 = t64(s["x0"])
    twarm = tsp.init_warmstart(s["tp"], s["tbank"], tcfg,
                               t_robot_to_center(s["tbank"].r, x0), weights=s["tw"])
    args = (s["tp"], s["tbank"], s["tw"], tcfg)
    out = tsp.get_control_rows(*args, x0, t64(x_ref), t64(u_ref), twarm)
    assert out.warm.kinv is None and out.u_phys.shape == (B, 16)
    np.testing.assert_array_equal(np_(out.alloc.was_clipped), np.asarray(ref.alloc.was_clipped))
    np.testing.assert_array_equal(np_(out.alloc.used_fallback),
                                  np.asarray(ref.alloc.used_fallback))
    for name in ("u_phys", "wrench", "c0"):
        _close(getattr(out, name), getattr(ref, name), 1e-6, name)
    for name in ("X", "U", "y_hull", "y_term", "rho"):
        _close(getattr(out.warm, name), getattr(ref.warm, name), 1e-6, name)
    for name in out.info._fields:
        _close(getattr(out.info, name), getattr(ref.info, name), 1e-6, name)

    # one scenario with the JAX package's unbatched shapes
    i = 2
    one = lambda t: tsp.WarmStart(*(None if a is None else a[i] for a in t))
    sc_i = tsp.take_rows(s["tbank"], i)
    single = tsp.get_control(s["tp"], sc_i, s["tw"], tcfg, x0[i], t64(x_ref), t64(u_ref),
                             one(twarm))
    assert single.u_phys.shape == (16,) and single.warm.X.shape == (Nt + 1, 13)
    _close(single.u_phys, ref.u_phys[i], 1e-6)
    _close(single.warm.U, ref.warm.U[i], 1e-6)
    new_warm, info = tsp.sqp_solve(s["tp"], sc_i, s["tw"], tcfg, out.c0[i], t64(x_ref),
                                   t64(u_ref), one(twarm))
    _close(new_warm.X, ref.warm.X[i], 1e-6)
    _close(info.cost, ref.info.cost[i], 1e-6)

    if case == "refine":
        # the gate let refinement run on some row and changed its solution
        base = tsp.get_control_rows(*args[:3], tcfg._replace(refine_iters=0), x0,
                                    t64(x_ref), t64(u_ref), twarm)
        assert (np_(base.warm.U) != np_(out.warm.U)).any()


def test_sqp_converges_to_fixed_point():
    """`tests/test_mpc.py:82-92` on the port alone: from the demo's
    initial state, 15 SQP iterations reach a KKT point (quadratic terminal)."""
    sc = load_demo_scenario("quadratic", device="cpu", dtype=F64)
    p = TBodyParams.default(0.1, dtype=F64, device="cpu")
    w = tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu")
    cfg = tsp.MPCConfig(horizon=15, sqp_iters=15)
    traj = ttraj.generate_trajectory("hover", 0.1, 30)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, np_(sc.omega_des), 16.8, 0.1, 16)
    x0 = np.zeros(13)
    x0[0:3], x0[3:6] = [1, 0, 1], [1, 0.5, 0]
    x0[6:10] = Rotation.from_euler("zyx", [50, 30, -10], degrees=True).as_quat()
    x0[10:13] = [0.3, 0.8, -0.1]
    c0 = t_robot_to_center(sc.r, t64(x0))
    warm = tsp.init_warmstart(p, sc, cfg, c0)
    _, info = tsp.sqp_solve(p, sc, w, cfg, c0, t64(x_ref[:16]), t64(u_ref[:16]), warm)
    assert float(info.defect) < 1e-4
    assert float(info.du_norm) < 2e-2
