"""The state box and rate rows through the port and the JAX package.

The same numpy inputs go through both packages on the CPU (the JAX package
in x64, its Pallas kernels in interpret mode; the port on its plain kernel
versions):

  * the reactive.yaml of tests/test_config_bounds.py (a 0.5 m/s box on the
    velocities, du_max rate rows) through each package's `load_config` and
    `SpiralingMPC`, from a state above the box: u within 2e-2 N (the
    end-to-end class of tests/test_lanes.py:174-178) and the planned stage
    velocities within 1e-3 of the box on both;
  * the binding box and rate cases of tests/test_state_bounds.py on the
    port's per-scenario SQP, each against the port's `solve_reference`
    golden and the JAX package's, at that file's tolerances (the bound
    saturates within 1e-5 / 1e-3, the first input within 1e-4 of the
    golden);
  * one boxed `get_control_batch` at horizon 15 (T = 64 + 2*13*14 +
    2*6*14 = 596 dense rows, the size the ADMM cluster design takes on the
    card) on three bank rows, at test_torch_spiraling.py's tolerances.
"""

from __future__ import annotations

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_config_bounds as jcb
from ft_mpc_torch import api as tapi
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.controllers.reference_solver import solve_reference as t_solve_reference
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.ops.quaternion import rot_full_inv as t_rot_full_inv
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig as TCfg
from ft_mpc_torch.utils import config as tconfig
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_torch.utils.faults import BrokenThruster as TBroken
from ft_mpc_tpu import api as japi
from ft_mpc_tpu.api import DEFAULT_TUNING, _build_scenario_with_terminal
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.controllers.reference_solver import solve_reference as j_solve_reference
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from ft_mpc_tpu.utils import config as jconfig
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import F64, gentle_states, jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

V_BOX = 0.5  # m/s, the reactive.yaml's xub on the three velocities
TOL_U = 2e-2  # N, two backends of a control step (tests/test_lanes.py:174-178)
TOL_BOX = 1e-3  # m/s, a planned stage velocity above the box (tests/test_config_bounds.py)


# ---------------------------------------------------------------------------
# the reactive.yaml through both packages' user API
# ---------------------------------------------------------------------------


def test_yaml_box_through_spiraling_mpc_matches_jax():
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(jcb.YAML_TEXT)
        path = f.name
    try:
        jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    finally:
        os.unlink(path)
    for key in ("xub", "du_max"):
        np.testing.assert_array_equal(np.asarray(tc.tuning[key]), np.asarray(jc.tuning[key]))
    assert [(t.index, t.intensity) for t in tc.faults] == [(t.index, t.intensity)
                                                            for t in jc.faults]
    jm = japi.SpiralingMPC(JBodyParams.default(0.1), jc.faults, tuning=jc.tuning,
                           terminal_mode="quadratic")
    tm = tapi.SpiralingMPC(TBodyParams.default(0.1, F64, "cpu"), tc.faults,
                           tuning=tc.tuning, terminal_mode="quadratic")
    assert tm.weights.x_ub is not None and tm.weights.du_max is not None
    assert tm.cfg.horizon == jm.cfg.horizon == 10
    x0 = np.zeros(13)
    x0[9] = 1.0
    x0[3] = 0.8  # starts above the 0.5 m/s velocity box
    for m in (jm, tm):
        m.load_trajectory("hover", 10)
    u_j, u_t = jm.get_control(x0, 0.0), tm.get_control(x0, 0.0)
    assert np.isfinite(u_t).all()
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=TOL_U)
    # planned stages respect the box (stage 0 is the pinned measurement)
    for X in (np.asarray(jm.last_output.warm.X), np_(tm.last_output.warm.X)):
        assert float(X[1:-1, 3:6].max()) <= V_BOX + TOL_BOX


# ---------------------------------------------------------------------------
# binding box and rate rows against the golden (tests/test_state_bounds.py)
# ---------------------------------------------------------------------------

DT = 0.1
NT = 15
FAULTS = (10, 11)
BIG = 1e8


def _tight(cfg_cls, admm_cls):
    return cfg_cls(horizon=NT, sqp_iters=25,
                   admm=admm_cls(iters=150, phases=6, rho=10.0))


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _problem():
    """tests/test_state_bounds.py's problem in the port (float64 on the CPU):
    the (10, 11) quadratic-terminal scenario, a braking state, and the
    unconstrained solution at the tight configuration."""
    params = TBodyParams.default(DT, F64, "cpu")
    sc = tapi.build_scenario_with_terminal(params, [TBroken(i, 1.0) for i in FAULTS],
                                           DEFAULT_TUNING, terminal_mode="quadratic",
                                           device="cpu", dtype=F64)
    traj = ttraj.generate_trajectory("hover", DT, 30)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, np_(sc.omega_des), 16.8, DT, NT + 1)
    x_ref, u_ref = t64(x_ref[: NT + 1]), t64(u_ref[: NT + 1])
    x0 = np.zeros(13)
    x0[0:3] = [0.4, 0.1, 0.3]
    x0[3:6] = [0.25, 0.1, 0.0]
    x0[6:10] = [0, 0, 0, 1]
    x0[10:13] = np_(sc.omega_des)
    c0 = t_robot_to_center(sc.r, t64(x0))
    cfg = _tight(tsp.MPCConfig, TCfg)
    w0 = tsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], dtype=F64,
                                       device="cpu")
    base, _ = tsp.sqp_solve(params, sc, w0, cfg, c0, x_ref, u_ref,
                            tsp.init_warmstart(params, sc, cfg, c0))
    jparams = JBodyParams.default(DT)
    jsc = _build_scenario_with_terminal(jparams, [JBroken(i, 1.0) for i in FAULTS],
                                        DEFAULT_TUNING, terminal_mode="quadratic")
    return dict(params=params, sc=sc, x_ref=x_ref, u_ref=u_ref, c0=c0, cfg=cfg, base=base,
                jparams=jparams, jsc=jsc, x0=x0)


def _solve_and_goldens(p, bounds: dict):
    """The port's SQP point with these bounds, and the port's and the JAX
    package's SLSQP goldens from it."""
    w = tsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], dtype=F64,
                                      device="cpu", **bounds)
    warm = tsp.init_warmstart(p["params"], p["sc"], p["cfg"], p["c0"], weights=w)
    point, _ = tsp.sqp_solve(p["params"], p["sc"], w, p["cfg"], p["c0"], p["x_ref"],
                             p["u_ref"], warm)
    U0 = np_(point.U) + 1e-3
    ref_t = t_solve_reference(p["params"], p["sc"], w, NT, p["c0"], p["x_ref"], p["u_ref"],
                              U0=U0)
    jw = jsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                       **{k: jnp.asarray(v) for k, v in bounds.items()})
    jc0 = j_robot_to_center(p["jsc"].r, jnp.asarray(p["x0"]))
    ref_j = j_solve_reference(p["jparams"], p["jsc"], jw, NT, jc0, jnp.asarray(np_(p["x_ref"])),
                              jnp.asarray(np_(p["u_ref"])), U0=U0)
    for ref in (ref_t, ref_j):
        assert ref.success and ref.max_violation < 1e-7
        du0 = float(np.max(np.abs(np_(point.U[0]) - np.asarray(ref.U[0]))))
        assert du0 < 1e-4, du0
    return point


def test_state_box_binds_and_matches_golden(problem):
    p = problem
    vmin_free = float(p["base"].X[1:-1, 3].min())
    assert vmin_free < 0
    x_lb = np.full(13, -BIG)
    x_lb[3] = 0.9 * vmin_free
    point = _solve_and_goldens(p, dict(x_lb=x_lb))
    vmin_con = float(point.X[1:-1, 3].min())
    # binds: saturates the bound, clearly above the unconstrained optimum
    assert vmin_con >= x_lb[3] - 1e-5
    assert vmin_con <= x_lb[3] + 1e-3
    assert float((point.U - p["base"].U).abs().max()) > 1e-4


def _total_wrench(p, point):
    u_r = torch.einsum("tij,tj->ti", t_rot_full_inv(point.X[:-1, 9:13]), p["u_ref"][:NT])
    return point.U + u_r + p["sc"].u_comp + p["sc"].faulty_force_gen


def test_rate_limit_binds_and_matches_golden(problem):
    p = problem
    w = _total_wrench(p, p["base"])
    dw_free = float((w[1:] - w[:-1]).abs().max())
    du_max = np.full(6, 0.8 * dw_free)
    point = _solve_and_goldens(p, dict(du_max=du_max))
    w_c = _total_wrench(p, point)
    dw_con = float((w_c[1:] - w_c[:-1]).abs().max())
    assert dw_con <= du_max[0] + 1e-4
    assert dw_con >= du_max[0] - 1e-3  # saturates
    assert float((point.U - p["base"].U).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the boxed batched step at horizon 15 (T = 596)
# ---------------------------------------------------------------------------

ROWS = [0, 10, 17]


def test_boxed_control_step_at_horizon_15_matches_jax():
    """`init_warmstart_batch` and one `get_control_batch` with the
    reactive.yaml's box and rate rows at horizon 15 through both packages."""
    x_ub = np.full(13, BIG)
    x_ub[3:6] = V_BOX
    bounds = dict(x_ub=x_ub, du_max=np.array([2.0, 2.0, 2.0, 1.0, 1.0, 1.0]))
    flat = load_flat(ROWS)
    jbank, tbank = jax_bank(flat), torch_bank(flat)
    jw = jsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], **bounds)
    tw = tsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"], **bounds,
                                      dtype=F64, device="cpu")
    assert tsp.n_extra_rows(tw, NT) == jsp.n_extra_rows(jw, NT) == 2 * 19 * (NT - 1)
    assert tbank.term_A.shape[1] + tsp.n_extra_rows(tw, NT) == 596
    kw = dict(horizon=NT, sqp_iters=2, newton_iters=3, cleanup_iters=40, cleanup_k=2,
              cleanup_phases=2)
    admm = dict(iters=30, phases=1, rho=50.0, adapt_clip=1.5)
    jcfg, tcfg = jsp.MPCConfig(admm=JCfg(**admm), **kw), tsp.MPCConfig(admm=TCfg(**admm), **kw)
    traj = ttraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   0.1, NT + 1)
    x_ref, u_ref = x_ref[: NT + 1], u_ref[: NT + 1]
    x0 = gentle_states(len(ROWS))

    jp = JBodyParams.default(0.1)
    jc0 = jax.vmap(j_robot_to_center)(jbank.r, jnp.asarray(x0))
    jwarm = jax.jit(jsp.init_warmstart_batch, static_argnums=(3,))(
        jp, jbank, jw, jcfg, jc0, jnp.asarray(x_ref), jnp.asarray(u_ref))
    j = jax.jit(jsp.get_control_batch, static_argnums=(3,))(
        jp, jbank, jw, jcfg, jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(u_ref), jwarm)

    tp = TBodyParams.default(0.1, dtype=F64, device="cpu")
    tc0 = t_robot_to_center(tbank.r, t64(x0))
    twarm = tsp.init_warmstart_batch(tp, tbank, tw, tcfg, tc0, t64(x_ref), t64(u_ref))
    assert twarm.y_term.shape[1] == 596
    t = tsp.get_control_batch(tp, tbank, tw, tcfg, t64(x0), t64(x_ref), t64(u_ref), twarm)

    assert torch.isfinite(t.u_phys).all()
    np.testing.assert_allclose(np_(t.u_phys), np.asarray(j.u_phys), atol=TOL_U)
    np.testing.assert_allclose(np_(t.wrench), np.asarray(j.wrench), atol=TOL_U)
    np.testing.assert_allclose(np_(t.warm.X), np.asarray(j.warm.X), atol=2e-3)
    np.testing.assert_allclose(np_(t.warm.U), np.asarray(j.warm.U), atol=2e-2)
    np.testing.assert_allclose(np_(t.info.r_prim), np.asarray(j.info.r_prim),
                               rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(np_(t.info.term_gap), np.asarray(j.info.term_gap), atol=1e-3)
    np.testing.assert_array_equal(np_(t.alloc.was_clipped), np.asarray(j.alloc.was_clipped))

