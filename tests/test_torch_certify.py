"""The port's validation tooling vs the JAX package: the KKT certificate, the
SLSQP reference solver, the accuracy harness's same-state legs, and the
small helpers (`DummyController`, the span helper).

Float64 on the CPU on both sides unless said otherwise:
  * `kkt_residuals` at the point of tests/test_certify.py:55 (the (10, 11)
    quadratic-terminal scenario, the reference demo's state, a 20-iteration
    SQP; the point is the port's), each residual at 1e-10 (stationarity, a
    1000-step FISTA on the active rows, at 1e-8 relative); the JAX test's
    gates hold on it;
  * at horizon 5, `_build_funcs`' rollout, objective, constraints,
    gradient and constraint jacobian at 1e-10, and one `solve_reference`
    against the JAX one from the same start (U within 1e-6);
  * the accuracy harness (`ft_mpc_torch.benchmarks.accuracy`) on 3 recorded
    states near the orbit: `same_state_controls` at 1e-8 against the JAX
    harness's, and the lanes leg (`get_control_batch` at B=1, float32, the
    cleanup at K=1 over 4 rounds) within the end-to-end class 2e-2
    (tests/test_lanes.py:175-178) of the JAX per-scenario leg.
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.controllers.certify import kkt_residuals
from ft_mpc_torch.controllers.reference_solver import _build_funcs, solve_reference
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
from ft_mpc_torch.utils.faults import BrokenThruster as TBroken
from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory
from ft_mpc_tpu.api import _build_scenario_with_terminal
from ft_mpc_tpu.controllers import certify as jcert
from ft_mpc_tpu.controllers import reference_solver as jref
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import np_, t64

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
NT = 15


def _demo_x0():
    from ft_mpc_torch.examples.sim import demo_x0

    return demo_x0()


@pytest.fixture(scope="module")
def quadratic_problem():
    """tests/test_certify.py:24-52: (10, 11), quadratic terminal, hover, the
    reference demo's state; both packages' plant, scenario and weights."""
    jp = JBodyParams.default(0.1)
    tp = TBodyParams.default(0.1, F64, "cpu")
    tsc = build_scenario_with_terminal(tp, [TBroken(10, 1.0), TBroken(11, 1.0)],
                                       DEFAULT_TUNING, terminal_mode="quadratic",
                                       device="cpu", dtype=F64)
    jsc = _build_scenario_with_terminal(jp, [JBroken(10, 1.0), JBroken(11, 1.0)],
                                        DEFAULT_TUNING, terminal_mode="quadratic")
    traj = generate_trajectory("hover", 0.1, 30)
    x_ref, u_ref = prepare_center_trajectory(traj, np_(tsc.omega_des), 16.8, 0.1, NT + 1)
    x0 = _demo_x0()
    return dict(
        jp=jp, tp=tp, tsc=tsc, jsc=jsc,
        tw=tsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                         dtype=F64, device="cpu"),
        jw=jsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"]),
        x_ref=x_ref[: NT + 1], u_ref=u_ref[: NT + 1],
        c0=np_(robot_to_center(tsc.r, t64(x0))),
    )


def test_kkt_residuals_match_jax(quadratic_problem):
    q = quadratic_problem
    cfg = tsp.MPCConfig(horizon=NT, sqp_iters=20,
                        admm=StructuredADMMConfig(iters=100, phases=4, rho=50.0))
    c0, x_ref, u_ref = t64(q["c0"]), t64(q["x_ref"]), t64(q["u_ref"])
    warm = tsp.init_warmstart(q["tp"], q["tsc"], cfg, c0)
    point, _ = tsp.sqp_solve(q["tp"], q["tsc"], q["tw"], cfg, c0, x_ref, u_ref, warm)
    res = kkt_residuals(q["tp"], q["tsc"], q["tw"], cfg, c0, x_ref, u_ref, point)

    jcfg = jsp.MPCConfig(horizon=NT, sqp_iters=20)
    jpoint = jsp.WarmStart(**{f: jnp.asarray(np_(getattr(point, f)))
                              for f in ('X', 'U', 'y_hull', 'y_term', 'rho')})
    ref = jcert.kkt_residuals(q["jp"], q["jsc"], q["jw"], jcfg, jnp.asarray(q["c0"]),
                              jnp.asarray(q["x_ref"]), jnp.asarray(q["u_ref"]), jpoint)
    print({f: (float(getattr(res, f)), float(getattr(ref, f))) for f in res._fields})
    for f in ("defect", "hull_violation", "term_violation"):
        assert abs(float(getattr(res, f)) - float(getattr(ref, f))) <= 1e-10, f
    assert float(res.stationarity) == pytest.approx(float(ref.stationarity), rel=1e-8,
                                                    abs=1e-10)
    # the JAX test's gates (tests/test_certify.py:57-61)
    assert float(res.defect) < 1e-6
    assert float(res.hull_violation) < 1e-5
    assert float(res.term_violation) < 1e-5
    assert float(res.stationarity) < 0.5


def test_reference_solver_matches_jax(quadratic_problem):
    """The functions of `_build_funcs` (rollout, objective, constraints) and
    the objective's gradient and the constraints' jacobian at one input
    sequence from a state near the orbit, then one SLSQP solve on both
    sides."""
    q = quadratic_problem
    sc = q["tsc"]
    c0 = torch.zeros(13, dtype=F64)
    c0[0:3] = torch.tensor([0.05, -0.03, 0.04], dtype=F64)
    c0[6:9] = sc.omega_des
    c0[12] = 1.0
    n = 5  # horizon of this test: the functions and one SLSQP solve
    x_ref, u_ref = t64(q["x_ref"][: n + 1]), t64(q["u_ref"][: n + 1])
    rng = np.random.default_rng(0)
    U = rng.normal(0, 0.05, n * 6)

    funcs = _build_funcs(q["tp"], sc, q["tw"], n, c0, x_ref, u_ref)
    jfuncs = jref._build_funcs(q["jp"], q["jsc"], q["jw"], n, jnp.asarray(np_(c0)),
                               jnp.asarray(q["x_ref"][: n + 1]),
                               jnp.asarray(q["u_ref"][: n + 1]))
    import jax

    for name, f, jf in (("roll", funcs[0], jfuncs[0]), ("objective", funcs[1], jfuncs[1]),
                        ("constraints", funcs[2], jfuncs[2]),
                        ("grad", torch.func.grad(funcs[1]), jax.grad(jfuncs[1])),
                        ("jacobian", torch.func.jacfwd(funcs[2]), jax.jacfwd(jfuncs[2]))):
        got, want = np_(f(t64(U))), np.asarray(jax.jit(jf)(jnp.asarray(U)))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale, err_msg=name)

    # one SLSQP solve on each side, from zero input
    sol = solve_reference(q["tp"], sc, q["tw"], n, c0, x_ref, u_ref)
    ref = jref.solve_reference(q["jp"], q["jsc"], q["jw"], n, np_(c0), q["x_ref"][: n + 1],
                               q["u_ref"][: n + 1])
    print(f"SLSQP: port {sol.n_iter} iterations, cost {sol.cost}; JAX {ref.n_iter}, "
          f"{ref.cost}")
    assert sol.success and ref.success and sol.max_violation < 1e-8
    assert sol.n_iter == ref.n_iter
    np.testing.assert_allclose(sol.U, ref.U, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sol.X, ref.X, rtol=0, atol=1e-6)
    assert abs(sol.cost - ref.cost) <= 1e-8 * max(1.0, abs(ref.cost))
    with pytest.raises(RuntimeError, match="float64"):
        solve_reference(TBodyParams.default(0.1, torch.float32, "cpu"),
                        tree_map(lambda x: x.float() if x.is_floating_point() else x, sc),
                        q["tw"], n, c0, x_ref, u_ref)


@pytest.fixture(scope="module")
def recorded_states():
    """Three states of the port's own closed loop (MPCConfig's defaults, no
    noise) from near the (10, 11) orbit, with the harness's setup."""
    from ft_mpc_torch.benchmarks import accuracy as tacc
    from ft_mpc_torch.ops.dynamics import center_to_robot
    from ft_mpc_torch.sim.env import SimConfig, rollout

    tp, sc, w, x_ref, u_ref, _ = tacc.setup("cpu", F64)
    c0 = torch.zeros(13, dtype=F64)
    c0[0:3] = torch.tensor([0.05, -0.03, 0.04], dtype=F64)
    c0[6:9] = sc.omega_des
    c0[12] = 1.0
    hist = rollout(tp, sc, w, tsp.MPCConfig(horizon=NT), SimConfig(steps=3, noise_mode="none"),
                   center_to_robot(sc.r, c0), x_ref, u_ref)
    return tp, sc, w, x_ref, u_ref, hist.state


def _jax_harness():
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import accuracy
    finally:
        sys.path.remove(str(REPO / "benchmarks"))
    return accuracy


def test_accuracy_same_state_legs_match_jax(recorded_states, tmp_path):
    from ft_mpc_torch.benchmarks import accuracy as tacc
    from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JADMM

    tp, sc, w, x_ref, u_ref, states = recorded_states
    _, fast, lanes = tacc.configs()
    u_ss = tacc.same_state_controls(tp, sc, w, fast, states, x_ref, u_ref)

    jacc = _jax_harness()
    jp = JBodyParams.default(0.1)
    cache = tmp_path / "terminal_cache"  # a copy: the JAX builder writes nothing of the repo
    shutil.copytree(REPO / "ft_mpc_tpu" / "config" / "terminal_cache", cache)
    jsc = _build_scenario_with_terminal(jp, [JBroken(10, 1.0), JBroken(11, 1.0)],
                                        DEFAULT_TUNING, cache_dir=str(cache))
    jfast = jsp.MPCConfig(horizon=NT, sqp_iters=2,
                          admm=JADMM(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
                          refine_iters=12, refine_tol=1e-4,
                          refine_admm=JADMM(iters=150, phases=6, rho=1.0))
    jw = jsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"])
    ref = jacc.same_state_controls(jp, jsc, jw, jfast, np_(states), jnp.asarray(np_(x_ref)),
                                   jnp.asarray(np_(u_ref)))
    np.testing.assert_allclose(u_ss, ref, rtol=0, atol=1e-8)

    f32 = lambda tree: tree_map(lambda x: x.float() if x is not None
                                and x.is_floating_point() else x, tree)
    u_lane = tacc.same_state_controls_lanes(f32(tp), f32(sc), f32(w), lanes, states.float(),
                                            x_ref.float(), u_ref.float())
    print(f"lanes leg vs the JAX per-scenario leg: {np.abs(u_lane - ref).max():.3e} N")
    np.testing.assert_allclose(u_lane, ref, rtol=0, atol=2e-2)
    assert u_lane.shape == (3, 16) and np.abs(u_lane[:, 10:12]).max() <= 1e-6


def test_accuracy_gates_follow_the_step_count():
    from ft_mpc_torch.benchmarks.accuracy import gates

    ok = {"steps": 120, "per_step_same_state_dev_N": [1.0] * 20 + [1e-3] * 100,
          "lanes_per_step_same_state_dev_N": [1.0] * 20 + [2e-3] * 100,
          "per_step_closed_loop_dev_N": [1.0] * 115 + [1e-3] * 5}
    assert gates(ok) == []
    bad = dict(ok, per_step_closed_loop_dev_N=[0.0] * 119 + [2e-3])
    assert len(gates(bad)) == 1
    short = {k: v[:30] if isinstance(v, list) else 30 for k, v in ok.items()}
    short["lanes_per_step_same_state_dev_N"] = [1.0] * 20 + [3e-2] * 10
    assert gates(short) == [gates(short)[0]] and "lanes" in gates(short)[0]
    assert gates({k: v[:20] if isinstance(v, list) else 20 for k, v in short.items()}) == []


def test_dummy_controller():
    from ft_mpc_torch.controllers.dummy import DummyController, dummy_control

    p = TBodyParams.default(0.1, F64, "cpu")
    ctl = DummyController(p, thruster=3, magnitude=0.5)
    u = ctl.get_control(np.zeros(13), 0.0)
    assert u.shape == (16,) and u[3] == 0.5 and u.sum() == 0.5
    assert len(ctl.history) == 1
    ctl.set_fault(TBroken(3, 1.0))
    uu = dummy_control(p, torch.zeros(13, dtype=F64), torch.tensor(0.0))
    assert uu.dtype == F64 and float(uu[12]) == 1.0 and float(uu.sum()) == 1.0


def test_phase_timer_and_annotation():
    """The program's span helper (its profiler range and its recorder's
    period totals; it replaced the phase timer and the bare annotation)
    and the logger."""
    from ft_mpc_torch.utils.logging import Logger, Recorder, span

    rec = Recorder()
    rec.close(rec.open("ft_mpc.setup_only"))
    for _ in range(2):
        step = rec.open("ft_mpc.step")
        solve = rec.open("ft_mpc.solve")
        time.sleep(0.01)
        rec.close(solve)
        rec.close(step)
    assert rec.setup.count("ft_mpc.setup_only") == 1
    assert [p.step for p in rec.periods()] == [0, 1]
    for p in rec.periods():
        assert p.count("ft_mpc.solve") == 1 and p.self_ns("ft_mpc.solve") >= 10**7
        assert p.self_ns("ft_mpc.step") == p.host_ns("ft_mpc.step") - p.host_ns("ft_mpc.solve")
    with torch.profiler.profile() as prof:
        with span("ft_mpc.test_range"):
            torch.ones(2) + 1
    assert any(e.key == "ft_mpc.test_range" for e in prof.key_averages())
    Logger("ft_mpc_torch.test").info("logger ok")
