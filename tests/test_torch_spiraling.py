"""The batched condensed control step (the slice as a whole) vs the JAX package.

`init_warmstart_batch` and two warm-chained `get_control_batch` steps run on
a 6-row snapshot bank (healthy, single and double faults) at horizon 8,
2 SQP iterations, 30x1 ADMM, 3 Newton steps and a k=2 cleanup, through the
JAX package (Pallas in interpret mode, x64) and through ft_mpc_torch on the
CPU (plain kernel versions, float64 outside the float32 kernels).

Tolerances: u_phys and wrench atol 2e-2 N, the JAX suite's own bar for two
backends of this step (`tests/test_lanes.py:174-178`); the assembly pieces
that involve no float32 kernel are held at 1e-10 (float64 on both sides).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.solvers import lanes_alloc as tla
from ft_mpc_torch.solvers import lanes_condense as tlc
from ft_mpc_torch.solvers import lanes_qp as tlq
from ft_mpc_torch.solvers import mpc_qp_stagewise as tsw
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig as TCfg
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from ft_mpc_tpu.utils import trajectory as jtraj
from torch_parity import F64, gentle_states, jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

Q = [1, 1, 1, 1, 1, 1, 2, 2, 2]  # DEFAULT_TUNING of the JAX package's api
R = [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]
ROWS = [0, 3, 10, 17, 22, 30]
NT = 8
TOL64 = dict(rtol=1e-10, atol=1e-10)


def _box_rate():
    """A state box on the x velocity and a wrench-rate bound (tests of the
    JAX package's state bounds use the same kind of rows)."""
    x_lb = np.full(13, -1e8)
    x_ub = np.full(13, 1e8)
    x_lb[3], x_ub[3] = -0.3, 0.3
    return dict(x_lb=x_lb, x_ub=x_ub, du_max=np.full(6, 0.5))


def _configs():
    kw = dict(horizon=NT, sqp_iters=2, newton_iters=3, cleanup_iters=40,
              cleanup_k=2, cleanup_phases=2)
    admm = dict(iters=30, phases=1, rho=50.0, adapt_clip=1.5)
    return jsp.MPCConfig(admm=JCfg(**admm), **kw), tsp.MPCConfig(admm=TCfg(**admm), **kw)


def _refs(horizon=NT):
    traj = ttraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = ttraj.prepare_center_trajectory(
        traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, horizon + 1
    )
    return x_ref[: horizon + 1], u_ref[: horizon + 1]


def _setup(bounds: dict):
    flat = load_flat(ROWS)
    jw = jsp.MPCWeights.from_diagonals(Q, R, **bounds)
    tw = tsp.MPCWeights.from_diagonals(Q, R, **bounds, dtype=F64, device="cpu")
    return dict(
        flat=flat, jbank=jax_bank(flat), tbank=torch_bank(flat),
        jp=JBodyParams.default(0.1), tp=TBodyParams.default(0.1, dtype=F64, device="cpu"),
        jw=jw, tw=tw, x0=gentle_states(len(ROWS)),
    )


def test_trajectory_copy_matches_jax_package():
    for shape in ("hover", "generate_line", "generate_sin", "generate_circle"):
        a = ttraj.generate_trajectory(shape, 0.1, 3)
        b = jtraj.generate_trajectory(shape, 0.1, 3)
        np.testing.assert_array_equal(a, b)
        pa = ttraj.prepare_center_trajectory(a, np.array([0.1, 0.2, 0.6]), 16.8, 0.1, 16)
        pb = jtraj.prepare_center_trajectory(b, np.array([0.1, 0.2, 0.6]), 16.8, 0.1, 16)
        for u, v in zip(pa, pb):
            np.testing.assert_array_equal(u, v)


def test_masked_geometry_and_ext_rows_match_jax(rng):
    s = _setup(_box_rate())
    B = len(ROWS)
    ref = jax.vmap(jsp._masked_geometry)(s["jbank"])
    out = tsp._masked_geometry(s["tbank"])
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    assert tsp.n_extra_rows(s["tw"], NT) == jsp.n_extra_rows(s["jw"], NT) == 2 * 19 * (NT - 1)
    X = rng.standard_normal((B, NT + 1, 13))
    S_all = rng.standard_normal((B, NT, 13, 6 * NT))
    phi = rng.standard_normal((B, NT, 13))
    off = rng.standard_normal((B, NT, 6))
    G_ref, h_ref = jax.vmap(lambda *a: jsp._ext_rows(s["jw"], *a))(
        jnp.asarray(X), jnp.asarray(S_all), jnp.asarray(phi), jnp.asarray(off)
    )
    G, h = tsp._ext_rows(s["tw"], t64(X), t64(S_all), t64(phi), t64(off))
    np.testing.assert_allclose(np_(G), np.asarray(G_ref), **TOL64)
    np.testing.assert_allclose(np_(h), np.asarray(h_ref), **TOL64)


# jitted as bench.py runs them (a quarter of the eager time on the CPU)
_jax_init = jax.jit(jsp.init_warmstart_batch, static_argnums=(3,))
_jax_step = jax.jit(jsp.get_control_batch, static_argnums=(3,))


def _run_jax(s, cfg, x_ref, u_ref):
    x0 = jnp.asarray(s["x0"])
    c0 = jax.vmap(j_robot_to_center)(s["jbank"].r, x0)
    args = (s["jp"], s["jbank"], s["jw"], cfg)
    warm = _jax_init(*args, c0, x_ref, u_ref)
    out1 = _jax_step(*args, x0, x_ref, u_ref, warm)
    out2 = _jax_step(*args, x0, x_ref, u_ref, out1.warm)
    return warm, out1, out2


def _run_torch(s, cfg, x_ref, u_ref):
    x0 = t64(s["x0"])
    c0 = t_robot_to_center(s["tbank"].r, x0)
    args = (s["tp"], s["tbank"], s["tw"], cfg)
    warm = tsp.init_warmstart_batch(*args, c0, x_ref, u_ref)
    out1 = tsp.get_control_batch(*args, x0, x_ref, u_ref, warm)
    out2 = tsp.get_control_batch(*args, x0, x_ref, u_ref, out1.warm)
    return warm, out1, out2


@pytest.mark.parametrize("bounds", [{}, _box_rate()], ids=["terminal-only", "box-and-rate"])
def test_control_step_matches_jax(bounds):
    """Cold warm start, then two chained steps (the second on the carried
    Newton-refreshed metric) through both packages."""
    s = _setup(bounds)
    jcfg, tcfg = _configs()
    x_ref, u_ref = _refs()
    launches = (tlc.condense_lanes.launches, tlq.admm_lanes.launches,
                tla.allocate_thrusters_lanes.launches)
    jw0, j1, j2 = _run_jax(s, jcfg, jnp.asarray(x_ref), jnp.asarray(u_ref))
    tw0, t1, t2 = _run_torch(s, tcfg, t64(x_ref), t64(u_ref))
    # on the CPU every wrapper runs its plain version: no kernel launches
    assert launches == (tlc.condense_lanes.launches, tlq.admm_lanes.launches,
                        tla.allocate_thrusters_lanes.launches)

    # warm start: float64 rollout; the cold metric is a float32 Cholesky
    np.testing.assert_allclose(np_(tw0.X), np.asarray(jw0.X), **TOL64)
    scale = np.abs(np.asarray(jw0.kinv)).max()
    np.testing.assert_allclose(np_(tw0.kinv), np.asarray(jw0.kinv), atol=1e-4 * scale)

    for t, j in ((t1, j1), (t2, j2)):
        assert t.u_phys.dtype == F64 and torch.isfinite(t.u_phys).all()
        np.testing.assert_allclose(np_(t.u_phys), np.asarray(j.u_phys), atol=2e-2)
        np.testing.assert_allclose(np_(t.wrench), np.asarray(j.wrench), atol=2e-2)
        np.testing.assert_allclose(np_(t.c0), np.asarray(j.c0), **TOL64)
        # warm trajectory: the SQP steps agree to the ADMM iterates' float32
        # class, propagated through the 8-stage rollout
        np.testing.assert_allclose(np_(t.warm.X), np.asarray(j.warm.X), atol=2e-3)
        np.testing.assert_allclose(np_(t.warm.U), np.asarray(j.warm.U), atol=2e-2)
        # diagnostics: residuals of truncated (30-iteration) ADMM runs that
        # agree to float32 rounding; rho moves by sqrt of their ratio
        np.testing.assert_allclose(np_(t.info.r_prim), np.asarray(j.info.r_prim),
                                   rtol=5e-2, atol=1e-3)
        np.testing.assert_allclose(np_(t.info.du_norm), np.asarray(j.info.du_norm),
                                   rtol=5e-2, atol=1e-3)
        np.testing.assert_allclose(np_(t.info.defect), np.asarray(j.info.defect),
                                   rtol=5e-2, atol=1e-4)
        np.testing.assert_allclose(np_(t.info.term_gap), np.asarray(j.info.term_gap),
                                   atol=1e-3)
        np.testing.assert_allclose(np_(t.info.cost), np.asarray(j.info.cost), rtol=1e-2)
        np.testing.assert_allclose(np_(t.warm.rho), np.asarray(j.warm.rho), rtol=5e-2)
        np.testing.assert_array_equal(np_(t.alloc.was_clipped), np.asarray(j.alloc.was_clipped))


def test_controller_module_matches_functions():
    s = _setup({})
    _, tcfg = _configs()
    x_ref, u_ref = (t64(a) for a in _refs())
    ctrl = tsp.BatchSpiralingController(s["tp"], s["tbank"], s["tw"], tcfg, device="cpu")
    x0 = t64(s["x0"])
    warm = ctrl.init_warmstart(x0, x_ref, u_ref)
    out = ctrl(x0, x_ref, u_ref, warm)
    _, ref, _ = _run_torch(s, tcfg, x_ref, u_ref)
    np.testing.assert_array_equal(np_(out.u_phys), np_(ref.u_phys))
    assert {n for n, _ in ctrl.named_buffers()} >= {"bank_0", "params_0", "weights_0"}


@pytest.mark.parametrize("backend", ["condensed", "stagewise"])
def test_cleanup_resolves_only_the_ranked_rows(backend):
    """The worst-K cleanup at B=8, K=2: the rows it does not rank are those
    of a run without it, bit for bit; the two it ranks (on r_prim + du_norm
    + defect of that run) carry one SQP iteration of the backend's own scan
    at the cleanup's budget from their duals and rho, with an exact metric
    where the backend has one."""
    rows, K = ROWS + [5, 8], 2
    bank, params = torch_bank(load_flat(rows)), TBodyParams.default(0.1, dtype=F64, device="cpu")
    weights = tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu")
    admm = TCfg(iters=30, phases=1, rho=50.0, adapt_clip=1.5)
    stagewise = tsw.StagewiseConfig(iters=20, phases=1, mode="lanes")
    cfg = tsp.MPCConfig(horizon=NT, sqp_iters=2, qp_backend=backend, admm=admm,
                        stagewise=stagewise, newton_iters=3, cleanup_iters=40, cleanup_k=K,
                        cleanup_phases=2)
    x_ref, u_ref = (t64(a) for a in _refs())
    c0 = t_robot_to_center(bank.r, t64(gentle_states(len(rows))))
    warm = tsp.init_warmstart_batch(params, bank, weights, cfg, c0, x_ref, u_ref)
    solve = tsp.sqp_solve_batch if backend == "condensed" else tsp.sqp_solve_batch_stagewise
    args = (params, bank, weights)
    got_w, got_i = solve(*args, cfg, c0, x_ref, u_ref, warm)
    ref_w, ref_i = solve(*args, cfg._replace(cleanup_rounds=0), c0, x_ref, u_ref, warm)

    _, idx = torch.topk(ref_i.r_prim + ref_i.du_norm + ref_i.defect, K)
    rest = torch.ones(len(rows), dtype=torch.bool)
    rest[idx] = False
    for name, a, b in zip(got_w._fields + got_i._fields, got_w + got_i, ref_w + ref_i):
        if a is None:
            assert b is None and name == "kinv" and backend == "stagewise"
            continue
        assert torch.equal(a[rest], b[rest]), name

    budget = dict(iters=40, phases=2, adapt_clip=5.0)
    ccfg = cfg._replace(sqp_iters=1, cleanup_iters=0, admm=admm._replace(**budget),
                        stagewise=stagewise._replace(**budget))
    sub = (tsp._params_row(params, tsp.params_batch_axes(params), idx),
           tsp.take_rows(bank, idx), weights, ccfg, c0[idx], x_ref, u_ref,
           tsp._rows(ref_w._replace(kinv=None), idx))
    if backend == "condensed":
        want_w, want_i = tsp._sqp_scan(*sub, qp_step=tsp._qp_condensed_lanes)
        # an exact metric, refactored at each phase's rho: the last one's
        assert not torch.equal(got_w.kinv[idx], ref_w.kinv[idx])
    else:
        want_w, want_i = tsp._sqp_batch_stagewise_core(*sub)
    for name, a, b in zip(want_w._fields + want_i._fields, got_w + got_i, want_w + want_i):
        if b is not None and name != "cost":
            assert torch.equal(a[idx], b), name
    assert not torch.equal(got_w.U[idx], ref_w.U[idx])


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, an entry point that was not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TBodyParams.default(0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.MPCWeights.from_diagonals(Q, R)
    assert TBodyParams.default(0.1, device="cpu").D.device.type == "cpu"
