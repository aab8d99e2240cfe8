"""The associative-scan Riccati variants of ft_mpc_torch vs the JAX package.

Same numpy inputs (seeded) through `ft_mpc_tpu.solvers.riccati` (x64) and
the port's log-depth scans on the CPU in float64: `lqr_solve(mode='assoc')`,
`lqr_factor_assoc`, `lqr_resolve_assoc`, and the per-scenario stagewise
solver in modes 'assoc' and 'scan-assoc'.

Tolerance: 1e-8 absolute, float64 on both sides (the scans combine in the
same order as `jax.lax.associative_scan`; the remaining difference is the
LU inverses' rounding).  Horizons cover odd and even lengths and one stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.convert import stagewise_qp_from_numpy
from ft_mpc_torch.solvers import mpc_qp_stagewise as tsw
from ft_mpc_torch.solvers import riccati as tr
from ft_mpc_tpu.solvers import mpc_qp_stagewise as jsw
from ft_mpc_tpu.solvers import riccati as jr
from test_torch_riccati import M, N, lqr_data
from test_torch_stagewise import jax_qp, synthetic_qp
from torch_parity import F64, np_, t64

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-8)
LIN = ("q", "r", "qN", "x0")

# jitted: eager JAX dispatches every op of the scans on its own
_j_solve = jax.jit(jax.vmap(lambda p: jr.lqr_solve(p, mode="assoc")))
_j_factor = jax.jit(jax.vmap(jr.lqr_factor_assoc))
_j_resolve = jax.jit(jax.vmap(jr.lqr_resolve_assoc))


def _problem(quad, lin):
    """(torch LQRProblem, JAX LQRProblem) with stage costs on every stage."""
    A, Bm, c, Q, R, QN = quad
    B, Nt = A.shape[:2]
    Qs = np.broadcast_to(Q[:, None], (B, Nt, N, N))
    Rs = np.broadcast_to(R[:, None], (B, Nt, M, M))
    leaves = (A, Bm, c, Qs, lin["q"], Rs, lin["r"], QN, lin["qN"], lin["x0"])
    return tr.LQRProblem(*map(t64, leaves)), jr.LQRProblem(*map(jnp.asarray, leaves))


@pytest.mark.parametrize("Nt", [1, 7, 16])
def test_lqr_solve_assoc_matches_jax(rng, Nt):
    quad, lin = lqr_data(rng, 3, Nt)
    prob, jprob = _problem(quad, lin)
    sol = tr.lqr_solve(prob, mode="assoc")
    jsol = _j_solve(jprob)
    for name, a, b in zip(sol._fields, sol, jsol):
        assert a.dtype == F64
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL, err_msg=name)
    # the same optimum as the sequential sweep
    seq = tr.lqr_solve(prob, mode="scan")
    np.testing.assert_allclose(np_(sol.X), np_(seq.X), **TOL)
    np.testing.assert_allclose(np_(sol.U), np_(seq.U), **TOL)
    with pytest.raises(ValueError, match="unknown mode"):
        tr.lqr_solve(prob, mode="banded")


@pytest.mark.parametrize("Nt", [1, 9, 14])
def test_factor_and_resolve_assoc_match_jax(rng, Nt):
    quad, lin = lqr_data(rng, 2, Nt)
    fact = tr.lqr_factor_assoc(*map(t64, quad))
    jfact = _j_factor(*map(jnp.asarray, quad))
    for name, a, b in zip(fact._fields, fact, jfact):
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL, err_msg=name)
    X, U = tr.lqr_resolve_assoc(fact, *(t64(lin[k]) for k in LIN))
    jX, jU = _j_resolve(jfact, *(jnp.asarray(lin[k]) for k in LIN))
    np.testing.assert_allclose(np_(X), np.asarray(jX), **TOL)
    np.testing.assert_allclose(np_(U), np.asarray(jU), **TOL)
    # against the sequential factorization and re-solve
    seq = tr.lqr_factor(*map(t64, quad))
    np.testing.assert_allclose(np_(fact.P), np_(seq.P), **TOL)
    Xs, Us = tr.lqr_resolve(seq, *(t64(lin[k]) for k in LIN))
    np.testing.assert_allclose(np_(X), np_(Xs), **TOL)
    np.testing.assert_allclose(np_(U), np_(Us), **TOL)


def test_assoc_variants_take_one_scenario(rng):
    """No batch axis, as the JAX functions take them."""
    quad, lin = lqr_data(rng, 1, 6)
    quad = [a[0] for a in quad]
    args = [lin[k][0] for k in LIN]
    fact = tr.lqr_factor_assoc(*map(t64, quad))
    jfact = jax.jit(jr.lqr_factor_assoc)(*map(jnp.asarray, quad))
    np.testing.assert_allclose(np_(fact.K), np.asarray(jfact.K), **TOL)
    X, U = tr.lqr_resolve_assoc(fact, *map(t64, args))
    jX, jU = jax.jit(jr.lqr_resolve_assoc)(jfact, *map(jnp.asarray, args))
    assert X.shape == (7, N) and U.shape == (6, M)
    np.testing.assert_allclose(np_(X), np.asarray(jX), **TOL)
    np.testing.assert_allclose(np_(U), np.asarray(jU), **TOL)


@pytest.mark.parametrize("mode", ["assoc", "scan-assoc"])
@pytest.mark.parametrize("case", ["plain", "state-rows", "infeasible-terminal"])
def test_stagewise_assoc_modes_match_jax(mode, case):
    rng = np.random.default_rng(5)
    flat = synthetic_qp(rng, box=case == "state-rows",
                        infeasible=case == "infeasible-terminal")
    kw = dict(iters=30, phases=2, rho=10.0, elastic_y_max=1e2, mode=mode)
    jsol = jsw.solve_mpc_qp_stagewise(jax_qp(flat), jsw.StagewiseConfig(**kw))
    tqp = stagewise_qp_from_numpy(flat, device="cpu", dtype=F64)
    tsol = tsw.solve_mpc_qp_stagewise(tqp, tsw.StagewiseConfig(**kw))
    for name in tsol._fields:
        np.testing.assert_allclose(np_(getattr(tsol, name)), np.asarray(getattr(jsol, name)),
                                   **TOL, err_msg=name)
