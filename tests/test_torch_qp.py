"""Kernel 2 (ADMM) and the batched QP solve vs the JAX package.

The same numpy QPs go through the JAX lane-fused path (Pallas in interpret
mode) and through ft_mpc_torch on the CPU (plain ADMM).  Tolerances:
x atol 5e-5 and y_hull atol 5e-4 are the JAX suite's own class for its
fp32 kernel against the XLA path (`tests/test_lanes.py:61-64`); term_gap
atol 1e-3 as `tests/test_lanes.py:276`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.solvers import lanes_qp as tlq
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig as TCfg
from ft_mpc_torch.solvers.mpc_qp import StructuredMPCQP as TQP
from ft_mpc_tpu.solvers import lanes_qp as jlq
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from ft_mpc_tpu.solvers.mpc_qp import StructuredMPCQP as JQP
from torch_parity import np_, t64

torch.set_num_threads(1)

F32 = torch.float32


def random_qp(rng, B=4, Nt=15, F=32, T=64):
    """Numpy twin of tests/test_lanes.py:random_structured_qp."""
    n = Nt * 6
    Hq = rng.standard_normal((B, n, 24)).astype(np.float32)
    H = np.einsum("bik,bjk->bij", Hq, Hq) * 0.1 + 2.0 * np.eye(n, dtype=np.float32)
    g = rng.standard_normal((B, n)).astype(np.float32)
    hull_A = rng.standard_normal((B, F, 6)).astype(np.float32)
    h_hull = (np.abs(rng.standard_normal((B, Nt, F))) + 0.5).astype(np.float32)
    G_term = (rng.standard_normal((B, T, n)) * 0.1).astype(np.float32)
    h_term = (np.abs(rng.standard_normal((B, T))) + 0.5).astype(np.float32)
    return [a.astype(np.float64) for a in (H, g, hull_A, h_hull, G_term, h_term)]


def pair(arrs):
    return JQP(*[jnp.asarray(a) for a in arrs]), TQP(*[t64(a) for a in arrs])


def jcfg(**kw):
    return JCfg(**kw), TCfg(**kw)


def test_build_K_and_exact_kinv(rng):
    jq, tq = pair(random_qp(rng))
    rho = np.array([0.5, 1.0, 20.0, 300.0])
    K_ref, M_ref = jlq.build_K(jq, jnp.asarray(rho, jnp.float32), 1e-6)
    K, M = tlq.build_K(tq, torch.as_tensor(rho, dtype=F32), 1e-6)
    assert K.dtype == F32
    np.testing.assert_allclose(np_(M), np.asarray(M_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(K), np.asarray(K_ref), rtol=1e-6, atol=1e-5)
    Ki = tlq.exact_kinv(K)
    Ki_ref = jlq.exact_kinv(jnp.asarray(np_(K)))
    # float32 Cholesky on both sides; relative to the inverse's scale
    scale = np.abs(np.asarray(Ki_ref)).max()
    np.testing.assert_allclose(np_(Ki), np.asarray(Ki_ref), atol=1e-4 * scale)


def test_exact_kinv_failed_factorization_is_nan():
    K = torch.eye(6).repeat(2, 1, 1)
    K[1, 2, 2] = -1.0
    Ki = tlq.exact_kinv(K)
    assert torch.isfinite(Ki[0]).all() and torch.isnan(Ki[1]).all()


def _to_lanes(x):
    return jnp.moveaxis(jnp.asarray(x), 0, -1)


@pytest.mark.parametrize(
    "T,elastic", [(64, 0.0), (64, 1e3), (160, 1e3)], ids=["hard", "elastic", "elastic-T160"]
)
def test_admm_lanes_matches_jax(rng, T, elastic):
    """Identical K^{-1} and inputs through both kernels' CPU paths (the
    JAX wrapper takes whole 128-scenario lane tiles)."""
    H, g, hA, hh, Gt, ht = random_qp(rng, B=128, T=T)
    B, n = g.shape
    Nt, F = hh.shape[1:]
    rho = rng.uniform(1.0, 5.0, B)
    K = H + 1e-6 * np.eye(n) + rho[:, None, None] * (
        np.einsum("st,bij->bsitj", np.eye(Nt), np.einsum("bfi,bfj->bij", hA, hA)).reshape(B, n, n)
        + np.einsum("bti,btj->bij", Gt, Gt)
    )
    Kinv = np.linalg.inv(K).astype(np.float32).astype(np.float64)
    x0 = rng.standard_normal((B, n)) * 0.1
    zh0 = np.minimum(0.0, hh)
    zt0 = np.minimum(0.0, ht)
    yh0 = np.abs(rng.standard_normal((B, Nt, F))) * 0.1
    yt0 = np.abs(rng.standard_normal((B, T))) * 0.1
    args = (Kinv, hA, hh, Gt, ht, g, x0, zh0, zt0, yh0, yt0)
    ref = jlq.admm_lanes(*[_to_lanes(a) for a in args], jnp.asarray(rho),
                         1e-6, 1.6, 40, elastic)
    ref = [np.moveaxis(np.asarray(r), -1, 0) for r in ref]
    out = tlq.admm_lanes(*[t64(a) for a in args], t64(rho), 1e-6, 1.6, 40, elastic)
    assert all(o.dtype == F32 for o in out)
    np.testing.assert_allclose(np_(out[0]), ref[0], atol=5e-5)  # x
    np.testing.assert_allclose(np_(out[3]), ref[3], atol=5e-4)  # y_hull
    np.testing.assert_allclose(np_(out[4]), ref[4], atol=5e-4)  # y_term
    np.testing.assert_allclose(np_(out[1]), ref[1], atol=5e-4)  # z_hull
    np.testing.assert_allclose(np_(out[2]), ref[2], atol=5e-4)  # z_term


def test_solve_cold_matches_jax(rng):
    jq, tq = pair(random_qp(rng))
    jc, tc = jcfg(iters=50, phases=2, rho=1.0)
    ref = jlq.solve_mpc_qp_lanes(jq, jc)
    out = tlq.solve_mpc_qp_lanes(tq, tc)
    np.testing.assert_allclose(np_(out.x), np.asarray(ref.x), atol=5e-5)
    np.testing.assert_allclose(np_(out.y_hull), np.asarray(ref.y_hull), atol=5e-4)
    np.testing.assert_allclose(np_(out.y_term), np.asarray(ref.y_term), atol=5e-4)
    # residual diagnostics: same formulas on iterates that agree to 5e-5;
    # rho moves by sqrt of their ratio, so it inherits half their spread
    np.testing.assert_allclose(np_(out.r_prim), np.asarray(ref.r_prim), rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(np_(out.r_dual), np.asarray(ref.r_dual), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(np_(out.rho), np.asarray(ref.rho), rtol=5e-3)


def test_solve_warm_newton_matches_jax(rng):
    """Warm start: duals + rho + a carried inverse refreshed by Newton."""
    arrs = random_qp(rng)
    jq, tq = pair(arrs)
    jc2, tc2 = jcfg(iters=50, phases=2, rho=1.0)
    cold_j = jlq.solve_mpc_qp_lanes(jq, jc2)
    cold_t = tlq.solve_mpc_qp_lanes(tq, tc2)
    H = arrs[0]
    arrs2 = [H + 0.01 * np.einsum("bik,bjk->bij", H[:, :, :4], H[:, :, :4])] + arrs[1:]
    jq2, tq2 = pair(arrs2)
    jc1, tc1 = jcfg(iters=50, phases=1, rho=1.0, adapt_clip=1.5)
    kinv0 = np.asarray(cold_j.kinv)
    ref = jlq.solve_mpc_qp_lanes(
        jq2, jc1, y_hull0=cold_j.y_hull, y_term0=cold_j.y_term, rho0=cold_j.rho,
        kinv0=jnp.asarray(kinv0), newton_iters=3,
    )
    out = tlq.solve_mpc_qp_lanes(
        tq2, tc1, y_hull0=t64(cold_j.y_hull), y_term0=t64(cold_j.y_term),
        rho0=torch.as_tensor(np.asarray(cold_j.rho)), kinv0=torch.as_tensor(kinv0),
        newton_iters=3,
    )
    # Newton-refreshed metrics differ by float32 matmul rounding (XLA vs
    # torch) amplified by cond(K); iterates agree well inside the warm
    # refresh's own accuracy class (5e-3 in tests/test_lanes.py:86-88)
    np.testing.assert_allclose(np_(out.x), np.asarray(ref.x), atol=5e-4)
    np.testing.assert_allclose(np_(out.kinv), np.asarray(ref.kinv),
                               atol=1e-3 * np.abs(kinv0).max())
    np.testing.assert_allclose(np_(cold_t.x), np.asarray(cold_j.x), atol=5e-5)


def test_newton_kinv_refresh_and_rescue(rng):
    n, B = 90, 3
    Ls = rng.standard_normal((B, n, n)).astype(np.float32) * 0.3
    K = np.einsum("bik,bjk->bij", Ls, Ls) + 3 * np.eye(n, dtype=np.float32)
    Kt = torch.as_tensor(K)
    kinv = tlq.exact_kinv(Kt)
    eye = np.eye(n)
    # warm refresh after a bounded drift: contracts, matches JAX
    X = tlq.newton_kinv(Kt * 1.3, kinv, 3)
    X_ref = jlq.newton_kinv(jnp.asarray(K * 1.3), jnp.asarray(np_(kinv)), 3)
    assert np.abs(np.einsum("bij,bjk->bik", K * 1.3, np_(X)) - eye).max() < 1e-3
    np.testing.assert_allclose(np_(X), np.asarray(X_ref), atol=1e-4 * np.abs(np_(X)).max())
    # garbage warm start -> whole-batch exact refactor on both sides
    X_bad = tlq.newton_kinv(Kt, -5.0 * kinv, 3)
    X_bad_ref = jlq.newton_kinv(jnp.asarray(K), jnp.asarray(-5.0 * np_(kinv)), 3)
    assert np.isfinite(np_(X_bad)).all()
    exact = np_(tlq.exact_kinv(Kt))
    np.testing.assert_allclose(np_(X_bad), exact, atol=1e-5 * np.abs(exact).max())
    np.testing.assert_allclose(np_(X_bad), np.asarray(X_bad_ref),
                               atol=1e-4 * np.abs(np_(X_bad)).max())
    # a non-finite warm start triggers the rescue too
    X_nan = tlq.newton_kinv(Kt, kinv * torch.nan, 3)
    assert np.isfinite(np_(X_nan)).all()


def test_elastic_infeasible_term_gap(rng):
    """Contradictory terminal rows: elastic mode converges and reports the
    minimum violation as term_gap, as the JAX lane path does."""
    arrs = random_qp(rng, B=2, T=4)
    n = arrs[1].shape[1]
    row = np.zeros((2, 4, n))
    row[:, 0, 0] = 1.0  # x_0 <= -1
    row[:, 1, 0] = -1.0  # x_0 >= 1
    ht = np.full((2, 4), 1e8)
    ht[:, :2] = -1.0
    arrs[4], arrs[5] = row, ht
    jq, tq = pair(arrs)
    jc, tc = jcfg(iters=400, phases=3, rho=10.0, elastic_y_max=1e3)
    ref = jlq.solve_mpc_qp_lanes(jq, jc)
    out = tlq.solve_mpc_qp_lanes(tq, tc)
    assert float(out.r_prim.max()) < 1e-2
    assert 0.5 < float(out.term_gap.min()) < 1.6
    np.testing.assert_allclose(np_(out.term_gap), np.asarray(ref.term_gap), atol=1e-3)
    np.testing.assert_allclose(np_(out.x), np.asarray(ref.x), atol=5e-4)
