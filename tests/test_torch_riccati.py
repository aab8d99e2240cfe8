"""The Riccati factorization and re-solve of ft_mpc_torch vs the JAX package.

Same numpy inputs (seeded) through `ft_mpc_tpu.solvers.riccati` /
`lanes_riccati` and their counterparts in the port, on the CPU.

Tolerances: float64 on both sides, atol 1e-10 (pure functions, same order of
operations); against the port's own `lqr_solve(mode='scan')` oracle 1e-9 (a
different recursion for the same optimum); `lqr_resolve_lanes` float32 on
both sides (the JAX Pallas kernels in interpret mode, the port's plain
sweeps), atol 2e-5, the class of `tests/test_stagewise.py:399-401`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.convert import flatten_namedtuple, lqr_factorization_from_numpy
from ft_mpc_torch.solvers import lanes_riccati as tl
from ft_mpc_torch.solvers import riccati as tr
from ft_mpc_tpu.solvers import lanes_riccati as jl
from ft_mpc_tpu.solvers import riccati as jr
from torch_parity import F64, np_, t64

torch.set_num_threads(1)

N, M = 13, 6


def lqr_data(rng, B, Nt):
    """A well-posed random LQR: stable-ish A, PD stage costs per scenario."""
    A = 0.95 * np.eye(N) + 0.05 * rng.standard_normal((B, Nt, N, N))
    Bm = 0.3 * rng.standard_normal((B, Nt, N, M))
    c = 0.05 * rng.standard_normal((B, Nt, N))
    Lq = 0.2 * rng.standard_normal((B, N, N))
    Lr = 0.2 * rng.standard_normal((B, M, M))
    Q = 0.5 * np.eye(N) + Lq @ Lq.transpose(0, 2, 1)
    R = 0.2 * np.eye(M) + Lr @ Lr.transpose(0, 2, 1)
    QN = np.eye(N) + Lq.transpose(0, 2, 1) @ Lq
    lin = dict(q=rng.standard_normal((B, Nt, N)), r=rng.standard_normal((B, Nt, M)),
               qN=rng.standard_normal((B, N)), x0=rng.standard_normal((B, N)))
    return (A, Bm, c, Q, R, QN), lin


@pytest.mark.parametrize("stage_costs", [False, True], ids=["Q-const", "Q-per-stage"])
def test_factor_and_resolve_match_jax_f64(rng, stage_costs):
    B, Nt = 3, 14
    quad, lin = lqr_data(rng, B, Nt)
    if stage_costs:  # (B, Nt, n, n) costs that differ by stage
        scale = 1.0 + 0.1 * np.arange(Nt)[None, :, None, None]
        quad = quad[:3] + (quad[3][:, None] * scale, quad[4][:, None] * scale, quad[5])
    jfact = jax.vmap(jr.lqr_factor)(*map(jnp.asarray, quad))
    tfact = tr.lqr_factor(*map(t64, quad))
    for name, a, b in zip(tfact._fields, tfact, jfact):
        assert a.dtype == F64
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-10, err_msg=name)
    jX, jU = jax.vmap(jr.lqr_resolve)(jfact, *(jnp.asarray(lin[k]) for k in ("q", "r", "qN", "x0")))
    # the factorization crosses over as numpy leaves, as the data bridge carries it
    carried = lqr_factorization_from_numpy(flatten_namedtuple(jfact), device="cpu")
    tX, tU = tr.lqr_resolve(carried, *(t64(lin[k]) for k in ("q", "r", "qN", "x0")))
    np.testing.assert_allclose(np_(tX), np.asarray(jX), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np_(tU), np.asarray(jU), rtol=0, atol=1e-10)


def test_unbatched_factor_matches_jax_f64(rng):
    quad, lin = lqr_data(rng, 1, 7)
    quad = [a[0] for a in quad]
    jfact = jr.lqr_factor(*map(jnp.asarray, quad))
    tfact = tr.lqr_factor(*map(t64, quad))
    for a, b in zip(tfact, jfact):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-10)
    args = [lin[k][0] for k in ("q", "r", "qN", "x0")]
    jX, jU = jr.lqr_resolve(jfact, *map(jnp.asarray, args))
    tX, tU = tr.lqr_resolve(tfact, *map(t64, args))
    np.testing.assert_allclose(np_(tX), np.asarray(jX), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np_(tU), np.asarray(jU), rtol=0, atol=1e-10)


def test_factor_resolve_matches_scan_oracle(rng):
    """`lqr_factor` + `lqr_resolve` solve the same LQR as the classic sweep
    `lqr_solve(mode='scan')`, which shares no code with them; the oracle
    itself is held against the JAX one."""
    B, Nt = 2, 16
    (A, Bm, c, Q, R, QN), lin = lqr_data(rng, B, Nt)
    Qs, Rs = np.broadcast_to(Q[:, None], (B, Nt, N, N)), np.broadcast_to(R[:, None], (B, Nt, M, M))
    prob = tr.LQRProblem(*map(t64, (A, Bm, c, Qs, lin["q"], Rs, lin["r"], QN,
                                    lin["qN"], lin["x0"])))
    sol = tr.lqr_solve(prob)
    fact = tr.lqr_factor(*map(t64, (A, Bm, c, Q, R, QN)))
    X, U = tr.lqr_resolve(fact, *(t64(lin[k]) for k in ("q", "r", "qN", "x0")))
    np.testing.assert_allclose(np_(X), np_(sol.X), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np_(U), np_(sol.U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np_(fact.P), np_(sol.P), rtol=0, atol=1e-9)

    jprob = jr.LQRProblem(*(jnp.asarray(np_(x)) for x in prob))
    jsol = jax.vmap(jr.lqr_solve)(jprob)
    for a, b in zip(sol, jsol):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=1e-10)
    # the associative-scan solve reaches the same optimum
    # (tests/test_torch_riccati_assoc.py holds it against the JAX package)
    assoc = tr.lqr_solve(prob, mode="assoc")
    for a, b in zip(assoc, sol):
        np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=1e-9)


@pytest.mark.parametrize("B", [3, 1])
def test_resolve_lanes_matches_jax_kernels(rng, B):
    """float32 in, non-zero x0 and qN: the port's plain sweeps vs the JAX
    Pallas kernels in interpret mode."""
    Nt = 20
    quad, lin = lqr_data(rng, B, Nt)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    jfact = jax.vmap(jr.lqr_factor)(*(jnp.asarray(a, jnp.float32) for a in quad))
    tfact = tr.LQRFactorization(*(f32(a) for a in jfact))
    names = ("q", "r", "qN", "x0")
    jX, jU = jl.lqr_resolve_lanes(jfact, *(jnp.asarray(lin[k], jnp.float32) for k in names))
    n0 = (tl.riccati_bwd_lanes.launches, tl.riccati_fwd_lanes.launches)
    tX, tU = tl.lqr_resolve_lanes(tfact, *(f32(lin[k]) for k in names))
    # CPU tensors run the plain sweeps: no kernel launch is counted
    assert n0 == (tl.riccati_bwd_lanes.launches, tl.riccati_fwd_lanes.launches)
    assert tX.shape == (B, Nt + 1, N) and tU.shape == (B, Nt, M)
    assert tX.dtype == torch.float32
    np.testing.assert_allclose(np_(tX), np.asarray(jX), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(tU), np.asarray(jU), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(np_(tX[:, 0]), lin["x0"].astype(np.float32))


def test_resolve_lanes_casts_back_to_input_dtype(rng):
    quad, lin = lqr_data(rng, 2, 9)
    fact = tr.lqr_factor(*map(t64, quad))
    args = [t64(lin[k]) for k in ("q", "r", "qN", "x0")]
    X, U = tl.lqr_resolve_lanes(fact, *args)
    assert X.dtype == F64 and U.dtype == F64
    X64, U64 = tr.lqr_resolve(fact, *args)
    # float32 inside: agrees with the float64 re-solve to float32 rounding
    np.testing.assert_allclose(np_(X), np_(X64), rtol=0, atol=2e-5)
    np.testing.assert_allclose(np_(U), np_(U64), rtol=0, atol=2e-5)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """The launchers never fall back: a CPU tensor is refused, not served by
    the plain version (only `lqr_resolve_lanes` routes by device)."""
    quad, lin = lqr_data(rng, 1, 4)
    f = tr.LQRFactorization(*(x.float() for x in tr.lqr_factor(*map(t64, quad))))
    q, r, qN, x0 = (t64(lin[k]).float() for k in ("q", "r", "qN", "x0"))
    with pytest.raises(ValueError, match="riccati_bwd_lanes: tensor on cpu"):
        tl.riccati_bwd_lanes(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
    with pytest.raises(ValueError, match="riccati_fwd_lanes: tensor on cpu"):
        tl.riccati_fwd_lanes(f.F, f.B, f.c, f.K, torch.zeros(1, 4, M), x0)
