"""Dense ADMM QP solver (OSQP-style), counterpart of `ft_mpc_tpu/solvers/admm.py`.

Solves   min  1/2 x^T P x + q^T x   s.t.  l <= A x <= u
with the operator-splitting iteration of OSQP (Stellato et al.):

    x~ = (P + sigma I + A^T R A)^{-1} (sigma x - q + A^T (R z - y))
    x+ = alpha x~ + (1-alpha) x
    z+ = clip(alpha A x~ + (1-alpha) z + R^{-1} y, l, u)
    y+ = y + R (alpha A x~ + (1-alpha) z - z+)

where R = diag(rho_i), with rho boosted on equality rows (l_i == u_i).  One
explicit Cholesky inverse per phase, a fixed iteration count, and the OSQP
residual-balancing rho update between phases.

Every leaf may carry leading batch dims (one QP, or a bank of them); rho is
adapted per QP.  Plain torch: the JAX package leaves this solver to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QP(NamedTuple):
    """Dense QP data; every leaf may carry the same leading batch dims."""

    P: torch.Tensor  # (..., n, n) symmetric PSD
    q: torch.Tensor  # (..., n)
    A: torch.Tensor  # (..., m, n)
    l: torch.Tensor  # (..., m)
    u: torch.Tensor  # (..., m)


class ADMMConfig(NamedTuple):
    iters: int = 100  # iterations per phase
    phases: int = 4  # rho is re-tuned and K refactorized between phases
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # rho multiplier on rows with l == u
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    alpha: float = 1.6  # over-relaxation


class ADMMSolution(NamedTuple):
    x: torch.Tensor  # (..., n) primal solution
    z: torch.Tensor  # (..., m) constraint-space auxiliary
    y: torch.Tensor  # (..., m) dual variables
    r_prim: torch.Tensor  # (...,) inf-norm of Ax - z
    r_dual: torch.Tensor  # (...,) inf-norm of Px + q + A^T y


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mTv(M, v):
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _amax(v):
    return v.abs().amax(dim=-1)


def chol_inverse(K: torch.Tensor) -> torch.Tensor:
    """Explicit K^{-1} through a Cholesky factor, batched over leading dims.

    `cholesky_ex` skips the host-side error check; a matrix whose
    factorization fails gets an all-NaN inverse, as the JAX package's
    Cholesky gives.
    """
    L, info = torch.linalg.cholesky_ex(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return torch.where((info != 0)[..., None, None], torch.nan, torch.cholesky_solve(eye, L))


def admm_solve(
    qp: QP,
    cfg: ADMMConfig = ADMMConfig(),
    x0: torch.Tensor | None = None,
    y0: torch.Tensor | None = None,
) -> ADMMSolution:
    """Solve one QP or a batch of them (leading dims on every leaf)."""
    P, q, A, lo, hi = qp
    n = P.shape[-1]
    m = A.shape[-2]
    lead = q.shape[:-1]
    kw = dict(dtype=P.dtype, device=P.device)

    x = torch.zeros(*lead, n, **kw) if x0 is None else x0
    y = torch.zeros(*lead, m, **kw) if y0 is None else y0
    z = torch.clamp(_mv(A, x), lo, hi)

    eq_scale = torch.where(torch.abs(hi - lo) < 1e-12, cfg.rho_eq_scale, 1.0).to(P.dtype)
    rho_base = torch.full(lead, cfg.rho, **kw)
    eye = torch.eye(n, **kw)

    for _ in range(cfg.phases):
        rho = rho_base[..., None] * eq_scale
        K = P + cfg.sigma * eye + (A.transpose(-1, -2) * rho[..., None, :]) @ A
        Kinv = chol_inverse(K)
        for _ in range(cfg.iters):
            rhs = cfg.sigma * x - q + _mTv(A, rho * z - y)
            x_t = _mv(Kinv, rhs)
            x = cfg.alpha * x_t + (1.0 - cfg.alpha) * x
            z_hat = cfg.alpha * _mv(A, x_t) + (1.0 - cfg.alpha) * z
            z_new = torch.clamp(z_hat + y / rho, lo, hi)
            y = y + rho * (z_hat - z_new)
            z = z_new

        # OSQP residual-balancing rho update (relative residuals)
        Ax = _mv(A, x)
        Px = _mv(P, x)
        ATy = _mTv(A, y)
        r_prim = _amax(Ax - z)
        r_dual = _amax(Px + q + ATy)
        prim_scale = torch.clamp(torch.maximum(_amax(Ax), _amax(z)), min=1e-6)
        dual_scale = torch.clamp(torch.maximum(_amax(Px), _amax(q)), min=1e-6)
        dual_scale = torch.maximum(dual_scale, _amax(ATy))
        ratio = (r_prim / prim_scale) / torch.clamp(r_dual / dual_scale, min=1e-12)
        rho_base = torch.clamp(rho_base * torch.sqrt(ratio), cfg.rho_min, cfg.rho_max)

    r_prim = _amax(_mv(A, x) - z)
    r_dual = _amax(_mv(P, x) + q + _mTv(A, y))
    return ADMMSolution(x=x, z=z, y=y, r_prim=r_prim, r_dual=r_dual)


def admm_refine(qp: QP, sol: ADMMSolution, cfg: ADMMConfig,
                extra_iters: int) -> ADMMSolution:
    """Continue iterating from a previous solution (warm restart)."""
    return admm_solve(qp, cfg._replace(iters=extra_iters), x0=sol.x, y0=sol.y)
