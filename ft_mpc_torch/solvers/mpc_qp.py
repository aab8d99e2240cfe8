"""Condensed MPC QP and its exact-refactor ADMM solver, counterpart of
`ft_mpc_tpu/solvers/mpc_qp.py`.

    min 1/2 x^T H x + g^T x  s.t.  (I_Nt kron hull_A) x <= h_hull,  G_term x <= h_term

The stage hull block stays implicit (one shared (F, 6) matrix per
scenario).  Two solvers take it:
  * `solve_mpc_qp` here: the per-scenario path, an explicit Cholesky
    inverse of K per rho phase and the iterations as plain torch ops (the
    JAX package leaves this solver to XLA);
  * `solvers.lanes_qp.solve_mpc_qp_lanes`: the batched path on the ADMM
    kernel with a Newton-refreshed K^{-1}.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ft_mpc_torch.solvers.admm import chol_inverse


class StructuredMPCQP(NamedTuple):
    """Condensed QP; the batched paths carry a leading scenario axis (B, ...)
    on every leaf, `solve_mpc_qp` takes any leading dims."""

    H: torch.Tensor  # (B, n, n)
    g: torch.Tensor  # (B, n)
    hull_A: torch.Tensor  # (B, F, 6) shared stage block (masked rows zeroed)
    h_hull: torch.Tensor  # (B, Nt, F) per-stage offsets (masked rows large)
    G_term: torch.Tensor  # (B, T, n) dense terminal rows (masked rows zeroed)
    h_term: torch.Tensor  # (B, T)


class StructuredADMMConfig(NamedTuple):
    """ADMM settings; same fields and defaults as the JAX package.

    adapt_clip bounds the per-phase rho change (1.5 on the warm
    Newton-refreshed path, 5.0 on exact-refactor paths).  elastic_y_max > 0
    clamps terminal duals to [0, elastic_y_max] with the exact hinge prox
    (l1 exact-penalty restoration rows); 0 keeps the rows hard.
    """

    iters: int = 50
    phases: int = 4
    rho: float = 1.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    alpha: float = 1.6
    adapt_clip: float = 5.0
    elastic_y_max: float = 1e3


class StructuredSolution(NamedTuple):
    x: torch.Tensor  # (..., n)
    y_hull: torch.Tensor  # (..., Nt, F) duals of stage rows
    y_term: torch.Tensor  # (..., T) duals of terminal rows
    r_prim: torch.Tensor  # (...,)
    r_dual: torch.Tensor  # (...,)
    rho: torch.Tensor  # (...,) adapted step size (carry across solves)
    # max violation of dual-saturated elastic terminal rows (the restoration
    # gap; 0 when the restoration step is feasible)
    term_gap: torch.Tensor  # (...,)


def rho_factor(r_prim, prim_scale, r_dual, dual_scale, adapt_clip: float):
    """The per-phase rho factor of every ADMM solver of the family: the
    square root of the scaled residuals' ratio (scales floored at 1e-6),
    bounded to [1/adapt_clip, adapt_clip], and 1 where r_prim <= 1e-4 (the
    ratio is noise once converged; a carried rho would random-walk)."""
    prim_scale = torch.clamp(prim_scale, min=1e-6)
    dual_scale = torch.clamp(dual_scale, min=1e-6)
    ratio = (r_prim / prim_scale) / torch.clamp(r_dual / dual_scale, min=1e-12)
    factor = torch.clamp(torch.sqrt(ratio), 1.0 / adapt_clip, adapt_clip)
    return torch.where(r_prim <= 1e-4, 1.0, factor)


def elastic_gap(y, Gz, h, y_max: float, dim):
    """The restoration gap: the largest violation max(Gz - h, 0) over the
    elastic rows whose dual sits at the clamp y_max, reduced over `dim`.
    The consensus residual stays honest on elastic rows; this is what
    reports their infeasibility."""
    over = torch.clamp(Gz - h, min=0.0)
    return torch.where(y >= 0.999 * y_max, over, 0.0).amax(dim=dim)


def hinge_prox(v, h, shift):
    """Exact prox of the hinge penalty y_max * max(z - h, 0) at v, with
    shift = y_max / rho: past the clamp z floats beyond h, so consensus
    converges on infeasible rows and the dual saturates at y_max."""
    return torch.where(v > h + shift, v - shift, torch.minimum(v, h))


def _kron_eye(Nt: int, M: torch.Tensor) -> torch.Tensor:
    """I_Nt kron M for M (..., k, k), batched over the leading dims."""
    eye = torch.eye(Nt, dtype=M.dtype, device=M.device)
    k = M.shape[-1]
    blk = eye[:, None, :, None] * M[..., None, :, None, :]
    return blk.reshape(*M.shape[:-2], Nt * k, Nt * k)


def solve_mpc_qp(
    qp: StructuredMPCQP,
    cfg: StructuredADMMConfig = StructuredADMMConfig(),
    y_hull0: torch.Tensor | None = None,
    y_term0: torch.Tensor | None = None,
    rho0: torch.Tensor | None = None,
) -> StructuredSolution:
    """Solve one structured QP, or a bank of them (leading dims on every leaf).

    An exact Cholesky inverse of K per rho phase; warm duals and a warm rho
    (the adapted penalty of the previous solve) are optional.  Between
    phases rho adapts by the scaled-residual rule, bounded by
    `cfg.adapt_clip` and frozen once r_prim <= 1e-4.
    """
    H, g, hull_A, h_hull, G_term, h_term = qp
    n = H.shape[-1]
    Nt = h_hull.shape[-2]
    n_u = hull_A.shape[-1]
    lead = g.shape[:-1]
    kw = dict(dtype=H.dtype, device=H.device)
    sigma, alpha, y_max = cfg.sigma, cfg.alpha, cfg.elastic_y_max
    hull_At = hull_A.transpose(-1, -2)

    def Gx(x):
        xh = x.reshape(*lead, Nt, n_u)
        return xh @ hull_At, (G_term @ x.unsqueeze(-1)).squeeze(-1)

    def GTy(y_hull, y_term):
        return ((y_hull @ hull_A).reshape(*lead, n)
                + (y_term.unsqueeze(-2) @ G_term).squeeze(-2))

    M_rho = _kron_eye(Nt, hull_At @ hull_A) + G_term.transpose(-1, -2) @ G_term
    eye = torch.eye(n, **kw)

    x = torch.zeros(*lead, n, **kw)
    yh = torch.zeros_like(h_hull) if y_hull0 is None else y_hull0
    yt = torch.zeros_like(h_term) if y_term0 is None else y_term0
    zh0, zt0 = Gx(x)
    zh = torch.minimum(zh0, h_hull)
    zt = torch.minimum(zt0, h_term)
    if rho0 is None:
        rho = torch.full(lead, cfg.rho, **kw)
    else:
        rho = torch.clamp(torch.as_tensor(rho0), cfg.rho_min, cfg.rho_max).to(H.dtype)
        rho = rho.expand(lead)

    for _ in range(cfg.phases):
        r2, r3 = rho[..., None], rho[..., None, None]
        Kinv = chol_inverse(H + sigma * eye + r3 * M_rho)
        for _ in range(cfg.iters):
            rhs = sigma * x - g + GTy(r3 * zh - yh, r2 * zt - yt)
            x_t = (Kinv @ rhs.unsqueeze(-1)).squeeze(-1)
            x = alpha * x_t + (1.0 - alpha) * x
            Gh_t, Gt_t = Gx(x_t)
            zh_hat = alpha * Gh_t + (1.0 - alpha) * zh
            zt_hat = alpha * Gt_t + (1.0 - alpha) * zt
            zh_new = torch.minimum(zh_hat + yh / r3, h_hull)
            vt = zt_hat + yt / r2
            if y_max > 0:
                zt_new = hinge_prox(vt, h_term, y_max / r2)
            else:
                zt_new = torch.minimum(vt, h_term)
            yh = yh + r3 * (zh_hat - zh_new)
            yt = yt + r2 * (zt_hat - zt_new)
            if y_max > 0:
                yt = torch.clamp(yt, 0.0, y_max)
            zh, zt = zh_new, zt_new

        Gh, Gt = Gx(x)
        if y_max > 0:
            term_gap = elastic_gap(yt, Gt, h_term, y_max, -1)
        else:
            term_gap = torch.zeros(lead, **kw)
        r_prim = torch.maximum((Gh - zh).abs().amax(dim=(-2, -1)),
                               (Gt - zt).abs().amax(dim=-1))
        Hx = (H @ x.unsqueeze(-1)).squeeze(-1)
        r_dual = (Hx + g + GTy(yh, yt)).abs().amax(dim=-1)
        prim_scale = torch.maximum(Gh.abs().amax(dim=(-2, -1)), zh.abs().amax(dim=(-2, -1)))
        dual_scale = torch.maximum(Hx.abs().amax(dim=-1), g.abs().amax(dim=-1))
        factor = rho_factor(r_prim, prim_scale, r_dual, dual_scale, cfg.adapt_clip)
        rho = torch.clamp(rho * factor, cfg.rho_min, cfg.rho_max)

    return StructuredSolution(x=x, y_hull=yh, y_term=yt, r_prim=r_prim, r_dual=r_dual,
                              rho=rho, term_gap=term_gap)
