"""Stagewise (banded-KKT) ADMM for the MPC subproblem: the long-horizon
backend, counterpart of `ft_mpc_tpu/solvers/mpc_qp_stagewise.py`.

States stay variables and the dynamics are hard constraints inside every
ADMM x-update, which is an LQR solve by Riccati recursion
(`solvers/riccati.py`): per-iteration cost is O(Nt) and nothing quadratic in
the horizon is ever built.

Splitting:  min  J(dx, du)   s.t.  dynamics (hard, inside the LQR),
            z_h = hull_A du_t <= h_hull,   z_T = T dx_N <= h_term,
            z_b = Cx dx_t <= h_box_t (optional state rows).

Within a phase rho is fixed, so the Riccati quadratic data is factored once
per phase (`lqr_factor`) and every ADMM iteration is a matvec-only re-solve.
`cfg.mode` picks the x-update:
  * 'lanes' (`solve_mpc_qp_stagewise_lanes`, the batched controller path):
    `lqr_resolve_lanes` on the phase's `prepare_resolve`, one CUDA kernel
    launch per iteration on the card and one per phase;
  * 'scan': the plain sequential `lqr_resolve`;
  * 'scan-assoc': the same factorization, re-solved by associative scans
    (`lqr_resolve_assoc`, O(log Nt) depth);
  * 'assoc': no factorization; every iteration solves the whole LQR by
    associative scans (`lqr_solve(mode='assoc')`).
The per-scenario `solve_mpc_qp_stagewise` runs the last three (and, as the
JAX function does, 'assoc' for any other mode).  Between phases rho adapts
per scenario by the scaled-residual rule, and (rho, duals) carry across SQP
iterations and control steps.  The tensor ops around the re-solve are plain
torch ops, as they are XLA ops in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ft_mpc_torch.solvers.lanes_riccati import lqr_resolve_lanes, prepare_resolve
from ft_mpc_torch.solvers.mpc_qp import elastic_gap, hinge_prox, rho_factor
from ft_mpc_torch.solvers.riccati import (
    LQRProblem,
    lqr_factor,
    lqr_resolve,
    lqr_resolve_assoc,
    lqr_solve,
)
from ft_mpc_torch.utils.logging import span


class StagewiseMPCQP(NamedTuple):
    """Stagewise QP data in delta variables around the SQP linearization.

    Objective (matching the condensed assembly in `controllers/spiraling`):
        sum_{t=1..Nt-1} dx_t' Qx dx_t + 2 gx_t' dx_t
      + sum_{t=0..Nt-1} du_t' Ru du_t + 2 gu_t' du_t
      + dx_N' QxN dx_N + gxN' dx_N
    s.t. dx_{t+1} = A_t dx_t + B_t du_t + c_t,  dx_0 = 0,
         hull_A du_t <= h_hull_t,   T dx_N <= h_term.

    Shapes are per scenario; the batched solver takes every leaf with a
    leading batch axis B.
    """

    A: torch.Tensor  # (Nt, n, n)
    B: torch.Tensor  # (Nt, n, m)
    c: torch.Tensor  # (Nt, n) defects
    Qx: torch.Tensor  # (n, n) stage state cost (embedded 9-d)
    gx: torch.Tensor  # (Nt+1, n) linear state terms (index 0 unused)
    Ru: torch.Tensor  # (m, m)
    gu: torch.Tensor  # (Nt, m)
    QxN: torch.Tensor  # (n, n)
    hull_A: torch.Tensor  # (F, m)
    h_hull: torch.Tensor  # (Nt, F)
    T: torch.Tensor  # (Tm, n) terminal rows (masked rows zeroed, n-embedded)
    h_term: torch.Tensor  # (Tm,)
    # Optional per-stage state-row block Cx dx_t <= h_box_t for t = 1..Nt;
    # None or a zero-row Cx disables it.
    Cx: torch.Tensor | None = None  # (S, n)
    h_box: torch.Tensor | None = None  # (Nt, S)


class StagewiseConfig(NamedTuple):
    iters: int = 40
    phases: int = 1  # rho re-factorizations; total iterations = iters*phases
    rho: float = 50.0
    rho_min: float = 1.0
    rho_max: float = 1e4
    # Per-phase rho change bound; tight (1.5) when (rho, duals) are carried
    # across solves, loose (5.0) for cold solves.
    adapt_clip: float = 5.0
    sigma: float = 1e-6
    alpha: float = 1.6
    # 'scan' (factored, sequential re-solve) | 'scan-assoc' (factored,
    # associative-scan re-solve) | 'assoc' (associative-scan solve of the
    # whole LQR every iteration) | 'lanes' (factored, the kernel pair; the
    # batched controller path)
    mode: str = "scan"
    # Elastic terminal (and box) rows: l1 exact-penalty dual clamp.  Feasible
    # QPs whose duals stay below the clamp solve unchanged; infeasible
    # restoration QPs converge to the minimum-violation point with the
    # violation reported as `term_gap`.  0 disables (hard rows).
    elastic_y_max: float = 1e3


class StagewiseSolution(NamedTuple):
    dX: torch.Tensor  # (Nt+1, n)
    dU: torch.Tensor  # (Nt, m)
    y_hull: torch.Tensor
    y_term: torch.Tensor
    rho: torch.Tensor  # adapted penalty, carry into the next solve's rho0
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    # max violation of dual-clamped elastic rows (0 when the restoration
    # step is feasible; the infeasibility gap otherwise)
    term_gap: torch.Tensor


def _amax(x, dims):
    return x.abs().amax(dim=dims)


def _solve_batched(qp: StagewiseMPCQP, cfg: StagewiseConfig, y_hull0, y_term0, rho0,
                   mode: str) -> StagewiseSolution:
    """The batched solver; `mode` picks the x-update (module docstring):
    the kernel pair ('lanes') or plain torch in the input dtype."""
    B, Nt, n, m = qp.B.shape
    F = qp.hull_A.shape[-2]
    dtype, dev = qp.A.dtype, qp.A.device
    kw = dict(dtype=dtype, device=dev)
    sigma, alpha, y_max = cfg.sigma, cfg.alpha, cfg.elastic_y_max

    hull_A, T = qp.hull_A, qp.T  # (B, F, m), (B, Tm, n)
    hull_At, Tt = hull_A.transpose(1, 2), T.transpose(1, 2)
    AhTAh = hull_At @ hull_A
    TtT = Tt @ T
    # The state-row block is guarded statically: with no rows every box term
    # is dropped (reductions over an empty axis are not defined in torch).
    has_box = qp.Cx is not None and qp.Cx.shape[-2] > 0
    if has_box:
        Cx, h_box = qp.Cx, qp.h_box
        Cxt = Cx.transpose(1, 2)
        CtC = Cxt @ Cx
    else:
        CtC = torch.zeros(n, n, **kw)
    eye_n = torch.eye(n, **kw)
    eye_m = torch.eye(m, **kw)
    zeros_x = torch.zeros(B, n, **kw)
    gu2, gx2 = 2.0 * qp.gu, 2.0 * qp.gx[:, 1:]

    def Gx(dX, dU):
        Gh = dU @ hull_At  # (B, Nt, F)
        Gt = (T @ dX[:, -1, :, None]).squeeze(-1)  # (B, Tm)
        Gb = dX[:, 1:] @ Cxt if has_box else None  # (B, Nt, S)
        return Gh, Gt, Gb

    dX = torch.zeros(B, Nt + 1, n, **kw)
    dU = torch.zeros(B, Nt, m, **kw)
    yh = torch.zeros(B, Nt, F, **kw) if y_hull0 is None else y_hull0
    yt = torch.zeros_like(qp.h_term) if y_term0 is None else y_term0
    zh = torch.clamp(qp.h_hull, max=0.0)
    zt = torch.clamp(qp.h_term, max=0.0)
    yb = torch.zeros_like(h_box) if has_box else None  # box duals start at zero
    zb = torch.clamp(h_box, max=0.0) if has_box else None
    if rho0 is None:
        rho = torch.full((B,), cfg.rho, **kw)
    else:
        rho = torch.clamp(torch.as_tensor(rho0, **kw).expand(B),
                          cfg.rho_min, cfg.rho_max)

    for _ in range(cfg.phases):
        rho2, rho3 = rho[:, None], rho[:, None, None]
        Q_stage = 2.0 * qp.Qx + sigma * eye_n + rho3 * CtC
        R_stage = 2.0 * qp.Ru + sigma * eye_m + rho3 * AhTAh
        QN = 2.0 * qp.QxN + sigma * eye_n + rho3 * (TtT + CtC)
        if mode == "assoc":
            # the whole LQR (factorization included) every iteration
            Q_all = Q_stage[:, None].expand(B, Nt, n, n)
            R_all = R_stage[:, None].expand(B, Nt, m, m)

            def resolve(_, q_full, r_lin, qN_lin, x0):
                sol = lqr_solve(LQRProblem(A=qp.A, B=qp.B, c=qp.c, Q=Q_all, q=q_full,
                                           R=R_all, r=r_lin, QN=QN, qN=qN_lin, x0=x0),
                                mode="assoc")
                return sol.X, sol.U

            fact = None
        else:
            resolve = {"lanes": lqr_resolve_lanes, "scan": lqr_resolve,
                       "scan-assoc": lqr_resolve_assoc}[mode]
            # one batched Riccati factorization for the whole phase (rho fixed)
            with span("ft_mpc.lqr_factor"):
                fact = lqr_factor(qp.A, qp.B, qp.c, Q_stage, R_stage, QN)
            if mode == "lanes":  # its preparation, in the span ft_mpc.riccati on the card
                fact = prepare_resolve(fact)
        soft_t, soft_b = y_max / rho2, y_max / rho3

        with span("ft_mpc.stagewise_admm"):
            for _ in range(cfg.iters):
                vh = zh - yh / rho3
                vt = zt - yt / rho2
                r_lin = gu2 - sigma * dU - rho3 * (vh @ hull_A)
                q_lin = gx2 - sigma * dX[:, 1:]
                if has_box:
                    q_lin = q_lin - rho3 * ((zb - yb / rho3) @ Cx)
                qN_lin = q_lin[:, -1] - rho2 * (Tt @ vt[:, :, None]).squeeze(-1)
                q_full = torch.cat([zeros_x[:, None], q_lin[:, :-1]], dim=1)
                dX_t, dU_t = resolve(fact, q_full, r_lin, qN_lin, zeros_x)
                dX = alpha * dX_t + (1 - alpha) * dX
                dU = alpha * dU_t + (1 - alpha) * dU
                Gh_t, Gt_t, Gb_t = Gx(dX_t, dU_t)
                zh_hat = alpha * Gh_t + (1 - alpha) * zh
                zt_hat = alpha * Gt_t + (1 - alpha) * zt
                zh = torch.minimum(zh_hat + yh / rho3, qp.h_hull)
                vt_z = zt_hat + yt / rho2
                if y_max > 0:
                    zt = hinge_prox(vt_z, qp.h_term, soft_t)
                else:
                    zt = torch.minimum(vt_z, qp.h_term)
                yh = yh + rho3 * (zh_hat - zh)
                yt = yt + rho2 * (zt_hat - zt)
                if y_max > 0:
                    yt = torch.clamp(yt, 0.0, y_max)
                if has_box:
                    zb_hat = alpha * Gb_t + (1 - alpha) * zb
                    vb_z = zb_hat + yb / rho3
                    if y_max > 0:
                        zb = hinge_prox(vb_z, h_box, soft_b)
                    else:
                        zb = torch.minimum(vb_z, h_box)
                    yb = yb + rho3 * (zb_hat - zb)
                    if y_max > 0:
                        yb = torch.clamp(yb, 0.0, y_max)

        # residuals and the rho rule of mpc_qp.solve_mpc_qp
        Gh, Gt, Gb = Gx(dX, dU)
        if y_max > 0:
            term_gap = elastic_gap(yt, Gt, qp.h_term, y_max, 1)
            if has_box:
                term_gap = torch.maximum(term_gap,
                                         elastic_gap(yb, Gb, h_box, y_max, (1, 2)))
        else:
            term_gap = torch.zeros(B, **kw)
        r_prim = torch.maximum(_amax(Gh - zh, (1, 2)), _amax(Gt - zt, 1))
        if has_box:
            r_prim = torch.maximum(r_prim, _amax(Gb - zb, (1, 2)))
        dURu2 = 2.0 * (dU @ qp.Ru)
        r_dual = _amax(dURu2 + gu2 + yh @ hull_A, (1, 2))
        prim_scale = torch.maximum(_amax(Gh, (1, 2)), _amax(zh, (1, 2)))
        factor = rho_factor(r_prim, prim_scale, r_dual, _amax(dURu2, (1, 2)), cfg.adapt_clip)
        rho = torch.clamp(rho * factor, cfg.rho_min, cfg.rho_max)

    return StagewiseSolution(dX=dX, dU=dU, y_hull=yh, y_term=yt, rho=rho,
                             r_prim=r_prim, r_dual=r_dual, term_gap=term_gap)


def solve_mpc_qp_stagewise_lanes(
    qp: StagewiseMPCQP,  # every leaf with a leading batch axis B
    cfg: StagewiseConfig = StagewiseConfig(),
    y_hull0: torch.Tensor | None = None,
    y_term0: torch.Tensor | None = None,
    rho0: torch.Tensor | None = None,
) -> StagewiseSolution:
    """Batched stagewise solve on the kernel-pair LQR re-solve.

    Same per-phase sequential factorization, elastic hinge prox and rho rule
    as the per-scenario solver with mode='scan', per-scenario rho (B,); every
    ADMM x-update is `lqr_resolve_lanes`.  `cfg.mode` is not read.
    """
    if cfg.phases < 1:
        raise ValueError("solve_mpc_qp_stagewise_lanes needs phases >= 1")
    return _solve_batched(qp, cfg, y_hull0, y_term0, rho0, mode="lanes")


def solve_mpc_qp_stagewise(
    qp: StagewiseMPCQP,
    cfg: StagewiseConfig = StagewiseConfig(),
    y_hull0: torch.Tensor | None = None,
    y_term0: torch.Tensor | None = None,
    rho0: torch.Tensor | None = None,
) -> StagewiseSolution:
    """Per-scenario stagewise solve, in plain torch in the input dtype.

    Takes one scenario's QP (leaves as documented on `StagewiseMPCQP`) or a
    bank of them with one leading batch axis on every leaf (the per-scenario
    path run on many rows at once).  mode 'scan' or 'scan-assoc' factor once
    per phase; any other mode, 'lanes' included, solves by associative scans
    every iteration ('assoc'), as the JAX function does.
    """
    if cfg.phases < 1:
        raise ValueError("solve_mpc_qp_stagewise needs phases >= 1")
    mode = cfg.mode if cfg.mode in ("scan", "scan-assoc") else "assoc"
    if qp.B.dim() == 4:
        return _solve_batched(qp, cfg, y_hull0, y_term0, rho0, mode=mode)
    lead = lambda x: None if x is None else x[None]
    sol = _solve_batched(
        StagewiseMPCQP(*(lead(x) for x in qp)), cfg, lead(y_hull0), lead(y_term0),
        None if rho0 is None else torch.as_tensor(rho0).reshape(1), mode=mode,
    )
    return StagewiseSolution(*(x[0] for x in sol))
