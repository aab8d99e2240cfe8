"""Spiraling (micro-orbiting) MPC as a real-time-iteration SQP, counterpart
of `ft_mpc_tpu/controllers/spiraling.py`.

Two paths, as in the JAX package:
  * the batched path (`init_warmstart_batch`, `sqp_solve_batch`,
    `sqp_solve_batch_stagewise`, `get_control_batch`) on the kernels below;
  * the per-scenario path (`sqp_solve`, `get_control`, `shift_warmstart`),
    plain torch as the JAX package leaves it to XLA: the condensed QP by the
    exact-refactor `solve_mpc_qp`, the stagewise one by
    `solve_mpc_qp_stagewise`, allocation by `allocate_thrusters`.  Its core
    (`sqp_solve_rows`, `get_control_rows`) takes a bank of rows and computes
    for each what the JAX package's `vmap(sqp_solve)` does; `sqp_solve` and
    `get_control` run it on one scenario.

Each control step, per SQP iteration: linearize the RK4 orbit-center
dynamics along the warm trajectory (`ops.linearize.linearize_lanes`: kernel
`csrc/linearize.cu` over the B * Nt stages), then
  * condensed (short horizons): condense (kernel `csrc/condense.cu`),
    assemble the dense 90-variable QP with the terminal cost's gradient and
    PSD-shifted Hessian (`ops.terminal.terminal_lanes`: kernel
    `csrc/terminal.cu`, one launch for the bank), refresh K^{-1}, run the
    ADMM kernel;
  * stagewise (long horizons, `cfg.stagewise.mode='lanes'`): assemble the
    banded QP and run the Riccati-in-ADMM solver, whose every x-update is
    the kernel pair of `csrc/riccati.cu`;
and take a 3-candidate merit line search.  Then the worst-K scenarios get
one cleanup iteration with a larger ADMM budget, and the first input is
un-rotated and allocated to thrusters (kernel `csrc/alloc.cu`).

Functions take batch-leading tensors with the JAX package's shapes (the
per-scenario entry points take the JAX package's unbatched ones); the dtype
follows the inputs (float64 in the CPU parity tests, float32 on the card).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ft_mpc_torch import resolve_device
from ft_mpc_torch.geometry.scenario import Scenario, take_rows
from ft_mpc_torch.ops.dynamics import (
    BodyParams,
    _matvec,
    center_step,
    robot_to_center,
)
from ft_mpc_torch.ops.linearize import (
    linearize_lanes,
    params_batch_axes,
    params_row as _params_row,
    stage_dynamics as _stage_dynamics,
    stage_rows as _stage_rows,
)
from ft_mpc_torch.ops.quaternion import rot_full, rot_full_inv
from ft_mpc_torch.ops.terminal import terminal_lanes
from ft_mpc_torch.solvers.allocation import AllocationResult, allocate_thrusters
from ft_mpc_torch.solvers.lanes_alloc import allocate_thrusters_lanes
from ft_mpc_torch.solvers.lanes_condense import condense_lanes, condense_plain
from ft_mpc_torch.solvers.lanes_qp import build_K, exact_kinv, solve_mpc_qp_lanes
from ft_mpc_torch.solvers.mpc_qp import (
    StructuredADMMConfig,
    StructuredMPCQP,
    solve_mpc_qp,
)
from ft_mpc_torch.solvers.mpc_qp_stagewise import (
    StagewiseConfig,
    StagewiseMPCQP,
    solve_mpc_qp_stagewise,
    solve_mpc_qp_stagewise_lanes,
)
from ft_mpc_torch.utils.logging import span

_BIG = 1e8
N_X = 13
N_U = 6
N_OPT = 9  # states with running cost: pos, vel, omega


class MPCConfig(NamedTuple):
    """Static controller configuration (the JAX package's fields)."""

    horizon: int = 15
    sqp_iters: int = 3
    admm: StructuredADMMConfig = StructuredADMMConfig(iters=30, phases=1, rho=50.0)
    # 'condensed' (dense, states eliminated: short horizons) or 'stagewise'
    # (Riccati-in-ADMM banded KKT, O(Nt) per iteration: long horizons)
    qp_backend: str = "condensed"
    stagewise: StagewiseConfig = StagewiseConfig()
    prox: float = 0.0
    ls_alphas: tuple = (1.0, 0.5, 0.0)
    ls_penalty: float = 1e3
    newton_iters: int = 3
    cleanup_iters: int = 0
    cleanup_k: int = 256
    cleanup_phases: int = 2
    cleanup_rounds: int = 1
    # Convergence-gated refinement (per-scenario path only): after the
    # sqp_iters loop, up to refine_iters further SQP iterations, each kept
    # only on rows where max(r_prim, du_norm) > refine_tol, with the ADMM
    # budget refine_admm (None: admm)
    refine_iters: int = 0
    refine_tol: float = 1e-3
    refine_admm: StructuredADMMConfig | None = None
    term_relax: float = 0.5


class MPCWeights(NamedTuple):
    """Cost data + optional stage state box and wrench-rate bound."""

    Q: torch.Tensor  # (9, 9)
    R: torch.Tensor  # (6, 6)
    x_lb: torch.Tensor | None = None  # (13,)
    x_ub: torch.Tensor | None = None  # (13,)
    du_max: torch.Tensor | None = None  # (6,)

    @classmethod
    def from_diagonals(cls, q, r, x_lb=None, x_ub=None, du_max=None,
                       dtype: torch.dtype = torch.float32, device=None) -> "MPCWeights":
        dev = resolve_device(device)

        def t(v):
            # sequences go through numpy, as in the JAX package: YAML reads
            # "1e8" (no dot) as a string, which numpy converts and torch refuses
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v, dtype=np.float64)
            return torch.as_tensor(v, dtype=dtype, device=dev)

        opt = lambda v: None if v is None else t(v)
        return cls(Q=torch.diag(t(q)), R=torch.diag(t(r)),
                   x_lb=opt(x_lb), x_ub=opt(x_ub), du_max=opt(du_max))

    @property
    def has_state_box(self) -> bool:
        return self.x_lb is not None or self.x_ub is not None


def n_extra_rows(weights: MPCWeights, horizon: int) -> int:
    """Count of extra dense rows (state box + rate) in the term block."""
    E = 0
    if weights.has_state_box:
        E += 2 * N_X * (horizon - 1)
    if weights.du_max is not None:
        E += 2 * N_U * (horizon - 1)
    return E


def _box_bounds(weights: MPCWeights, dtype, device):
    xub = (torch.full((N_X,), _BIG, dtype=dtype, device=device) if weights.x_ub is None
           else weights.x_ub.to(dtype))
    xlb = (torch.full((N_X,), -_BIG, dtype=dtype, device=device) if weights.x_lb is None
           else weights.x_lb.to(dtype))
    return xlb, xub


class WarmStart(NamedTuple):
    """Batched (B, ...) on the bank paths; one scenario's has no B axis."""

    X: torch.Tensor  # (B, Nt+1, 13) center-state trajectory
    U: torch.Tensor  # (B, Nt, 6) input deviations
    y_hull: torch.Tensor  # (B, Nt, F)
    y_term: torch.Tensor  # (B, T + E)
    rho: torch.Tensor  # (B,)
    # (B, n, n) float32 inverse ADMM metric of the condensed batched path;
    # None on the per-scenario and stagewise paths
    kinv: torch.Tensor | None = None


class SQPInfo(NamedTuple):
    cost: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    defect: torch.Tensor
    du_norm: torch.Tensor
    term_gap: torch.Tensor


class ControlOutput(NamedTuple):
    u_phys: torch.Tensor  # (B, 16)
    wrench: torch.Tensor  # (B, 6)
    c0: torch.Tensor  # (B, 13)
    warm: WarmStart
    info: SQPInfo
    alloc: AllocationResult


def init_warmstart(params: BodyParams, scenario: Scenario, cfg: MPCConfig,
                   c0: torch.Tensor, weights: MPCWeights | None = None) -> WarmStart:
    """Roll the center dynamics forward with zero deviation input.

    Works on one scenario or a batch: every leaf's leading dims must match
    c0's (batched plant leaves included).
    """
    x = c0
    Xs = [c0]
    for _ in range(cfg.horizon):
        x = center_step(params, scenario.faulty_force_gen, scenario.r, x,
                        scenario.u_comp)
        Xs.append(x)
    lead = c0.shape[:-1]
    kw = dict(dtype=c0.dtype, device=c0.device)
    F = scenario.hull_A.shape[-2]
    T = scenario.term_A.shape[-2]
    E = 0 if weights is None else n_extra_rows(weights, cfg.horizon)
    return WarmStart(
        X=torch.stack(Xs, dim=-2),
        U=torch.zeros(*lead, cfg.horizon, N_U, **kw),
        y_hull=torch.zeros(*lead, cfg.horizon, F, **kw),
        y_term=torch.zeros(*lead, T + E, **kw),
        rho=torch.full(lead, cfg.admm.rho, **kw),
    )


def shift_warmstart(warm: WarmStart, c0: torch.Tensor) -> WarmStart:
    """One-stage shift along the horizon, pinning the first state to c0.

    The appended tail repeats the last stage; y_term, rho and kinv carry
    over unshifted, as in the JAX package.  One scenario's warm start or a
    bank's (the horizon is the axis before the last).
    """
    with span("ft_mpc.shift"):
        X = torch.cat([c0[..., None, :], warm.X[..., 2:, :], warm.X[..., -1:, :]], dim=-2)
        U = torch.cat([warm.U[..., 1:, :], warm.U[..., -1:, :]], dim=-2)
        y_hull = torch.cat([warm.y_hull[..., 1:, :], warm.y_hull[..., -1:, :]], dim=-2)
    return WarmStart(X=X, U=U, y_hull=y_hull, y_term=warm.y_term, rho=warm.rho,
                     kinv=warm.kinv)


def _condense(A_stack, B_stack, defects, horizon):
    """Prediction matrices delta_x_t = S_t delta_U + phi_t (plain recursion).

    The plain version of the condensing kernel, in the input dtype.
    """
    if A_stack.shape[-3] != horizon:
        raise ValueError(f"_condense: {A_stack.shape[-3]} stages, horizon {horizon}")
    return condense_plain(A_stack, B_stack, defects)


def _masked_geometry(scenario: Scenario):
    """Constraint geometry with padded rows made inert (batched or not)."""
    hull_A = scenario.hull_A * scenario.hull_mask[..., None]
    hull_b = torch.where(scenario.hull_mask > 0.5, scenario.hull_b, _BIG)
    term_A = scenario.term_A * scenario.term_mask[..., None]
    term_b = torch.where(scenario.term_mask > 0.5, scenario.term_b, _BIG)
    return hull_A, hull_b, term_A, term_b


def _linearize(params, bank: Scenario, cfg: MPCConfig, X, U, u_ref):
    """Batched dynamics values + jacobians along (X, U): `linearize_lanes`
    (the kernel `csrc/linearize.cu` on the card, vmap(jacfwd) on the CPU).

    Returns A (B,Nt,13,13), B (B,Nt,13,6) (both contiguous), defects (B,Nt,13).
    """
    return linearize_lanes(params, bank, X, U, u_ref, cfg.horizon)


def _ext_rows(weights: MPCWeights, X, S_all, phi_all, stage_offset):
    """Batched extra dense inequality rows (state box, then rate rows).

    State box (stages 1..Nt-1): +/- S_t dU <= +/-(x_bound - X_t - phi_t).
    Rate rows: +/-(dU_t - dU_{t-1}) <= du_max -/+ (offset_t - offset_{t-1}).
    Returns (G (B,E,n), h (B,E)); caller guarantees E > 0.
    """
    dtype, dev = X.dtype, X.device
    B, Nt = S_all.shape[:2]
    n_dec = S_all.shape[-1]
    rows_G, rows_h = [], []
    if weights.has_state_box:
        xlb, xub = _box_bounds(weights, dtype, dev)
        S_box = S_all[:, :-1].reshape(B, (Nt - 1) * N_X, n_dec)
        x_nom = X[:, 1:-1] + phi_all[:, :-1]
        rows_G += [S_box, -S_box]
        rows_h += [(xub - x_nom).reshape(B, -1), (x_nom - xlb).reshape(B, -1)]
    if weights.du_max is not None:
        eyeN = torch.eye(Nt, dtype=dtype, device=dev)
        rate_G = torch.kron(eyeN[1:] - eyeN[:-1], torch.eye(N_U, dtype=dtype, device=dev))
        rate_G = rate_G.expand(B, *rate_G.shape)
        dw = (stage_offset[:, 1:] - stage_offset[:, :-1]).reshape(B, -1)
        dmax = weights.du_max.to(dtype).repeat(Nt - 1)
        rows_G += [rate_G, -rate_G]
        rows_h += [dmax - dw, dmax + dw]
    return torch.cat(rows_G, dim=1), torch.cat(rows_h, dim=1)


def _assemble_condensed_batch(params, bank, weights, cfg, X, U, x_ref, u_ref,
                              hull_A, hull_b, term_A, term_b, condense=condense_lanes):
    """Batched linearization + condensing kernel + dense QP assembly.

    x_ref carries a leading scenario axis (B, Nt+1, 9).  Returns
    (StructuredMPCQP, S_all, phi_all, defects).  `condense` computes the
    prediction matrices: the kernel wrapper, or the plain recursion on the
    per-scenario path (`_assemble_condensed`).
    """
    Nt = cfg.horizon
    dtype, dev = X.dtype, X.device
    B = X.shape[0]
    n_dec = Nt * N_U

    with span("ft_mpc.linearize"):
        A_stack, B_stack, defects = _linearize(params, bank, cfg, X, U, u_ref)

    u_r_bar = _matvec(rot_full_inv(X[:, :-1, 9:13]), u_ref[:Nt])
    stage_offset = (
        U + u_r_bar + bank.u_comp[:, None, :] + bank.faulty_force_gen[:, None, :]
    )
    h_hull = hull_b[:, None, :] - torch.einsum("bti,bfi->btf", stage_offset, hull_A)

    with span("ft_mpc.condense"):
        S_all, phi_all = condense(A_stack, B_stack, defects)
    S9 = S_all[:, :, :N_OPT, :]
    e0 = X[:, 1:, :N_OPT] + phi_all[:, :, :N_OPT] - x_ref[:, 1:]

    S9_run, e0_run = S9[:, :-1], e0[:, :-1]
    S9_N, e0_N = S9[:, -1], e0[:, -1]
    R_blk = torch.kron(torch.eye(Nt, dtype=dtype, device=dev), weights.R)
    with span("ft_mpc.terminal"):
        _, gV, HV = terminal_lanes(bank.term, e0_N.contiguous(), derivs=True)
    H = 2.0 * (
        torch.einsum("btin,ij,btjm->bnm", S9_run, weights.Q, S9_run)
        + 0.5 * torch.einsum("bin,bij,bjm->bnm", S9_N, HV, S9_N)
        + R_blk
        + cfg.prox * torch.eye(n_dec, dtype=dtype, device=dev)
    )
    g = 2.0 * (
        torch.einsum("btin,ij,btj->bn", S9_run, weights.Q, e0_run)
        + U.reshape(B, -1) @ R_blk
    ) + torch.einsum("bin,bi->bn", S9_N, gV)

    G_term = torch.einsum("bti,bin->btn", term_A, S9_N)
    h_term = term_b - torch.einsum("bti,bi->bt", term_A, e0_N)
    h_term = torch.maximum(h_term, cfg.term_relax * h_term)

    if n_extra_rows(weights, Nt) > 0:
        with span("ft_mpc.ext_rows"):
            G_ext, h_ext = _ext_rows(weights, X, S_all, phi_all, stage_offset)
            h_ext = torch.maximum(h_ext, cfg.term_relax * h_ext)
            G_term = torch.cat([G_term, G_ext], dim=1)
            h_term = torch.cat([h_term, h_ext], dim=1)

    qp = StructuredMPCQP(H=H, g=g, hull_A=hull_A, h_hull=h_hull,
                         G_term=G_term, h_term=h_term)
    return qp, S_all, phi_all, defects


def _assemble_condensed(params, bank, weights, cfg, X, U, x_ref, u_ref,
                        hull_A, hull_b, term_A, term_b):
    """`_assemble_condensed_batch` with the plain `_condense` in the input
    dtype, as the JAX package's per-scenario assembly condenses."""
    return _assemble_condensed_batch(
        params, bank, weights, cfg, X, U, x_ref, u_ref, hull_A, hull_b, term_A, term_b,
        condense=lambda A, Bm, d: _condense(A, Bm, d, cfg.horizon),
    )


def _assemble_stagewise(params, bank, weights, cfg, X, U, x_ref, u_ref,
                        hull_A, hull_b, term_A, term_b):
    """Batched linearization + stagewise (banded-KKT) QP assembly.

    x_ref carries a leading scenario axis (B, Nt+1, 9).  Returns
    (StagewiseMPCQP with every leaf batch-leading, defects).
    """
    Nt = cfg.horizon
    dtype, dev = X.dtype, X.device
    B = X.shape[0]
    pad13 = lambda t: torch.nn.functional.pad(t, (0, N_X - N_OPT))

    with span("ft_mpc.linearize"):
        A_stack, B_stack, defects = _linearize(params, bank, cfg, X, U, u_ref)
    u_r_bar = _matvec(rot_full_inv(X[:, :-1, 9:13]), u_ref[:Nt])
    stage_offset = (
        U + u_r_bar + bank.u_comp[:, None, :] + bank.faulty_force_gen[:, None, :]
    )
    h_hull = hull_b[:, None, :] - torch.einsum("bti,bfi->btf", stage_offset, hull_A)
    Q13 = torch.zeros(N_X, N_X, dtype=dtype, device=dev)
    Q13[:N_OPT, :N_OPT] = weights.Q
    e_bar = X[:, :, :N_OPT] - x_ref  # (B, Nt+1, 9)
    # terminal: half-gradient / half-Hessian of the polynomial V_f (so that
    # 2 gxN = dV/de; a quadratic V_f gives P e + p/2 and P)
    with span("ft_mpc.terminal"):
        _, gV, HV = terminal_lanes(bank.term, e_bar[:, -1].contiguous(), derivs=True)
    gx = pad13(torch.cat([e_bar[:, :-1] @ weights.Q, 0.5 * gV[:, None]], dim=1))
    QN13 = torch.nn.functional.pad(0.5 * HV, (0, N_X - N_OPT, 0, N_X - N_OPT))
    T13 = pad13(term_A)
    h_term = term_b - torch.einsum("bti,bi->bt", term_A, e_bar[:, -1])
    h_term = torch.maximum(h_term, cfg.term_relax * h_term)

    # Per-stage state box as a stage-row block C dx_t <= h_box_t (mirrors the
    # hull block, on states).  Stage Nt is made inert: the box bounds
    # non-terminal stages only.  A one-sided box still builds both sides.
    if weights.has_state_box:
        xlb, xub = _box_bounds(weights, dtype, dev)
        eye = torch.eye(N_X, dtype=dtype, device=dev)
        Cx = torch.cat([eye, -eye], dim=0).expand(B, 2 * N_X, N_X)
        h_box = torch.cat([xub - X[:, 1:], X[:, 1:] - xlb], dim=2)
        h_box[:, -1] = _BIG
        h_box = torch.maximum(h_box, cfg.term_relax * h_box)
    else:
        Cx = torch.zeros(B, 0, N_X, dtype=dtype, device=dev)
        h_box = torch.zeros(B, Nt, 0, dtype=dtype, device=dev)
    if weights.du_max is not None:
        raise NotImplementedError(
            "input rate limits (du_max) require cross-stage input coupling; "
            "use qp_backend='condensed' (dense rate rows) -- the stagewise "
            "Riccati x-update has no adjacent-stage input block"
        )

    qp = StagewiseMPCQP(
        A=A_stack, B=B_stack, c=defects, Qx=Q13.expand(B, N_X, N_X), gx=gx,
        Ru=weights.R.expand(B, N_U, N_U), gu=U @ weights.R, QxN=QN13,
        hull_A=hull_A, h_hull=h_hull, T=T13, h_term=h_term, Cx=Cx, h_box=h_box,
    )
    return qp, defects


def _merit_alpha(params, bank, weights, cfg, X, U, dX, dU, x_ref, u_ref,
                 hull_A, hull_b, term_A, term_b):
    """Batched fixed-candidate l1-merit line search; returns alpha (B,).

    All candidates are evaluated at once: the rollout runs over the
    flattened (candidates * B * Nt) stage rows.
    """
    Nt = cfg.horizon
    dtype, dev = X.dtype, X.device
    B = X.shape[0]
    # a copy from pageable host memory: torch waits for the device's queue
    with span("ft_mpc.sync"):
        alphas = torch.tensor(cfg.ls_alphas, dtype=dtype, device=dev)
    nA = alphas.shape[0]
    a = alphas[:, None, None, None]
    Uc = U + a * dU  # (nA, B, Nt, 6)
    Xc = torch.cat([X[:, :1].expand(nA, B, 1, N_X), X[:, 1:] + a * dX], dim=2)

    rows = torch.arange(B, device=dev).repeat_interleave(Nt).repeat(nA)
    prow, _, sd = _stage_rows(params, bank, rows)
    f_c = _stage_dynamics(
        prow, sd, Xc[:, :, :-1].reshape(-1, N_X), Uc.reshape(-1, N_U),
        u_ref[:Nt].repeat(nA * B, 1),
    ).reshape(nA, B, Nt, N_X)
    defect_c = f_c - Xc[:, :, 1:]
    e_run_c = Xc[:, :, 1:-1, :N_OPT] - x_ref[:, 1:-1]
    e_N_c = Xc[:, :, -1, :N_OPT] - x_ref[:, -1]
    J = (
        torch.einsum("abti,ij,abtj->ab", e_run_c, weights.Q, e_run_c)
        + torch.einsum("abti,ij,abtj->ab", Uc, weights.R, Uc)
        + terminal_lanes(bank.term, e_N_c)
    )
    u_r_c = _matvec(rot_full_inv(Xc[:, :, :-1, 9:13]), u_ref[:Nt])
    w_tot = Uc + u_r_c + bank.u_comp[:, None] + bank.faulty_force_gen[:, None]
    viol = (
        torch.abs(defect_c).sum(dim=(2, 3))
        + torch.clamp(
            torch.einsum("abti,bfi->abtf", w_tot, hull_A) - hull_b[:, None], min=0.0
        ).sum(dim=(2, 3))
        + torch.clamp(
            torch.einsum("bti,abi->abt", term_A, e_N_c) - term_b, min=0.0
        ).sum(dim=2)
    )
    if n_extra_rows(weights, Nt) > 0:
        with span("ft_mpc.ext_rows"):
            if weights.has_state_box:
                xlb, xub = _box_bounds(weights, dtype, dev)
                xs = Xc[:, :, 1:-1]
                viol = viol + torch.clamp(xs - xub, min=0.0).sum(dim=(2, 3))
                viol = viol + torch.clamp(xlb - xs, min=0.0).sum(dim=(2, 3))
            if weights.du_max is not None:
                dw = w_tot[:, :, 1:] - w_tot[:, :, :-1]
                viol = viol + torch.clamp(torch.abs(dw) - weights.du_max,
                                          min=0.0).sum(dim=(2, 3))
    merits = J + cfg.ls_penalty * viol  # (nA, B)
    # a non-finite candidate must never win over alpha = 0
    merits = torch.where(torch.isfinite(merits), merits, torch.inf)
    return alphas[torch.argmin(merits, dim=0)]


def _per_scenario_ref(bank: Scenario, x_ref, B):
    """(Nt+1, 9) shared window -> (B, Nt+1, 9) with each scenario's omega rows."""
    x_ref = x_ref.expand(B, *x_ref.shape)
    omega = bank.omega_des[:, None, :].to(x_ref.dtype).expand(B, x_ref.shape[1], 3)
    return torch.cat([x_ref[..., :6], omega], dim=-1)


def _with_cost(bank: Scenario, weights: MPCWeights, x_ref, warm: WarmStart,
               info: SQPInfo) -> SQPInfo:
    """`info` with its cost: the running + terminal cost (B,) of warm's
    (X, U) against the shared window x_ref (Nt+1, 9)."""
    x_ref = _per_scenario_ref(bank, x_ref, warm.X.shape[0])
    X, U = warm.X, warm.U
    e_run = X[:, :-1, :N_OPT] - x_ref[:, :-1]
    e_N = X[:, -1, :N_OPT] - x_ref[:, -1]
    cost = (
        torch.einsum("bti,ij,btj->b", e_run, weights.Q, e_run)
        + torch.einsum("bti,ij,btj->b", U, weights.R, U)
        + terminal_lanes(bank.term, e_N)
    )
    return info._replace(cost=cost)


def _condensed_step(sol, S_all, phi_all, defects, warm: WarmStart, **solved):
    """A condensed QP step's result from its solution (see `_sqp_iteration`)."""
    B, Nt = warm.U.shape[:2]
    dX = torch.einsum("btin,bn->bti", S_all, sol.x) + phi_all
    return (dX, sol.x.reshape(B, Nt, N_U), defects,
            warm._replace(y_hull=sol.y_hull, y_term=sol.y_term, **solved), sol)


def _qp_condensed_lanes(params, bank, weights, cfg, x_ref, u_ref, geo, warm):
    """The batched condensed QP step: the condensing kernel's assembly and
    the ADMM kernel on warm.kinv, Newton-refreshed (exact where it is None,
    and then refactored exactly every phase)."""
    qp, S_all, phi_all, defects = _assemble_condensed_batch(
        params, bank, weights, cfg, warm.X, warm.U, x_ref, u_ref, *geo)
    sol = solve_mpc_qp_lanes(qp, cfg.admm, y_hull0=warm.y_hull, y_term0=warm.y_term,
                             rho0=warm.rho, kinv0=warm.kinv, newton_iters=cfg.newton_iters)
    return _condensed_step(sol, S_all, phi_all, defects, warm,
                           rho=sol.rho.to(warm.rho.dtype), kinv=sol.kinv)


def _qp_condensed_rows(params, bank, weights, cfg, x_ref, u_ref, geo, warm):
    """The per-scenario condensed QP step: the plain assembly and the
    exact-refactor solver; warm.kinv is not read."""
    qp, S_all, phi_all, defects = _assemble_condensed(
        params, bank, weights, cfg, warm.X, warm.U, x_ref, u_ref, *geo)
    with span("ft_mpc.qp"):
        sol = solve_mpc_qp(qp, cfg.admm, y_hull0=warm.y_hull, y_term0=warm.y_term,
                           rho0=warm.rho)
    return _condensed_step(sol, S_all, phi_all, defects, warm, rho=sol.rho)


def _qp_stagewise(solve, params, bank, weights, cfg, x_ref, u_ref, geo, warm):
    """The stagewise QP step on `solve` with `cfg.stagewise`.  The warm
    y_term may carry extra condensed-layout rows (state box); only the true
    terminal duals ride through that solver."""
    qp, defects = _assemble_stagewise(params, bank, weights, cfg, warm.X, warm.U,
                                      x_ref, u_ref, *geo)
    T_rows = geo[2].shape[-2]
    yt = warm.y_term
    sol = solve(qp, cfg.stagewise, y_hull0=warm.y_hull, y_term0=yt[:, :T_rows],
                rho0=warm.rho)
    solved = warm._replace(y_hull=sol.y_hull, rho=sol.rho,
                           y_term=torch.cat([sol.y_term, yt[:, T_rows:]], dim=1))
    return sol.dX[:, 1:], sol.dU, defects, solved, sol


def _qp_step_rows(cfg: MPCConfig):
    """The per-scenario path's QP step for `cfg.qp_backend` (plain torch)."""
    _check_backend(cfg)
    if cfg.qp_backend == "condensed":
        return _qp_condensed_rows
    return partial(_qp_stagewise, solve_mpc_qp_stagewise)


def _sqp_iteration(qp_step, params, bank, weights, x_ref, u_ref, geo, cfg,
                   warm: WarmStart):
    """One SQP iteration on B rows: the QP step, the merit line search, the
    step.  The QP step assembles and solves the QP at warm's (X, U) and
    returns the state step dX (B, Nt, 13) of stages 1..Nt, dU (B, Nt, 6),
    the defects, warm with the solve's duals, rho and metric, and the
    solution (its r_prim, r_dual, term_gap).  Returns the new warm start and
    the iteration's SQPInfo without its cost."""
    X, U = warm.X, warm.U
    dX, dU, defects, solved, sol = qp_step(params, bank, weights, cfg, x_ref, u_ref, geo,
                                           warm)
    with span("ft_mpc.line_search"):
        alpha = _merit_alpha(params, bank, weights, cfg, X, U, dX, dU, x_ref, u_ref, *geo)
    a = alpha[:, None, None]
    new = solved._replace(X=torch.cat([X[:, :1], X[:, 1:] + a * dX], dim=1), U=U + a * dU)
    info = SQPInfo(cost=None, r_prim=sol.r_prim, r_dual=sol.r_dual,
                   defect=torch.abs(defects).amax(dim=(1, 2)),
                   du_norm=alpha * torch.abs(dU).amax(dim=(1, 2)), term_gap=sol.term_gap)
    return new, info


def _where_rows(need, new, old):
    """`old` with the rows where `need` holds taken from `new` (None leaves
    pass)."""
    return type(old)(*(None if a is None else
                       torch.where(need.view(-1, *(1,) * (a.dim() - 1)), b, a)
                       for a, b in zip(old, new)))


def _sqp_scan(params, bank, weights, cfg, c0, x_ref, u_ref, warm: WarmStart,
              qp_step, refine: bool = False):
    """sqp_iters SQP iterations of `qp_step` on B rows, then (with `refine`)
    up to refine_iters gated ones at `cfg.refine_admm`, each kept only on the
    rows that still need it.  Returns the new warm start and the SQPInfo
    without its cost."""
    if cfg.sqp_iters < 1:
        raise ValueError("the SQP needs sqp_iters >= 1")
    B = c0.shape[0]
    x_ref = _per_scenario_ref(bank, x_ref, B)
    geo = _masked_geometry(bank)
    step = partial(_sqp_iteration, qp_step, params, bank, weights, x_ref, u_ref, geo)
    warm = warm._replace(X=torch.cat([c0[:, None], warm.X[:, 1:]], dim=1),
                         rho=warm.rho.expand(B))
    for _ in range(cfg.sqp_iters):
        warm, info = step(cfg, warm)
    if refine:
        # The JAX package gates each refine iteration with lax.cond, a select
        # under vmap: every row computes it, the rows that have converged keep
        # their state.  Once no row needs it, every later iteration would keep
        # every row as it is, so the loop stops there (one host read an
        # iteration; the values are those of the full loop).
        rcfg = cfg._replace(admm=cfg.refine_admm or cfg.admm)
        for _ in range(cfg.refine_iters):
            need = torch.maximum(info.r_prim, info.du_norm) > cfg.refine_tol
            with span("ft_mpc.sync"):
                needed = bool(need.any())
            if not needed:
                break
            new, new_info = step(rcfg, warm)
            warm, info = _where_rows(need, new, warm), _where_rows(need, new_info, info)
    return warm, info


def _rows(tree, idx):
    """Rows idx of every tensor leaf of a NamedTuple (None leaves pass)."""
    return type(tree)(*(None if a is None else a[idx] for a in tree))


def _set_rows(tree, idx, rows):
    """`tree` with rows idx of every tensor leaf replaced (out of place)."""
    return type(tree)(*(None if a is None else a.index_copy(0, idx, b)
                        for a, b in zip(tree, rows)))


def _cleanup_config(cfg: MPCConfig) -> MPCConfig:
    """The cleanup's configuration on either backend: one SQP iteration at a
    cleanup_iters x cleanup_phases ADMM budget, with the loose rho clip of a
    cold metric, and no cleanup of its own."""
    budget = dict(iters=cfg.cleanup_iters, phases=cfg.cleanup_phases, adapt_clip=5.0)
    return cfg._replace(sqp_iters=1, cleanup_iters=0, admm=cfg.admm._replace(**budget),
                        stagewise=cfg.stagewise._replace(**budget))


def _cleanup(scan, params, bank, weights, cfg, c0, x_ref, u_ref, warm: WarmStart,
             info: SQPInfo):
    """The worst-K cleanup of the batched backends.  Each of cleanup_rounds
    rounds ranks the rows on r_prim + du_norm + defect (the QP residual, the
    SQP step and the shooting defect), runs `scan`, the backend's own, at
    `_cleanup_config` on the K = min(cleanup_k, B) worst rows from their
    duals and rho (kinv None: an exact metric) and writes their results
    back, out of place."""
    if cfg.cleanup_iters <= 0 or cfg.cleanup_k <= 0:
        return warm, info
    ccfg = _cleanup_config(cfg)
    p_ax = params_batch_axes(params)
    K = min(cfg.cleanup_k, c0.shape[0])
    for _ in range(cfg.cleanup_rounds):
        with span("ft_mpc.cleanup"):
            # torch.topk may order ties differently from lax.top_k
            _, idx = torch.topk(info.r_prim + info.du_norm + info.defect, K)
            warm_k, info_k = scan(_params_row(params, p_ax, idx), take_rows(bank, idx),
                                  weights, ccfg, c0[idx], x_ref, u_ref,
                                  _rows(warm._replace(kinv=None), idx))
            warm, info = _set_rows(warm, idx, warm_k), _set_rows(info, idx, info_k)
    return warm, info


def _cold_kinv(params, bank, weights, cfg, c0, x_ref, u_ref, warm: WarmStart):
    """The exact K^{-1} of the condensed QP at warm's trajectory pinned to
    c0, at warm.rho: the metric a cold start carries into its first solve."""
    X = torch.cat([c0[:, None], warm.X[:, 1:]], dim=1)
    qp, _, _, _ = _assemble_condensed_batch(
        params, bank, weights, cfg, X, warm.U, _per_scenario_ref(bank, x_ref, c0.shape[0]),
        u_ref, *_masked_geometry(bank))
    K, _ = build_K(qp, warm.rho.to(torch.float32), cfg.admm.sigma)
    return exact_kinv(K)


def sqp_solve_batch(params: BodyParams, bank: Scenario, weights: MPCWeights,
                    cfg: MPCConfig, c0, x_ref, u_ref, warm: WarmStart):
    """Batched SQP over a scenario bank on the condensed backend, then the
    worst-K cleanup.

    warm.kinv is Newton-refreshed each solve and carried across steps;
    with kinv=None the exact metric is factored once before the loop.
    """
    if warm.kinv is None:
        warm = warm._replace(kinv=_cold_kinv(params, bank, weights, cfg, c0, x_ref, u_ref,
                                             warm))
    scan = partial(_sqp_scan, qp_step=_qp_condensed_lanes)
    new_warm, info = scan(params, bank, weights, cfg, c0, x_ref, u_ref, warm)
    new_warm, info = _cleanup(scan, params, bank, weights, cfg, c0, x_ref, u_ref,
                              new_warm, info)
    return new_warm, _with_cost(bank, weights, x_ref, new_warm, info)


def sqp_solve_rows(params: BodyParams, bank: Scenario, weights: MPCWeights,
                   cfg: MPCConfig, c0, x_ref, u_ref, warm: WarmStart):
    """The per-scenario SQP (`sqp_solve`) on every row of a bank at once.

    c0 (B, 13), x_ref (Nt+1, 9) / u_ref (Nt+1, 6) shared windows, warm
    batched with kinv None.  Each row gets what the JAX package's
    `vmap(sqp_solve)` gives it: the condensed backend on the exact-refactor
    `solve_mpc_qp`, the stagewise one on `solve_mpc_qp_stagewise` in
    `cfg.stagewise.mode`, and the gated refinement.  Plain torch: no kernel.
    """
    new_warm, info = _sqp_scan(params, bank, weights, cfg, c0, x_ref, u_ref, warm,
                               _qp_step_rows(cfg), refine=cfg.refine_iters > 0)
    return new_warm, _with_cost(bank, weights, x_ref, new_warm, info)


def _one(tree):
    """A tree of one scenario's tensors as a bank of one row (None stays)."""
    return tree_map(lambda x: None if x is None else x[None], tree)


def _first(tree):
    return tree_map(lambda x: None if x is None else x[0], tree)


def sqp_solve(params: BodyParams, scenario: Scenario, weights: MPCWeights,
              cfg: MPCConfig, c0, x_ref, u_ref, warm: WarmStart):
    """Fixed-iteration SQP on one scenario (the JAX package's shapes:
    c0 (13,), warm without a batch axis); `sqp_solve_rows` at one row."""
    new_warm, info = sqp_solve_rows(params, _one(scenario), weights, cfg, c0[None],
                                    x_ref, u_ref, _one(warm))
    return _first(new_warm), _first(info)


def _sqp_batch_stagewise_core(params, bank, weights, cfg, c0, x_ref, u_ref,
                              warm: WarmStart):
    """One batched stagewise SQP scan (no cleanup; the info without its cost).

    mode='lanes' (`cfg.stagewise.mode`): batched assembly +
    `solve_mpc_qp_stagewise_lanes`, whose every ADMM x-update is two kernel
    launches for the whole bank.  Other modes: the per-scenario path's scan
    on the bank, refinement included (the JAX package's vmap of `sqp_solve`).
    """
    if cfg.stagewise.mode != "lanes":
        return _sqp_scan(params, bank, weights, cfg, c0, x_ref, u_ref, warm,
                         _qp_step_rows(cfg), refine=cfg.refine_iters > 0)
    return _sqp_scan(params, bank, weights, cfg, c0, x_ref, u_ref, warm,
                     partial(_qp_stagewise, solve_mpc_qp_stagewise_lanes))


def sqp_solve_batch_stagewise(params: BodyParams, bank: Scenario, weights: MPCWeights,
                              cfg: MPCConfig, c0, x_ref, u_ref, warm: WarmStart):
    """Batched SQP on the stagewise (Riccati-in-ADMM) backend, then the same
    worst-K cleanup as the condensed backend.  warm.kinv stays None: this
    backend has no condensed metric.
    """
    new_warm, info = _sqp_batch_stagewise_core(params, bank, weights, cfg, c0, x_ref,
                                               u_ref, warm)
    new_warm, info = _cleanup(_sqp_batch_stagewise_core, params, bank, weights, cfg, c0,
                              x_ref, u_ref, new_warm, info)
    return new_warm, _with_cost(bank, weights, x_ref, new_warm, info)


def _check_backend(cfg: MPCConfig) -> None:
    if cfg.qp_backend not in ("condensed", "stagewise"):
        raise ValueError(f"unknown qp_backend {cfg.qp_backend!r}")


def init_warmstart_batch(params: BodyParams, bank: Scenario, weights: MPCWeights,
                         cfg: MPCConfig, c0, x_ref, u_ref) -> WarmStart:
    """Batched warm start plus the exact cold-start inverse ADMM metric.

    The stagewise backend factors per stage and has no condensed metric:
    its warm start keeps kinv=None.
    """
    _check_backend(cfg)
    warm = init_warmstart(params, bank, cfg, c0, weights=weights)
    if cfg.qp_backend == "stagewise":
        return warm
    return warm._replace(kinv=_cold_kinv(params, bank, weights, cfg, c0, x_ref, u_ref, warm))


def _wrench_command(scenario: Scenario, c0, u0, u_ref0):
    """The first SQP input un-rotated: u0 + rotated nominal + compensation,
    turned into the robot frame by the spiral frame quaternion beta."""
    with span("ft_mpc.wrench"):
        u_nom = _matvec(rot_full_inv(c0[..., 9:13]), u_ref0)
        return _matvec(rot_full(scenario.beta), u0 + u_nom + scenario.u_comp)


def _finalize_control(params: BodyParams, scenario: Scenario, c0, u0, u_ref0):
    """Wrench command and its per-scenario (plain) thruster allocation."""
    u_res = _wrench_command(scenario, c0, u0, u_ref0)
    with span("ft_mpc.allocation"):
        alloc = allocate_thrusters(
            u_res, params.D, scenario.u_ub, scenario.faulty_force_gen,
            scenario.hull_A, scenario.hull_b, scenario.hull_mask,
            gen_G=scenario.gen_G, gen_c=scenario.gen_c, gen_L=scenario.gen_L,
            max_thrust=params.max_thrust,
        )
    return u_res, alloc


def get_control_rows(params: BodyParams, bank: Scenario, weights: MPCWeights,
                     cfg: MPCConfig, x0, x_ref, u_ref, warm: WarmStart) -> ControlOutput:
    """The per-scenario control step (`get_control`) on every row of a bank.

    x0 (B, 13) robot states, warm batched (kinv None); each row gets what the
    JAX package's `vmap(get_control)` gives it: `sqp_solve_rows`, then the
    wrench transform and the plain `allocate_thrusters`.  No kernel runs.
    """
    with span("ft_mpc.step"):
        c0 = robot_to_center(bank.r, x0)
        new_warm, info = sqp_solve_rows(params, bank, weights, cfg, c0, x_ref, u_ref, warm)
        u_res, alloc = _finalize_control(params, bank, c0, new_warm.U[:, 0], u_ref[0])
        return ControlOutput(u_phys=alloc.u_phys, wrench=u_res, c0=c0, warm=new_warm,
                             info=info, alloc=alloc)


def get_control(params: BodyParams, scenario: Scenario, weights: MPCWeights,
                cfg: MPCConfig, x0, x_ref, u_ref, warm: WarmStart) -> ControlOutput:
    """One full control step for one scenario: transform, SQP, un-rotate,
    allocate.

    The JAX package's shapes: x0 (13,), one scenario, warm from
    `init_warmstart` or `shift_warmstart` without a batch axis.  Runs
    `get_control_rows` at one row; warm-start shifting is the caller's.
    """
    out = get_control_rows(params, _one(scenario), weights, cfg, x0[None], x_ref, u_ref,
                           _one(warm))
    return _first(out)


def get_control_batch(params: BodyParams, bank: Scenario, weights: MPCWeights,
                      cfg: MPCConfig, x0, x_ref, u_ref, warm: WarmStart) -> ControlOutput:
    """One full control step for a scenario bank.

    x0 (B, 13) robot states; x_ref (Nt+1, 9) / u_ref (Nt+1, 6) shared
    reference windows; warm from `init_warmstart_batch` or the previous step.
    Per-scenario mass/inertia may ride on leading axes of `params`; D and
    max_thrust stay shared.  `cfg.qp_backend` routes the SQP: 'condensed'
    (short horizons) or 'stagewise' (long horizons); the allocation is the
    same kernel for both.
    """
    with span("ft_mpc.step"):
        _check_backend(cfg)
        c0 = robot_to_center(bank.r, x0)
        solve = sqp_solve_batch_stagewise if cfg.qp_backend == "stagewise" else sqp_solve_batch
        new_warm, info = solve(params, bank, weights, cfg, c0, x_ref, u_ref, warm)
        u_res = _wrench_command(bank, c0, new_warm.U[:, 0], u_ref[0])
        with span("ft_mpc.allocation"):
            alloc = allocate_thrusters_lanes(
                u_res, params.D, bank.u_ub, bank.faulty_force_gen,
                bank.hull_A, bank.hull_b, bank.hull_mask,
                bank.gen_G, bank.gen_c, bank.gen_L, params.max_thrust,
            )
        return ControlOutput(u_phys=alloc.u_phys, wrench=u_res, c0=c0,
                             warm=new_warm, info=info, alloc=alloc)


class BatchSpiralingController(torch.nn.Module):
    """Thin module around `get_control_batch`.

    Holds the plant, the scenario bank and the weights as buffers (so
    `.to(device)` moves them); `forward` is one control step.
    """

    def __init__(self, params: BodyParams, bank: Scenario, weights: MPCWeights,
                 cfg: MPCConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self._specs = {}
        for name, tree in (("params", params), ("bank", bank), ("weights", weights)):
            leaves, spec = tree_flatten(tree)
            self._specs[name] = (spec, len(leaves))
            for i, leaf in enumerate(leaves):
                self.register_buffer(
                    f"{name}_{i}", None if leaf is None else leaf.to(dev)
                )

    def _tree(self, name):
        spec, n = self._specs[name]
        return tree_unflatten([getattr(self, f"{name}_{i}") for i in range(n)], spec)

    @property
    def params(self) -> BodyParams:
        return self._tree("params")

    @property
    def bank(self) -> Scenario:
        return self._tree("bank")

    @property
    def weights(self) -> MPCWeights:
        return self._tree("weights")

    def init_warmstart(self, x0, x_ref, u_ref) -> WarmStart:
        bank = self.bank
        c0 = robot_to_center(bank.r, x0)
        return init_warmstart_batch(self.params, bank, self.weights, self.cfg,
                                    c0, x_ref, u_ref)

    def forward(self, x0, x_ref, u_ref, warm: WarmStart) -> ControlOutput:
        return get_control_batch(self.params, self.bank, self.weights, self.cfg,
                                 x0, x_ref, u_ref, warm)
