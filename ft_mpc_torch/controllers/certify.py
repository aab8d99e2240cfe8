"""Solver-independent optimality certificate of an SQP solution, counterpart
of `ft_mpc_tpu/controllers/certify.py`.

Given a candidate (X, U) of the spiraling MPC NLP, `kkt_residuals` measures
  * dynamics feasibility: the largest shooting defect |F(x_t, u_t) - x_{t+1}|;
  * primal feasibility: hull and terminal-set violations;
  * stationarity: the smallest |grad J + A_act' lambda|_inf over lambda >= 0,
    J the single-shooting reduced objective and A_act the active hull rows
    and terminal rows (the latter through the rollout's jacobian).
`jax.grad` and `jax.jacfwd` become `torch.func.grad` and `torch.func.jacfwd`;
run it in float64 (a Python float times a 0-dim tensor gives float64
tangents, which a float32 path would mix in).  One scenario, unbatched.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ft_mpc_torch.controllers.spiraling import (
    N_OPT,
    MPCConfig,
    MPCWeights,
    WarmStart,
    _stage_dynamics,
)
from ft_mpc_torch.geometry.scenario import Scenario
from ft_mpc_torch.ops.dynamics import BodyParams
from ft_mpc_torch.ops.quaternion import rot_full_inv
from ft_mpc_torch.terminal.poly import terminal_value

_BIG = 1e8


def _rollout(stage_dyn, c0, u_ref, Nt, U_flat) -> list[torch.Tensor]:
    """States x_1..x_Nt of the single-shooting rollout from c0."""
    Uu = U_flat.reshape(Nt, -1)
    x, Xs = c0, []
    for t in range(Nt):
        x = stage_dyn(x, Uu[t], u_ref[t])
        Xs.append(x)
    return Xs


class KKTResiduals(NamedTuple):
    defect: torch.Tensor  # max shooting-equality violation
    hull_violation: torch.Tensor  # max input-constraint violation
    term_violation: torch.Tensor  # max terminal-set violation
    stationarity: torch.Tensor  # |projected reduced gradient|_inf


def kkt_residuals(
    params: BodyParams,
    scenario: Scenario,
    weights: MPCWeights,
    cfg: MPCConfig,
    c0: torch.Tensor,
    x_ref: torch.Tensor,
    u_ref: torch.Tensor,
    point: WarmStart,
) -> KKTResiduals:
    Nt = cfg.horizon
    X, U = point.X, point.U
    stage_dyn = partial(_stage_dynamics, params, scenario)

    hull_A = scenario.hull_A * scenario.hull_mask[:, None]
    hull_b = torch.where(scenario.hull_mask > 0.5, scenario.hull_b, _BIG)
    term_A = scenario.term_A * scenario.term_mask[:, None]
    term_b = torch.where(scenario.term_mask > 0.5, scenario.term_b, _BIG)

    f_vals = stage_dyn(X[:-1], U, u_ref[:Nt])
    defect = (f_vals - X[1:]).abs().max()

    u_r = torch.einsum("tij,tj->ti", rot_full_inv(X[:-1, 9:13]), u_ref[:Nt])
    w_tot = U + u_r + scenario.u_comp + scenario.faulty_force_gen
    slack_hull = hull_b[None, :] - w_tot @ hull_A.T  # (Nt, F)
    hull_viol = torch.clamp(-slack_hull.min(), min=0.0)

    e_N = X[-1, :N_OPT] - x_ref[-1]
    slack_term = term_b - term_A @ e_N
    term_viol = torch.clamp(-slack_term.min(), min=0.0)

    def J(U_flat):
        Xfull = torch.stack([c0] + _rollout(stage_dyn, c0, u_ref, Nt, U_flat))
        Uu = U_flat.reshape(Nt, -1)
        e = Xfull[:-1, :N_OPT] - x_ref[:-1]
        cost = (torch.einsum("ti,ij,tj->", e, weights.Q, e)
                + torch.einsum("ti,ij,tj->", Uu, weights.R, Uu))
        eN = Xfull[-1, :N_OPT] - x_ref[-1]
        return cost + terminal_value(scenario.term, eN)

    grad = torch.func.grad(J)(U.reshape(-1)).reshape(Nt, -1)

    # Stationarity: -grad must lie in the cone of the active constraint
    # normals: the stage-separable hull rows, and the active terminal rows
    # through the jacobian of e_N in U.  The dual NNLS
    #   min_{lambda >= 0} |grad + A_act' lambda|
    # by FISTA with step 1 / lambda_max(A A') from power iteration.
    act_hull = (slack_hull < 1e-5).to(grad.dtype)  # (Nt, F)
    act_term = (slack_term < 1e-5).to(grad.dtype)  # (Tm,)

    eN_jac = torch.func.jacfwd(
        lambda Uf: _rollout(stage_dyn, c0, u_ref, Nt, Uf)[-1][:N_OPT] - x_ref[-1]
    )(U.reshape(-1))  # (9, Nt*m)
    G_term_red = term_A @ eN_jac  # (Tm, Nt*m)

    eye = torch.eye(Nt, dtype=grad.dtype, device=grad.device)
    A_rows = torch.cat([
        # row (t, f): hull_A[f] in stage t's input slots, zero elsewhere
        torch.einsum("tf,fi,tj->tfji", act_hull, hull_A, eye).reshape(
            Nt * hull_A.shape[0], -1),
        act_term[:, None] * G_term_red,
    ])
    g_flat = grad.reshape(-1)

    v = torch.ones(A_rows.shape[1], dtype=grad.dtype, device=grad.device)
    for _ in range(15):
        w = A_rows.T @ (A_rows @ v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    lmax = torch.clamp(torch.linalg.vector_norm(A_rows.T @ (A_rows @ v)), min=1e-6)
    step = 1.0 / lmax

    lam = torch.zeros(A_rows.shape[0], dtype=grad.dtype, device=grad.device)
    eta, t = lam, 1.0
    for _ in range(1000):
        r = g_flat + A_rows.T @ eta
        lam_new = torch.clamp(eta - step * (A_rows @ r), min=0.0)
        t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        eta = lam_new + ((t - 1.0) / t_new) * (lam_new - lam)
        lam, t = lam_new, t_new
    stationarity = (g_flat + A_rows.T @ lam).abs().max()

    return KKTResiduals(
        defect=defect,
        hull_violation=hull_viol,
        term_violation=term_viol,
        stationarity=stationarity,
    )
