"""Independent reference solver for the spiraling MPC NLP (validation
only), counterpart of `ft_mpc_tpu/controllers/reference_solver.py`.

The same NLP in single-shooting form, solved by scipy's SLSQP (a BFGS-class
SQP with an active-set QP core, none of the deployed ADMM/RTI machinery) in
float64, with objective, gradient, constraints and constraint jacobian from
`torch.func` (exact derivatives):

  min_U  sum_t e_t' Q e_t + u_t' R u_t  +  V_f(e_N)
  s.t.   hull_A (u_t + R(x_t) u_ref_t + u_comp + u_unc) <= hull_b   (per t)
         term_A e_N <= term_b
  with   x_{t+1} = F(x_t, u_t)   (RK4 centre dynamics, substituted)

plus the stage state box and wrench-rate rows when the weights carry them.
One scenario on the host (or any device), seconds per solve.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ft_mpc_torch.controllers.spiraling import N_OPT, N_U, _stage_dynamics
from ft_mpc_torch.geometry.scenario import Scenario
from ft_mpc_torch.ops.dynamics import BodyParams
from ft_mpc_torch.ops.quaternion import rot_full_inv
from ft_mpc_torch.terminal.poly import terminal_value

_BIG = 1e8


class ReferenceSolution(NamedTuple):
    U: np.ndarray  # (Nt, 6) optimal input deviations
    X: np.ndarray  # (Nt+1, 13) rolled-out states
    cost: float
    max_violation: float  # worst inequality violation at the solution
    success: bool
    n_iter: int


def _build_funcs(params, scenario, weights, Nt, c0, x_ref, u_ref):
    """(roll, objective, constraints) as functions of the flat U (Nt*6,)."""
    stage_dyn = partial(_stage_dynamics, params, scenario)
    hull_A = scenario.hull_A * scenario.hull_mask[:, None]
    hull_b = torch.where(scenario.hull_mask > 0.5, scenario.hull_b, _BIG)
    term_A = scenario.term_A * scenario.term_mask[:, None]
    term_b = torch.where(scenario.term_mask > 0.5, scenario.term_b, _BIG)

    def roll(U_flat):
        U = U_flat.reshape(Nt, N_U)
        x, Xs = c0, [c0]
        for t in range(Nt):
            x = stage_dyn(x, U[t], u_ref[t])
            Xs.append(x)
        return torch.stack(Xs)

    def objective(U_flat):
        U = U_flat.reshape(Nt, N_U)
        X = roll(U_flat)
        e = X[1:-1, :N_OPT] - x_ref[1:-1]
        J = torch.einsum("ti,ij,tj->", e, weights.Q, e)
        J = J + torch.einsum("ti,ij,tj->", U, weights.R, U)
        return J + terminal_value(scenario.term, X[-1, :N_OPT] - x_ref[-1])

    def constraints(U_flat):
        """Stacked inequality slacks, >= 0 feasible (SLSQP convention); the
        stage state box (stages 1..Nt-1) and wrench-rate rows when the
        weights carry x_lb / x_ub / du_max."""
        U = U_flat.reshape(Nt, N_U)
        X = roll(U_flat)
        u_r = torch.einsum("tij,tj->ti", rot_full_inv(X[:-1, 9:13]), u_ref[:Nt])
        w_tot = U + u_r + scenario.u_comp + scenario.faulty_force_gen
        slack_hull = hull_b[None, :] - w_tot @ hull_A.T  # (Nt, F)
        e_N = X[-1, :N_OPT] - x_ref[-1]
        slack_term = term_b - term_A @ e_N
        slacks = [slack_hull.reshape(-1), slack_term]
        if getattr(weights, "x_lb", None) is not None or \
                getattr(weights, "x_ub", None) is not None:
            xs = X[1:-1]
            if weights.x_ub is not None:
                slacks.append((weights.x_ub[None] - xs).reshape(-1))
            if weights.x_lb is not None:
                slacks.append((xs - weights.x_lb[None]).reshape(-1))
        if getattr(weights, "du_max", None) is not None:
            dw = w_tot[1:] - w_tot[:-1]
            dmax = weights.du_max[None]
            slacks.append((dmax - dw).reshape(-1))
            slacks.append((dmax + dw).reshape(-1))
        return torch.cat(slacks)

    return roll, objective, constraints


def solve_reference(
    params: BodyParams,
    scenario: Scenario,
    weights,
    Nt: int,
    c0,
    x_ref,  # (Nt+1, 9)
    u_ref,  # (Nt+1, 6)
    U0=None,  # (Nt, 6) initial guess (deviations)
    maxiter: int = 300,
    ftol: float = 1e-12,
) -> ReferenceSolution:
    """Solve the condensed NLP with scipy SLSQP and `torch.func` derivatives.
    Plant, scenario and weights must be float64, on any one device."""
    from scipy.optimize import minimize

    if scenario.hull_A.dtype != torch.float64 or params.mass.dtype != torch.float64:
        raise RuntimeError("the reference solver runs in float64: pass a float64 "
                           "plant, scenario and weights")
    dev = scenario.hull_A.device
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    c0, x_ref, u_ref = as_t(c0), as_t(x_ref), as_t(u_ref)
    roll, objective, constraints = _build_funcs(
        params, scenario, weights, Nt, c0, x_ref, u_ref
    )
    grad = torch.func.grad(objective)
    conjac = torch.func.jacfwd(constraints)
    host = lambda t: t.detach().cpu().numpy()

    U0 = np.zeros(Nt * N_U) if U0 is None else np.asarray(U0, np.float64).ravel()
    res = minimize(
        lambda u: float(objective(as_t(u))),
        U0,
        jac=lambda u: host(grad(as_t(u))),
        method="SLSQP",
        constraints=[
            {
                "type": "ineq",
                "fun": lambda u: host(constraints(as_t(u))),
                "jac": lambda u: host(conjac(as_t(u))),
            }
        ],
        options={"maxiter": maxiter, "ftol": ftol},
    )
    U = res.x.reshape(Nt, N_U)
    X = host(roll(as_t(res.x)))
    viol = float(-min(0.0, float(np.min(host(constraints(as_t(res.x)))))))
    return ReferenceSolution(
        U=U,
        X=X,
        cost=float(res.fun),
        max_violation=viol,
        success=bool(res.success),
        n_iter=int(res.nit),
    )
