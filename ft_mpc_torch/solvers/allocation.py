"""Thruster control allocation, counterpart of `ft_mpc_tpu/solvers/allocation.py`.

Maps a 6-d wrench command to 16 nonnegative thruster magnitudes:
  1. the total wrench (command + stuck-on fault) is projected onto the
     attainable zonotope w = gen_c + gen_G theta, theta in [0,1]^16, by FISTA
     (a box-constrained least squares) when the halfspace test says it lies
     outside; without generator data a halfspace QP does the projection;
  2. minimum-energy allocation min ||u||^2 s.t. D u = w_des, 0 <= u <= u_ub
     by the dense ADMM, a min-norm equality polish over healthy thrusters,
     and the FISTA feasible point as the fallback when ADMM fails to
     realize the wrench.

This is the per-scenario path (plain torch, as the JAX package leaves it to
XLA); every argument may carry leading batch dims, and D is shared.  The
batched kernel path is `solvers.lanes_alloc.allocate_thrusters_lanes`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ft_mpc_torch.solvers.admm import QP, ADMMConfig, _mTv, _mv, admm_solve

_BIG = 1e8


class AllocationResult(NamedTuple):
    u_phys: torch.Tensor  # (..., 16) thruster commands
    wrench_clipped: torch.Tensor  # (..., 6) wrench actually allocated
    was_clipped: torch.Tensor  # (...,) bool
    r_prim: torch.Tensor  # (...,) allocation equality residual
    used_fallback: torch.Tensor  # (...,) bool: FISTA feasible point used


def project_wrench_zonotope(w0, gen_G, gen_c, gen_L, iters: int = 60):
    """Euclidean projection of w0 onto the attainable zonotope via FISTA.

    w0 (..., 6), gen_G (..., 6, 16), gen_c (..., 6), gen_L (...,).
    Returns (w_projected, theta) with w = gen_c + gen_G theta exactly.
    """
    n = gen_G.shape[-1]
    step = (1.0 / gen_L)[..., None]
    theta = torch.full((*w0.shape[:-1], n), 0.5, dtype=w0.dtype, device=w0.device)
    eta = theta
    # the momentum sequence is the same for every row; a 0-dim tensor keeps it
    # in the working dtype, as the JAX loop carries it
    t = torch.ones((), dtype=w0.dtype, device=w0.device)
    for _ in range(iters):
        grad = _mTv(gen_G, _mv(gen_G, eta) + gen_c - w0)
        theta_new = torch.clamp(eta - step * grad, 0.0, 1.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        eta = theta_new + ((t - 1.0) / t_new) * (theta_new - theta)
        theta, t = theta_new, t_new
    return gen_c + _mv(gen_G, theta), theta


def _hull_feasible(w, hull_A, hull_b, hull_mask):
    A = hull_A * hull_mask[..., None]
    b = torch.where(hull_mask > 0.5, hull_b, _BIG)
    return (_mv(A, w) <= b + 1e-7).all(dim=-1), A, b


def clip_wrench(w0, hull_A, hull_b, hull_mask, gen_G=None, gen_c=None, gen_L=None,
                iters: int = 60):
    """Project w0 onto the attainable set.  Returns (w, was_clipped).

    The halfspace test (A w <= b) decides `was_clipped`; with generator data
    the projection is the exact FISTA one, otherwise a halfspace QP.
    """
    feasible, A, b = _hull_feasible(w0, hull_A, hull_b, hull_mask)
    if gen_G is not None:
        w_proj, _ = project_wrench_zonotope(w0, gen_G, gen_c, gen_L, iters)
    else:
        n = w0.shape[-1]
        eye = torch.eye(n, dtype=w0.dtype, device=w0.device)
        qp = QP(P=eye.expand(*w0.shape[:-1], n, n), q=-w0, A=A,
                l=torch.full_like(b, -_BIG), u=b)
        w_proj = admm_solve(qp, ADMMConfig(iters=60, phases=4, rho=20.0)).x
    return torch.where(feasible[..., None], w0, w_proj), ~feasible


def allocate_thrusters(
    wrench_cmd,
    D,
    u_ub,
    faulty_force_gen,
    hull_A,
    hull_b,
    hull_mask,
    gen_G=None,
    gen_c=None,
    gen_L=None,
    max_thrust=3.4,
    cfg: ADMMConfig = ADMMConfig(iters=40, phases=1, rho=1.0),
) -> AllocationResult:
    """Full allocation path: fault offset, zonotope projection, min-energy QP.

    The total wrench (command + stuck-on fault) is clipped to the attainable
    set, the fault contribution is subtracted back out, and the remainder is
    distributed over healthy thrusters with minimum energy.
    """
    dtype, dev = wrench_cmd.dtype, wrench_cmd.device
    lead = wrench_cmd.shape[:-1]
    w_total = wrench_cmd + faulty_force_gen
    if gen_G is not None:
        feasible, _, _ = _hull_feasible(w_total, hull_A, hull_b, hull_mask)
        w_proj, theta = project_wrench_zonotope(w_total, gen_G, gen_c, gen_L)
        w_clipped = torch.where(feasible[..., None], w_total, w_proj)
        was_clipped = ~feasible
        # feasible allocation from the projection (exact when clipped)
        u_fallback = torch.clamp(theta * max_thrust, torch.zeros_like(u_ub), u_ub)
    else:
        w_clipped, was_clipped = clip_wrench(w_total, hull_A, hull_b, hull_mask)
        u_fallback = None
    w_des = w_clipped - faulty_force_gen

    n = D.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=dev)
    Dl = D.expand(*lead, *D.shape[-2:])
    qp = QP(
        P=(2.0 * eye).expand(*lead, n, n),
        q=torch.zeros(*lead, n, dtype=dtype, device=dev),
        A=torch.cat([Dl, eye.expand(*lead, n, n)], dim=-2),
        l=torch.cat([w_des, torch.zeros_like(u_ub)], dim=-1),
        u=torch.cat([w_des, u_ub], dim=-1),
    )
    sol = admm_solve(qp, cfg)
    zero = torch.zeros_like(u_ub)
    u = torch.clamp(sol.x, zero, u_ub)
    # min-norm equality polish over healthy thrusters: removes the penalty
    # method's equality residual in one 6x6 solve; broken thrusters are
    # masked so the box clip cannot reintroduce the residual through them
    healthy = torch.where(u_ub > 1e-12, 1.0, 0.0).to(dtype)
    Dm = Dl * healthy[..., None, :]
    W2 = Dm @ Dm.transpose(-1, -2) + 1e-6 * torch.eye(D.shape[-2], dtype=dtype, device=dev)
    lam = torch.linalg.solve_ex(W2, w_des - _mv(Dl, u))[0]
    u = torch.clamp(u + healthy * _mTv(Dm, lam), zero, u_ub)
    eq_err = (_mv(Dl, u) - w_des).abs().amax(dim=-1)
    used_fallback = torch.zeros(lead, dtype=torch.bool, device=dev)
    if u_fallback is not None:
        # swap to the feasibility-only fallback only when ADMM genuinely
        # failed to realize the wrench, not on marginal residual wins
        fb_err = (_mv(Dl, u_fallback) - w_des).abs().amax(dim=-1)
        used_fallback = (eq_err > 1e-2) & (fb_err < eq_err - 1e-9)
        u = torch.where(used_fallback[..., None], u_fallback, u)
    return AllocationResult(
        u_phys=u,
        wrench_clipped=w_des,
        was_clipped=was_clipped,
        r_prim=(_mv(Dl, u) - w_des).abs().amax(dim=-1),
        used_fallback=used_fallback,
    )
