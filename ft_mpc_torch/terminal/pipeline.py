"""Offline terminal-ingredient pipeline (one fault class), counterpart of
`ft_mpc_tpu/terminal/pipeline.py`.

  A. `input_bound_box`: the largest (emax box, r_empc ball) whose worst-case
     acceleration (nominal, eMPC input, omega feedback and the exact
     quadratic fb-lin residual, maximized over the box facet by facet) fits
     in the attainable acceleration polytope; a 1-D sweep over emax with
     r_empc in closed form.
  B. `empc_ingredients`: per-axis double-integrator DARE and MCAIS.
  C. `sample_value_function`: V of the N-step MPC on a grid of states, every
     grid point a small condensed QP, all solved by one batched
     `ft_mpc_torch.solvers.admm.admm_solve` on the device; then
     `fit_quadratic_upper_bound` (active-set least squares, V_hat >= V).
  D. omega Lyapunov cost and assembly into (P9, p9, c), the polynomial
     cross-term tables and the block terminal set.
  E. data-only npz serialization and the cache key (`cache_key` and
     `plant_fingerprint` give the JAX package's keys byte for byte).

Everything but stage C's QPs is host numpy/scipy float64, the JAX package's
arithmetic on the same arrays, so the orbit, emax, r_empc and the terminal
set equal its results exactly.  The QPs run in the dtype the caller gives
(the plant's, where `ft_mpc_torch.api` calls it), as the JAX package runs
them in its x64 mode's.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import scipy.linalg as la
import torch

from ft_mpc_torch.geometry.invariant import mcais
from ft_mpc_torch.geometry.polytope import Polytope
from ft_mpc_torch.terminal.poly import TerminalPoly, assemble_terminal_poly, quadratic_terminal

# The port's own cache (gitignored): misses of `ft_mpc_torch.api` and the
# CLI's output go here, never into the JAX package's config directory.
PORT_TERMINAL_CACHE = Path(__file__).resolve().parents[2] / "build" / "terminal_cache"


# ----------------------------------------------------------------------------
# Stage A: input-bound box (emax, r_empc)
# ----------------------------------------------------------------------------

def fb_lin_residual(eo: np.ndarray, omega_des, r, inertia) -> np.ndarray:
    """Exact 6-d acceleration residual the double-integrator model ignores.

    For omega = omega_des + eo, g = w x (J w):
      lin: w x (w x r) - w_des x (w_des x r) - (J^-1 g) x r
      ang: -J^-1 g
    """
    w = omega_des + eo
    J = inertia
    g = np.cross(w, J @ w)
    Jinv_g = np.linalg.solve(J, g)
    lin = (
        np.cross(w, np.cross(w, r))
        - np.cross(omega_des, np.cross(omega_des, r))
        - np.cross(Jinv_g, r)
    )
    return np.concatenate([lin, -Jinv_g])


def fb_quad_coeffs(omega_des, r, inertia):
    """Exact quadratic coefficients of `fb_lin_residual` in eo, from 13
    evaluations: fb_k(eo) = eo'H_k eo + G_k.eo + c_k.
    Returns (H (6,3,3) symmetric, G (6,3), c (6,))."""
    f = lambda e: fb_lin_residual(e, omega_des, r, inertia)
    c = f(np.zeros(3))
    eye = np.eye(3)
    fp = [f(eye[i]) for i in range(3)]
    fm = [f(-eye[i]) for i in range(3)]
    H = np.zeros((6, 3, 3))
    G = np.zeros((6, 3))
    for i in range(3):
        G[:, i] = 0.5 * (fp[i] - fm[i])
        H[:, i, i] = 0.5 * (fp[i] + fm[i]) - c
    for i in range(3):
        for j in range(i + 1, 3):
            fij = f(eye[i] + eye[j])
            H[:, i, j] = H[:, j, i] = 0.5 * (
                fij - c - G[:, i] - G[:, j] - H[:, i, i] - H[:, j, j]
            )
    return H, G, c


def _quad_box_max_batch(
    H: np.ndarray, g: np.ndarray, c: np.ndarray, emax: float
) -> np.ndarray:
    """Exact max of q_f(e) = e'H_f e + g_f.e + c_f over |e_i| <= emax, per row.

    The maximizer lies on some face, as a vertex or a stationary point of q
    restricted to it: the 27 (free subset, fixed signs) candidates are
    exhaustive.  H: (F, 3, 3), g: (F, 3), c: (F,).  Returns (F,).
    """
    from itertools import product

    F = H.shape[0]
    best = np.full(F, -np.inf)

    def consider(e):  # e: (F, 3) candidate points, assumed inside the box
        q = np.einsum("fi,fij,fj->f", e, H, e) + np.einsum("fi,fi->f", g, e) + c
        np.maximum(best, q, out=best)

    idx = [0, 1, 2]
    for free_mask in product([False, True], repeat=3):
        free = [i for i in idx if free_mask[i]]
        fixed = [i for i in idx if not free_mask[i]]
        for signs in product([-emax, emax], repeat=len(fixed)):
            e = np.zeros((F, 3))
            for i, s in zip(fixed, signs):
                e[:, i] = s
            if free:
                k = len(free)
                Hff = 2.0 * H[:, free][:, :, free]  # (F, k, k)
                rhs = -(g[:, free] + 2.0 * np.einsum(
                    "fij,fj->fi", H[:, free][:, :, fixed], e[:, fixed]
                ))
                det = np.linalg.det(Hff)
                ok = np.abs(det) > 1e-12
                Hsafe = np.where(ok[:, None, None], Hff, np.eye(k)[None])
                ef = np.linalg.solve(Hsafe, rhs[..., None])[..., 0]
                inbox = np.all(np.abs(ef) <= emax * (1 + 1e-12), axis=1)
                valid = ok & inbox
                if not valid.any():
                    continue
                ef = np.clip(ef, -emax, emax)
                for j, i in enumerate(free):
                    e[:, i] = np.where(valid, ef[:, j], 0.0)
                q = (
                    np.einsum("fi,fij,fj->f", e, H, e)
                    + np.einsum("fi,fi->f", g, e)
                    + c
                )
                np.maximum(best, np.where(valid, q, -np.inf), out=best)
            else:
                consider(e)
    return best


def _fb_bound_per_facet(
    A: np.ndarray, emax: float, omega_des, r, inertia,
    coeffs=None,
) -> np.ndarray:
    """Per-facet bound max_{|eo|<=emax} a_i . fb(eo), exact (a 3-variable
    quadratic per facet, maximized over the box)."""
    Hq, Gq, cq = coeffs if coeffs is not None else fb_quad_coeffs(
        omega_des, r, inertia
    )
    Hf = np.einsum("fk,kij->fij", A, Hq)  # (F, 3, 3)
    gf = A @ Gq  # (F, 3)
    cf = A @ cq  # (F,)
    return np.maximum(_quad_box_max_batch(Hf, gf, cf, float(emax)), 0.0)


def input_bound_box(
    hull: Polytope,
    M: np.ndarray,
    f_virt6: np.ndarray,
    k_omega: np.ndarray,
    omega_des: np.ndarray,
    r: np.ndarray,
    inertia: np.ndarray,
    max_acceleration: float = 0.0,
    emax_grid=None,
) -> tuple[np.ndarray, float]:
    """Largest (emax box, r_empc ball) certified inside the acceleration set.

    Per unit-norm facet a_i of the acceleration polytope (hull through
    M^{-1}, shrunk by max_acceleration):

        r_empc ||a_i[:3]|| + a_i.(M f_virt6) + max_corner a_i.[0;-k eo]
            + fb_bound(emax) <= b_i

    For fixed emax the largest r_empc is closed-form; emax sweeps a grid
    under the log-volume objective 15 log r_empc + sum log(2 k_i emax).
    Raises RuntimeError when no grid point is feasible.
    """
    Minv = np.linalg.inv(M)
    acc = Polytope(hull.A @ Minv, hull.b).normalized()
    acc = acc.minkowski_subtract_ball(max_acceleration)
    A, b = acc.A, acc.b

    nominal = A @ (M @ f_virt6)  # per-facet nominal acceleration usage
    an_lin = np.linalg.norm(A[:, :3], axis=1)
    A_om = A[:, 3:]  # facet rows on angular-acceleration components
    k = np.asarray(k_omega, dtype=np.float64)

    if emax_grid is None:
        emax_grid = np.linspace(0.01, 1.2, 120)

    fb_coeffs = fb_quad_coeffs(
        np.asarray(omega_des), np.asarray(r), np.asarray(inertia)
    )
    best = None
    for emax in emax_grid:
        # worst corner of a_i . [0; -k eo] over |eo|<=emax:  sum |A_om k| emax
        corner = np.abs(A_om * k[None, :]).sum(axis=1) * emax
        slack = b - nominal - corner - _fb_bound_per_facet(
            A, emax, np.asarray(omega_des), np.asarray(r), np.asarray(inertia),
            coeffs=fb_coeffs,
        )
        if np.any(slack < 0):
            continue  # emax itself infeasible
        with np.errstate(divide="ignore"):
            r_caps = np.where(an_lin > 1e-9, slack / np.maximum(an_lin, 1e-9), np.inf)
        r_empc = float(np.min(r_caps))
        if r_empc <= 0:
            continue
        obj = 15.0 * np.log(r_empc) + float(np.sum(np.log(2.0 * k * emax)))
        if best is None or obj > best[0]:
            best = (obj, emax, r_empc)
    if best is None:
        raise RuntimeError("no feasible (emax, r_empc): fault pattern too severe")
    _, emax, r_empc = best
    return np.array([emax, emax, emax]), r_empc


# ----------------------------------------------------------------------------
# Stage B: per-axis eMPC ingredients
# ----------------------------------------------------------------------------

@dataclass
class AxisEMPC:
    Ad: np.ndarray  # (2, 2)
    Bd: np.ndarray  # (2, 1)
    Q: np.ndarray  # (2, 2)
    R: np.ndarray  # (1, 1)
    P: np.ndarray  # (2, 2) DARE cost-to-go
    K: np.ndarray  # (1, 2) terminal LQR gain
    uimax: float
    domain: Polytope  # MCAIS in (pos, vel)


def empc_ingredients(
    q_pos: float,
    q_vel: float,
    r_in: float,
    dt: float,
    time_scaling: float,
    uimax: float,
    pos_bound: float = 5.0,
    vel_bound: float = 1.5,
) -> AxisEMPC:
    h = time_scaling * dt
    Ad = np.array([[1.0, h], [0.0, 1.0]])
    Bd = np.array([[0.5 * h * h], [h]])
    Q = np.diag([q_pos, q_vel]) * time_scaling
    R = np.array([[r_in]]) * time_scaling
    P = la.solve_discrete_are(Ad, Bd, Q, R)
    K = np.linalg.solve(R + Bd.T @ P @ Bd, Bd.T @ P @ Ad)
    A_cl = Ad - Bd @ K

    C = np.vstack([np.eye(2), -np.eye(2), K, -K])
    d = np.array([pos_bound, vel_bound, pos_bound, vel_bound, uimax, uimax])
    domain = mcais(A_cl, C, d)
    return AxisEMPC(Ad=Ad, Bd=Bd, Q=Q, R=R, P=P, K=K, uimax=uimax, domain=domain)


# ----------------------------------------------------------------------------
# Stage C: value-function sampling (batched QPs) + quadratic upper bound
# ----------------------------------------------------------------------------

def value_function_grid(
    empc: AxisEMPC,
    horizon: int,
    pos_bound: float = 5.0,
    vel_bound: float = 1.5,
    grid_step: float = 0.1,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """V(x0) of the N-step MPC on the grid and each point's QP residual.

    Every grid point is a condensed QP in the N inputs; the grid solves as
    ONE batched `admm_solve` (60 iterations x 3 phases at rho 1) on `device`
    (default cuda) in `dtype`.  Returns (points (M, 2), values (M,),
    r_prim (M,)), host numpy.
    """
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.solvers.admm import QP, ADMMConfig, admm_solve

    N = horizon
    Ad, Bd, Q, R, P = empc.Ad, empc.Bd, empc.Q, empc.R, empc.P

    # Condensed prediction: x_k = A^k x0 + sum_j A^{k-1-j} B u_j, k=1..N
    powers = [np.linalg.matrix_power(Ad, k) for k in range(N + 1)]
    Phi = np.zeros((2 * N, N))  # stacks x_1..x_N
    Lam = np.zeros((2 * N, 2))
    for kk in range(1, N + 1):
        Lam[2 * (kk - 1) : 2 * kk] = powers[kk]
        for j in range(kk):
            Phi[2 * (kk - 1) : 2 * kk, j : j + 1] = powers[kk - 1 - j] @ Bd

    # Cost: sum_{k=0}^{N-1} x_k Q x_k + u_k R u_k + x_N P x_N
    Qbar = np.zeros((2 * N, 2 * N))
    for kk in range(1, N):
        Qbar[2 * (kk - 1) : 2 * kk, 2 * (kk - 1) : 2 * kk] = Q
    Qbar[2 * (N - 1) :, 2 * (N - 1) :] = P
    H = 2.0 * (Phi.T @ Qbar @ Phi + np.eye(N) * R[0, 0])
    Gq = 2.0 * Phi.T @ Qbar @ Lam  # q(x0) = Gq x0

    # Constraints: |u_k| <= uimax; x_k in X for k=1..N-1; x_N in domain.
    rowsA, rows_off, rows_d = [], [], []
    rowsA.append(np.eye(N))
    rows_off.append(np.zeros((N, 2)))
    rows_d.append(np.full(N, empc.uimax))
    rowsA.append(-np.eye(N))
    rows_off.append(np.zeros((N, 2)))
    rows_d.append(np.full(N, empc.uimax))
    Xbox_A = np.vstack([np.eye(2), -np.eye(2)])
    Xbox_d = np.array([pos_bound, vel_bound, pos_bound, vel_bound])
    for kk in range(1, N):
        sel = slice(2 * (kk - 1), 2 * kk)
        rowsA.append(Xbox_A @ Phi[sel])
        rows_off.append(Xbox_A @ Lam[sel])
        rows_d.append(Xbox_d)
    selN = slice(2 * (N - 1), 2 * N)
    rowsA.append(empc.domain.A @ Phi[selN])
    rows_off.append(empc.domain.A @ Lam[selN])
    rows_d.append(empc.domain.b)
    Acon = np.vstack(rowsA)
    Eoff = np.vstack(rows_off)
    dcon = np.concatenate(rows_d)

    xs = np.arange(-pos_bound, pos_bound + 1e-9, grid_step)
    vs = np.arange(-vel_bound, vel_bound + 1e-9, grid_step)
    pts = np.array([[x, v] for x in xs for v in vs])

    Mpts = pts.shape[0]
    qs = pts @ Gq.T  # (M, N)
    us = dcon[None, :] - pts @ Eoff.T  # (M, m)

    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    qp = QP(
        P=t(H).expand(Mpts, N, N),
        q=t(qs),
        A=t(Acon).expand(Mpts, *Acon.shape),
        l=torch.full((Mpts, Acon.shape[0]), -1e8, dtype=dtype, device=dev),
        u=t(us),
    )
    sol = admm_solve(qp, ADMMConfig(iters=60, phases=3, rho=1.0))
    u_opt = sol.x.cpu().numpy()
    r_prim = sol.r_prim.cpu().numpy()

    # V = 1/2 u H u + q.u + x0-dependent constant (stage-0 + condensed terms)
    x0_cost = np.einsum("mi,ij,mj->m", pts, Q, pts)  # stage-0 cost
    cross = np.einsum("mi,ij,mj->m", pts, Lam.T @ Qbar @ Lam, pts)
    V = (
        0.5 * np.einsum("mn,nk,mk->m", u_opt, H, u_opt)
        + np.einsum("mn,mn->m", qs, u_opt)
        + x0_cost
        + cross
    )
    return pts, V, r_prim


FEASIBLE_R_PRIM = 1e-4  # a grid point enters the fit where its QP's r_prim is below


def sample_value_function(
    empc: AxisEMPC,
    horizon: int,
    pos_bound: float = 5.0,
    vel_bound: float = 1.5,
    grid_step: float = 0.1,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """V(x0) of the N-step MPC on a grid, through ONE batched ADMM call on
    `device` (default cuda) in `dtype`.

    Returns (points (M, 2), values (M,), feasible (M,) bool), host numpy;
    a point is feasible where its QP's r_prim < FEASIBLE_R_PRIM.
    """
    pts, V, r_prim = value_function_grid(empc, horizon, pos_bound, vel_bound, grid_step,
                                         device=device, dtype=dtype)
    return pts, V, r_prim < FEASIBLE_R_PRIM


def _constrained_lsq_lower_bounded(Phi: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Exact solve of  min ||Phi t - v||^2  s.t.  Phi t >= v  (primal active set)."""
    n = Phi.shape[1]
    H = Phi.T @ Phi
    Pv = Phi.T @ v
    scale = max(1.0, float(np.abs(v).max()))
    feas_tol = 1e-9 * scale

    t = np.linalg.lstsq(Phi, v, rcond=None)[0]  # unconstrained LSQ start
    S: list[int] = []
    for _ in range(200):
        resid = Phi @ t - v
        resid[S] = 0.0  # working-set rows are equalities (numerically exact)
        worst = int(np.argmin(resid))
        if resid[worst] >= -feas_tol:
            return t  # feasible, working-set multipliers already all valid
        S.append(worst)
        while True:
            A = Phi[S]
            k = len(S)
            KKT = np.block([[H, A.T], [A, np.zeros((k, k))]])
            rhs = np.concatenate([Pv, v[S]])
            sol = np.linalg.lstsq(KKT, rhs, rcond=None)[0]
            t, lam = sol[:n], sol[n:]
            # constraint Phi_S t >= v_S active with multiplier mu = -2 lam >= 0
            bad = np.where(lam > 1e-10 * scale)[0]
            if bad.size == 0:
                break
            S.pop(int(bad[np.argmax(lam[bad])]))
    return t


def fit_quadratic_upper_bound(pts: np.ndarray, vals: np.ndarray):
    """Least-squares quadratic upper bound: min sum (V_hat - V)^2, V_hat >= V,
    theta = (axx, axv, avv, bx, bv, c), V_hat = [x^2, 2xv, v^2, x, v, 1].theta.
    Returns (A2 (2, 2), b2 (2,), c)."""
    x, v = pts[:, 0], pts[:, 1]
    Phi = np.stack([x * x, 2 * x * v, v * v, x, v, np.ones_like(x)], axis=1)
    theta = _constrained_lsq_lower_bounded(
        Phi.astype(np.float64), np.asarray(vals, np.float64)
    )
    A2 = np.array([[theta[0], theta[1]], [theta[1], theta[2]]])
    b2 = theta[3:5]
    # Exactness guard: lift c by the residual underside (zero up to round-off).
    under = float(np.max(vals - Phi @ theta))
    c = float(theta[5]) + max(under, 0.0)
    return A2, b2, c


# ----------------------------------------------------------------------------
# Stage D/E: assembly
# ----------------------------------------------------------------------------

@dataclass
class TerminalIngredients:
    P9: np.ndarray  # (9, 9) quadratic part (cost_empc + cost_omega)
    p9: np.ndarray  # (9,)
    c: float
    term: TerminalPoly  # full certified cost incl. cross_1/cross_2 tables
    term_set: Polytope  # over the 9-d error
    emax: np.ndarray  # (3,)
    r_empc: float
    meta: dict
    # the value-function grid this run sampled (None for an entry read from
    # a file or a quadratic fallback); never saved
    grid: ValueGrid | None = None


class ValueGrid(NamedTuple):
    """Stage C's grid as `compute_terminal_ingredients` solved it."""

    empc: AxisEMPC  # the per-axis eMPC whose value function was sampled
    horizon: int
    points: np.ndarray  # (M, 2)
    values: np.ndarray  # (M,)
    r_prim: np.ndarray  # (M,), each point's QP residual; feasible below FEASIBLE_R_PRIM


def axis_empc(hull: Polytope, M, f_virt6, omega_des, r, inertia, dt: float, Q, R,
              k_omega, max_acceleration: float = 0.0, time_scaling: float = 5.0):
    """Stages A and B: (emax, r_empc, the per-axis eMPC, Qu_tilde = M^-T R M^-1)
    for diagonal-or-full Q and R.  Raises RuntimeError where stage A finds
    no feasible box."""
    Q = np.diag(Q) if np.ndim(Q) == 1 else np.asarray(Q)
    R = np.diag(R) if np.ndim(R) == 1 else np.asarray(R)
    emax, r_empc = input_bound_box(
        hull, M, f_virt6, np.asarray(k_omega, dtype=np.float64), omega_des, r, inertia,
        max_acceleration,
    )
    Minv = np.linalg.inv(M)
    Qu_tilde = Minv.T @ R @ Minv
    r_in = float(np.max(np.linalg.eigvalsh(Qu_tilde[0:3, 0:3])))
    empc = empc_ingredients(
        float(Q[0, 0]), float(Q[3, 3]), r_in, dt, time_scaling, r_empc / np.sqrt(3.0)
    )
    return emax, r_empc, empc, Qu_tilde


def quadratic_bound_blocks(A2, b2, c2: float, P_om):
    """(P9, p9, c): the per-axis value bound (A2, b2, c2) on each of the three
    (position, velocity) pairs, and the omega block P_om."""
    P9 = np.zeros((9, 9))
    p9 = np.zeros(9)
    for i in range(3):
        P9[i, i] = A2[0, 0]
        P9[i, 3 + i] = P9[3 + i, i] = A2[0, 1]
        P9[3 + i, 3 + i] = A2[1, 1]
        p9[i] = b2[0]
        p9[3 + i] = b2[1]
    P9[6:9, 6:9] = P_om
    return P9, p9, 3.0 * c2


def compute_terminal_ingredients(
    hull: Polytope,
    M: np.ndarray,
    f_virt6: np.ndarray,
    omega_des: np.ndarray,
    r: np.ndarray,
    mass: float,
    inertia: np.ndarray,
    dt: float,
    Q: np.ndarray,
    R: np.ndarray,
    k_omega: np.ndarray,
    max_acceleration: float = 0.0,
    time_scaling: float = 5.0,
    empc_horizon: int = 3,
    grid_step: float = 0.1,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> TerminalIngredients:
    """Full pipeline for one fault class; the value-function QPs run on
    `device` (default cuda) in `dtype`, the rest on the host.  Raises
    RuntimeError where stage A finds no feasible box."""
    Q = np.diag(Q) if np.ndim(Q) == 1 else np.asarray(Q)
    k_omega = np.asarray(k_omega, dtype=np.float64)
    emax, r_empc, empc, Qu_tilde = axis_empc(
        hull, M, f_virt6, omega_des, r, inertia, dt, Q, R, k_omega, max_acceleration,
        time_scaling,
    )
    pts, vals, r_prim = value_function_grid(empc, empc_horizon, grid_step=grid_step,
                                            device=device, dtype=dtype)
    feas = r_prim < FEASIBLE_R_PRIM
    A2, b2, c2 = fit_quadratic_upper_bound(pts[feas], vals[feas])

    # omega Lyapunov cost
    A_om = np.eye(3) - np.diag(k_omega) * dt
    Q_om = Q[6:9, 6:9] + 2.0 * np.linalg.norm(Qu_tilde) * np.diag(k_omega) ** 2
    P9, p9, c = quadratic_bound_blocks(A2, b2, c2, la.solve_discrete_lyapunov(A_om, Q_om))

    # Full polynomial cost: quadratic base + the cross_1 / cross_2 coupling
    # bounds, every term prefactored (`cross_term_tables`).
    term = assemble_terminal_poly(
        P9, p9, c,
        mass=mass,
        inertia=inertia,
        r=r,
        omega_des=omega_des,
        Q=Q,
        k_omega=k_omega,
        qu_tilde_abs=float(np.linalg.norm(Qu_tilde)),
        input_empc_max=r_empc,
        prefactor_all=True,
    )

    # Terminal set: per-axis eMPC domain rows + omega box.
    dom = empc.domain
    nC = dom.num_facets
    blocks = []
    for i in range(3):
        Ai = np.zeros((nC, 9))
        Ai[:, i] = dom.A[:, 0]
        Ai[:, 3 + i] = dom.A[:, 1]
        blocks.append((Ai, dom.b))
    om_rows = np.zeros((6, 9))
    om_rows[0, 6] = om_rows[2, 7] = om_rows[4, 8] = 1.0
    om_rows[1, 6] = om_rows[3, 7] = om_rows[5, 8] = -1.0
    om_b = np.repeat(emax, 2)
    A9 = np.vstack([b[0] for b in blocks] + [om_rows])
    b9 = np.concatenate([b[1] for b in blocks] + [om_b])

    return TerminalIngredients(
        P9=P9,
        p9=p9,
        c=c,
        term=term,
        term_set=Polytope(A9, b9),
        emax=emax,
        r_empc=r_empc,
        meta={
            "uimax": empc.uimax,
            "time_scaling": time_scaling,
            "empc_horizon": empc_horizon,
            "n_grid": int(feas.sum()),
        },
        grid=ValueGrid(empc, empc_horizon, pts, vals, r_prim),
    )


def save_terminal_ingredients(ti: TerminalIngredients, path: str | Path) -> None:
    np.savez(
        path,
        P9=ti.P9,
        p9=ti.p9,
        c=ti.c,
        poly_P=np.asarray(ti.term.P),
        poly_p=np.asarray(ti.term.p),
        poly_const=np.asarray(ti.term.c),
        poly_c=np.asarray(ti.term.poly_c),
        poly_pow=np.asarray(ti.term.poly_pow),
        sqrt_c=np.asarray(ti.term.sqrt_c),
        sqrt_pow=np.asarray(ti.term.sqrt_pow),
        app=np.asarray(ti.term.app),
        term_A=ti.term_set.A,
        term_b=ti.term_set.b,
        emax=ti.emax,
        r_empc=ti.r_empc,
        meta=json.dumps(ti.meta),
    )


def load_terminal_ingredients(path: str | Path) -> TerminalIngredients:
    z = np.load(path, allow_pickle=False)
    if "poly_P" in z:
        term = TerminalPoly(
            P=z["poly_P"], p=z["poly_p"], c=z["poly_const"],
            poly_c=z["poly_c"], poly_pow=z["poly_pow"],
            sqrt_c=z["sqrt_c"], sqrt_pow=z["sqrt_pow"], app=z["app"],
        )
    else:  # a first-format entry (quadratic only)
        term = quadratic_terminal(z["P9"], z["p9"], float(z["c"]))
    return TerminalIngredients(
        P9=z["P9"],
        p9=z["p9"],
        c=float(z["c"]),
        term=term,
        term_set=Polytope(z["term_A"], z["term_b"]),
        emax=z["emax"],
        r_empc=float(z["r_empc"]),
        meta=json.loads(str(z["meta"])),
    )


def cache_key(fault_pattern, tuning: dict, plant: dict | None = None) -> str:
    """Stable key for the per-fault-class cache.

    `plant` carries the physical identity (mass, inertia, dt, D, ...) so
    different vehicles with the same tuning never collide.  The JSON payload
    is the JAX package's exactly: sorted keys, `default=float`, `sqp_iters`
    left out, and tuning values as given (5 and 5.0 give different keys).
    """
    payload = json.dumps(
        {
            # cache format version (v3: fault-aware orbit selection)
            "v": 3,
            "faults": sorted((int(f.index), float(f.intensity)) for f in fault_pattern),
            "tuning": {k: tuning[k] for k in sorted(tuning) if k != "sqp_iters"},
            "plant": plant or {},
        },
        sort_keys=True,
        default=float,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def plant_fingerprint(params) -> dict:
    """Cache-key identity of a plant, from its leaves in their own dtype.

    `params` is a `BodyParams` of tensors (any device) or of numpy arrays.
    Each leaf is read back as a numpy array of its own dtype, so a float32
    plant fingerprints as the JAX package's float32 plant does (mass
    16.799999237060547, and `round(12)` done in float32).
    """
    from ft_mpc_torch.ops.dynamics import host_array

    return {
        "mass": float(host_array(params.mass)),
        "inertia": host_array(params.inertia).round(12).tolist(),
        "dt": float(host_array(params.dt)),
        "max_thrust": float(host_array(params.max_thrust)),
        "D": host_array(params.D).round(12).tolist(),
    }


def main(argv=None) -> None:
    """CLI: the terminal ingredients of the run configuration's fault pattern
    (its faults at t=0) at the default orbit, written to
    `PORT_TERMINAL_CACHE/terminal_<key>.npz` unless --out says otherwise."""
    import argparse

    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiral_params import SpiralParameters
    from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope
    from ft_mpc_torch.ops.dynamics import BodyParams, host_array
    from ft_mpc_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description="offline terminal-ingredient pipeline")
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="device of the value-function QPs "
                    "(default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    tuning = {**DEFAULT_TUNING, **cfg.tuning}
    params = BodyParams.default(cfg.time_step, dtype=torch.float32, device=device)
    D = host_array(params.D)
    max_thrust = float(host_array(params.max_thrust))
    mass = float(host_array(params.mass))
    inertia = host_array(params.inertia)
    ff = np.zeros(16)
    for f in cfg.faults:
        if f.start_time == 0:
            ff[f.index] = f.intensity * max_thrust
    broken = (ff > 0).astype(float)
    sp = SpiralParameters.compute(mass, inertia, D @ ff)
    hull = attainable_wrench_polytope(D, max_thrust, broken, ff / 3.4)

    ti = compute_terminal_ingredients(
        hull=hull,
        M=sp.M,
        f_virt6=np.concatenate([sp.f_virt, np.zeros(3)]),
        omega_des=sp.omega_des,
        r=sp.r,
        mass=mass,
        inertia=inertia,
        dt=cfg.time_step,
        Q=np.asarray(tuning["Q"], dtype=np.float64),
        R=np.asarray(tuning["R"], dtype=np.float64),
        k_omega=tuning["k_omega"],
        max_acceleration=float(tuning.get("max_acceleration", 0.0)),
        time_scaling=float(tuning.get("time_scaling", 5)),
        empc_horizon=int(tuning.get("empc_horizon", 3)),
        device=device,
        dtype=torch.float32,
    )
    if args.out:
        out = Path(args.out)
    else:
        key = cache_key(cfg.faults, tuning, plant_fingerprint(params))
        out = PORT_TERMINAL_CACHE / f"terminal_{key}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    save_terminal_ingredients(ti, out)
    print(f"terminal ingredients written to {out}")
    print(f"  emax={ti.emax}, r_empc={ti.r_empc:.4f}")
    print(f"  P9 diag: {np.round(np.diag(ti.P9), 3)}")


if __name__ == "__main__":
    main()
