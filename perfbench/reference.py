"""Plain reference of the fault-scenario control step, to judge the program by.

It works out again, from the fault patterns, the plant, the tuning and the
committed terminal cache (a raw file that the program reads too), what the
program's set-up derives: each row's attainable-wrench hull, generators,
orbit parameters, compensation wrench and terminal terms.  Then it computes
one bank-wide control step as the configuration defines it:
  * the RK4 orbit-centre dynamics linearized along the warm trajectory
    (`torch.func` forward-mode jacobians);
  * condensed backend: the prediction matrices by the plain recursion, the
    dense QP with the polynomial terminal cost and the elastic terminal set
    (and after it, where the configuration states them, the state box's and
    the wrench rate's rows),
    the inverse ADMM metric by Newton-Schulz from the carried one (the
    whole bank refactored exactly when any row's spectral test fails), the
    over-relaxed ADMM with the rho rule, a 3-candidate merit line search;
  * stagewise backend: the banded QP, a Riccati factorization a phase, and
    each ADMM x-update an LQR re-solve computed by doubling scans over the
    horizon (not the program's sequential sweeps);
  * the worst-K cleanup (the rows it re-solved are reported as
    `info.cleaned`), the wrench un-rotation, the thruster allocation (hull
    test, FISTA projection, ADMM, min-norm polish, fallback).

Everything runs in the dtype of the tensors it is given (float64 to judge;
float32, each product's operands rounded to TF32, for the control).
Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import json
from itertools import combinations
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.plant import _cross, _mv, quat_rate, rot_matrix, thruster_matrix

N_X, N_U, N_OPT, N_T = 13, 6, 9, 16
BIG = 1e8
_MAX_POW = 8

# ---------------------------------------------------------------------------
# the bank, worked out again on the host (numpy float64)
# ---------------------------------------------------------------------------


def plant_constants(plant_cfg: dict) -> dict:
    """The plant as the configuration states it, each constant rounded to its
    stated dtype (the deployment's float32), held as float64 numpy."""
    f = np.float32 if plant_cfg["dtype"] == "float32" else np.float64
    r = lambda a: np.asarray(np.asarray(a, dtype=f), dtype=np.float64)
    inertia = np.diag(plant_cfg["inertia_diag"])
    return {"mass": r(plant_cfg["mass"]), "inertia": r(inertia),
            "inertia_inv": r(np.linalg.inv(inertia)), "max_thrust": r(plant_cfg["max_thrust"]),
            "D": r(thruster_matrix(*plant_cfg["thruster_arms"])), "dt": r(plant_cfg["dt"]),
            "fdtype": f}


def cache_key(pattern, tuning: dict, plant: dict) -> str:
    """The terminal cache's entry name for a fault pattern (broken thrusters
    at intensity 1), the tuning and the plant's float32 fingerprint."""
    f = plant["fdtype"]
    fp = {"mass": float(f(plant["mass"])),
          "inertia": np.asarray(plant["inertia"], dtype=f).round(12).tolist(),
          "dt": float(f(plant["dt"])), "max_thrust": float(f(plant["max_thrust"])),
          "D": np.asarray(plant["D"], dtype=f).round(12).tolist()}
    payload = json.dumps({"v": 3, "faults": sorted((int(i), 1.0) for i in pattern),
                          "tuning": {k: tuning[k] for k in sorted(tuning) if k != "sqp_iters"},
                          "plant": fp}, sort_keys=True, default=float)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def zonotope_facets(center: np.ndarray, gens: np.ndarray, tol: float = 1e-9):
    """Unit-norm halfspaces (A, b) of center + sum_i [0, 1] gens[:, i] in R^d:
    every facet normal is orthogonal to d - 1 distinct generator directions."""
    d = center.shape[0]
    dirs = []
    for v in gens.T:
        n = np.linalg.norm(v)
        if n <= tol:
            continue
        v = v / n
        v = v if v[np.argmax(np.abs(v) > tol)] > 0 else -v
        if not any(np.linalg.norm(v - w) < tol for w in dirs):
            dirs.append(v)
    dirs = np.array(dirs)
    normals = []
    for sub in combinations(range(len(dirs)), d - 1):
        _, sv, vt = np.linalg.svd(dirs[list(sub)])
        if sv[-1] > 1e-8 * max(1.0, sv[0]):
            n = vt[-1]
            normals.append(n * np.sign(n[np.argmax(np.abs(n) > tol)]))
    N = np.unique(np.round(np.array(normals), 10), axis=0)
    N = np.vstack([N, -N])
    b = N @ center + np.maximum(N @ gens, 0.0).sum(axis=1)
    norms = np.linalg.norm(N, axis=1)
    return N / norms[:, None], b / norms


def _pad(a: np.ndarray, rows: int, fill: float):
    out = np.full((rows,) + a.shape[1:], fill, dtype=np.float64)
    out[: len(a)] = a
    mask = np.zeros(rows)
    mask[: len(a)] = 1.0
    return out, mask


def bank_row(plant: dict, pattern, tuning: dict, cache_dir: Path, F: int, T: int) -> dict:
    """One fault pattern's row: fault wrench, hull, orbit, generators and the
    terminal terms of its committed cache entry."""
    D, mt = plant["D"], float(plant["max_thrust"])
    broken = np.zeros(N_T)
    broken[list(pattern)] = 1.0
    ff = broken * mt
    ffg = D @ ff
    hA, hb = zonotope_facets(ffg, D[:, broken < 0.5] * mt)
    hull_A, hull_mask = _pad(hA, F, 0.0)
    hull_b, _ = _pad(hb, F, 1.0)
    z = np.load(cache_dir / f"{cache_key(pattern, tuning, plant)}.npz", allow_pickle=False)
    orbit = json.loads(str(z["meta"])).get("orbit") or {}
    omega = np.asarray(orbit.get("omega_des", (0.0, 0.0, 0.6)), dtype=np.float64)
    r_dir = np.asarray(orbit.get("r_dir", (0.0, 1.0, 0.0)), dtype=np.float64)
    f_virt = float(orbit.get("f_virt_mag", 3.5)) * r_dir
    r = np.linalg.norm(f_virt) / (float(plant["mass"]) * np.linalg.norm(omega) ** 2) * r_dir
    gen_G = D * mt * (broken < 0.5)[None, :]
    if "poly_P" in z:
        term = {k: np.asarray(z[s], dtype=np.float64) for k, s in (
            ("P", "poly_P"), ("p", "poly_p"), ("c", "poly_const"), ("poly_c", "poly_c"),
            ("poly_pow", "poly_pow"), ("sqrt_c", "sqrt_c"), ("sqrt_pow", "sqrt_pow"),
            ("app", "app"))}
    else:
        term = {"P": z["P9"], "p": z["p9"], "c": np.asarray(float(z["c"])),
                "poly_c": np.zeros(8), "poly_pow": np.zeros((8, 3)), "sqrt_c": np.zeros(12),
                "sqrt_pow": np.zeros((12, 3)), "app": np.asarray(1e-6)}
    term_A, term_mask = _pad(np.asarray(z["term_A"], dtype=np.float64), T, 0.0)
    term_b, _ = _pad(np.asarray(z["term_b"], dtype=np.float64), T, 1.0)
    return dict(
        broken=broken, fault_force=ff, ffg=ffg, u_ub=np.where(broken > 0.5, 0.0, mt),
        hull_A=hull_A, hull_b=hull_b, hull_mask=hull_mask, omega_des=omega, r=r,
        u_comp=np.concatenate([f_virt, np.zeros(3)]) - ffg, beta=np.array([0.0, 0.0, 0.0, 1.0]),
        gen_G=gen_G, gen_c=ffg, gen_L=np.asarray(max(np.linalg.norm(gen_G, 2) ** 2, 1e-9)),
        term_A=term_A, term_b=term_b, term_mask=term_mask,
        **{"t_" + k: np.asarray(v, dtype=np.float64) for k, v in term.items()})


def build_bank(plant: dict, patterns, rows, tuning: dict, cache_dir: Path, F: int, T: int,
               device, dtype) -> SimpleNamespace:
    """The bank of rows[i] = index into patterns, as tensors (B, ...)."""
    built = [bank_row(plant, p, tuning, cache_dir, F, T) for p in patterns]
    idx = np.asarray(rows)
    return SimpleNamespace(**{k: torch.as_tensor(np.stack([b[k] for b in built])[idx],
                                                 dtype=dtype, device=device)
                              for k in built[0]})


def plant_tensors(plant: dict, device, dtype) -> dict:
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in plant.items() if k != "fdtype"}


def take(bank: SimpleNamespace, idx) -> SimpleNamespace:
    return SimpleNamespace(**{k: v[idx] for k, v in vars(bank).items()})


# ---------------------------------------------------------------------------
# dynamics
# ---------------------------------------------------------------------------


def rot_full(q):
    """6x6 [[R, 0], [0, I]] acting on a generalized force."""
    R = rot_matrix(q)
    Z = torch.zeros_like(R)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return torch.cat([torch.cat([R, Z], -1), torch.cat([Z, eye], -1)], -2)


def center_rates(pl, ffg, r, c, u_gen):
    """[pos_c, vel_c, omega, quat] rates of the orbit centre."""
    om, q = c[..., 6:9], c[..., 9:13]
    gf = u_gen + ffg
    dom = _mv(pl["inertia_inv"], gf[..., 3:] - _cross(om, _mv(pl["inertia"], om)))
    dvel = _mv(rot_matrix(q).transpose(-1, -2),
               gf[..., :3] / pl["mass"] + _cross(dom, r) + _cross(om, _cross(om, r)))
    return torch.cat([c[..., 3:6], dvel, dom, quat_rate(q, om)], dim=-1)


def center_step(pl, ffg, r, c, u):
    f = lambda s: center_rates(pl, ffg, r, s, u)
    dt = pl["dt"]
    k1 = f(c)
    k2 = f(c + dt / 2 * k1)
    k3 = f(c + dt / 2 * k2)
    k4 = f(c + dt * k3)
    return c + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def robot_to_center(r, x):
    q, om = x[..., 6:10], x[..., 10:13]
    Rt = rot_matrix(q).transpose(-1, -2)
    return torch.cat([x[..., :3] + _mv(Rt, r), x[..., 3:6] + _mv(Rt, _cross(om, r)), om, q], -1)


def stage(pl, ffg, r, u_comp, x, u, u_ref_t):
    """A stage of the centre dynamics under deviation input u: the total
    wrench is u + rot(x)^T u_ref + u_comp."""
    u_r = _mv(rot_full(x[..., 9:13]).transpose(-1, -2), u_ref_t)
    return center_step(pl, ffg, r, x, u + u_r + u_comp)


def linearize(pl, bank, X, U, u_ref):
    """A (B, Nt, 13, 13), B (B, Nt, 13, 6), defects (B, Nt, 13) along (X, U)."""
    B, Nt = U.shape[:2]
    rows = torch.arange(B, device=X.device).repeat_interleave(Nt)

    def f(ffg, r, uc, x, u, ur):
        out = stage(pl, ffg, r, uc, x, u, ur)
        return out, out

    jac = torch.func.jacfwd(f, argnums=(3, 4), has_aux=True)
    (A, Bm), fv = torch.func.vmap(jac)(bank.ffg[rows], bank.r[rows], bank.u_comp[rows],
                                       X[:, :-1].reshape(-1, N_X), U.reshape(-1, N_U),
                                       u_ref[:Nt].repeat(B, 1))
    return (A.reshape(B, Nt, N_X, N_X), Bm.reshape(B, Nt, N_X, N_U),
            fv.reshape(B, Nt, N_X) - X[:, 1:])


def condense(A, Bm, d):
    """Prediction matrices: delta x_{t+1} = S_t dU + phi_t."""
    B, Nt = A.shape[:2]
    S = A.new_zeros(B, N_X, Nt * N_U)
    phi = A.new_zeros(B, N_X)
    Ss, phis = [], []
    for t in range(Nt):
        S = A[:, t] @ S
        S[:, :, N_U * t: N_U * (t + 1)] += Bm[:, t]
        phi = _mv(A[:, t], phi) + d[:, t]
        Ss.append(S)
        phis.append(phi)
    return torch.stack(Ss, 1), torch.stack(phis, 1)


# ---------------------------------------------------------------------------
# terminal cost V(e) = e'Pe + p'e + c + polynomial and quartic-root terms
# ---------------------------------------------------------------------------


def _monomials(pows, eo):
    acc, cols = torch.ones_like(eo), []
    for _ in range(_MAX_POW + 1):
        cols.append(acc)
        acc = acc * eo
    tab = torch.stack(cols, dim=-1)  # (3, P+1)
    grid = torch.arange(_MAX_POW + 1, device=eo.device)
    onehot = (pows.round().long()[..., None] == grid).to(eo.dtype)
    f = (onehot * tab).sum(-1)
    return f[:, 0] * f[:, 1] * f[:, 2]


def _extra(tab, eo):
    poly_c, poly_pow, sqrt_c, sqrt_pow, app = tab
    return (poly_c * _monomials(poly_pow, eo)).sum() + \
        (sqrt_c * (_monomials(sqrt_pow, eo) + app) ** 0.25).sum()


def _tables(bank, idx=None):
    t = (bank.t_poly_c, bank.t_poly_pow, bank.t_sqrt_c, bank.t_sqrt_pow, bank.t_app)
    return t if idx is None else tuple(x[idx] for x in t)


def terminal_value(bank, e, idx=None):
    """V at errors e (N, 9); bank rows idx (default: row i for e[i])."""
    sel = (lambda x: x) if idx is None else (lambda x: x[idx])
    P, p, c = sel(bank.t_P), sel(bank.t_p), sel(bank.t_c)
    quad = torch.einsum("ni,nij,nj->n", e, P, e) + (p * e).sum(-1) + c
    return quad + torch.func.vmap(_extra)(_tables(bank, idx), e[:, 6:9])


def terminal_grad(bank, e):
    g = 2.0 * _mv(bank.t_P, e) + bank.t_p
    g_eo = torch.func.vmap(torch.func.grad(_extra, argnums=1))(_tables(bank), e[:, 6:9])
    return torch.cat([g[:, :6], g[:, 6:] + g_eo], dim=1)


def terminal_hessian_psd(bank, e):
    """d2V/de2 with the omega block's non-quadratic part shifted to be PSD."""
    H = 2.0 * bank.t_P
    He = torch.func.vmap(torch.func.hessian(_extra, argnums=1))(_tables(bank), e[:, 6:9])
    He = 0.5 * (He + He.transpose(-1, -2))
    shift = torch.clamp(-torch.linalg.eigvalsh(He)[:, 0], min=0.0)
    He = He + shift[:, None, None] * torch.eye(3, dtype=e.dtype, device=e.device)
    H = H.clone()
    H[:, 6:, 6:] += He
    return H


# ---------------------------------------------------------------------------
# the condensed QP and its ADMM
# ---------------------------------------------------------------------------


def geometry(bank):
    hA = bank.hull_A * bank.hull_mask[..., None]
    hb = torch.where(bank.hull_mask > 0.5, bank.hull_b, BIG)
    tA = bank.term_A * bank.term_mask[..., None]
    tb = torch.where(bank.term_mask > 0.5, bank.term_b, BIG)
    return hA, hb, tA, tb


def stage_offset(bank, X, U, u_ref):
    Nt = U.shape[1]
    u_r = _mv(rot_full(X[:, :-1, 9:13]).transpose(-1, -2), u_ref[:Nt])
    return U + u_r + bank.u_comp[:, None] + bank.ffg[:, None]


def has_box(W) -> bool:
    return W.x_lb is not None or W.x_ub is not None


def n_extra(W, Nt: int) -> int:
    """The rows that `ext_rows` adds."""
    return 2 * (Nt - 1) * (N_X * has_box(W) + N_U * (W.du_max is not None))


def box(W, like):
    """The state box's two sides; a side the configuration leaves out is at
    BIG, so that a one-sided box still builds both sides' rows."""
    big = torch.full((N_X,), BIG, dtype=like.dtype, device=like.device)
    return (-big if W.x_lb is None else W.x_lb), (big if W.x_ub is None else W.x_ub)


def ext_rows(W, X, S, phi, offset):
    """The rows that follow the terminal rows, (G (B, E, n), h (B, E)),
    unrelaxed: the state box on every state of stages 1..Nt-1,
    +/- S_t dU <= +/-(bound - X_t - phi_t), then the wrench rate,
    +/-(dU_t - dU_{t-1}) <= du_max -/+ (offset_t - offset_{t-1})."""
    B, Nt, _, n = S.shape
    G, h = [], []
    if has_box(W):
        lb, ub = box(W, X)
        Sb = S[:, :-1].reshape(B, (Nt - 1) * N_X, n)
        x = X[:, 1:-1] + phi[:, :-1]
        G += [Sb, -Sb]
        h += [(ub - x).reshape(B, -1), (x - lb).reshape(B, -1)]
    if W.du_max is not None:
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        diff = (eye[N_U:] - eye[:-N_U]).expand(B, n - N_U, n)  # row (t, j): dU_{t+1,j} - dU_{t,j}
        dw = (offset[:, 1:] - offset[:, :-1]).reshape(B, -1)
        dmax = W.du_max.repeat(Nt - 1)
        G += [diff, -diff]
        h += [dmax - dw, dmax + dw]
    return torch.cat(G, 1), torch.cat(h, 1)


def assemble_condensed(pl, bank, W, cfg, X, U, x_ref, u_ref, geo):
    hA, hb, tA, tb = geo
    B, Nt = U.shape[:2]
    n = Nt * N_U
    A, Bm, d = linearize(pl, bank, X, U, u_ref)
    offset = stage_offset(bank, X, U, u_ref)
    h_hull = hb[:, None] - torch.einsum("bti,bfi->btf", offset, hA)
    S, phi = condense(A, Bm, d)
    S9 = S[:, :, :N_OPT]
    e0 = X[:, 1:, :N_OPT] + phi[:, :, :N_OPT] - x_ref[:, 1:]
    HV = terminal_hessian_psd(bank, e0[:, -1])
    gV = terminal_grad(bank, e0[:, -1])
    R_blk = torch.kron(torch.eye(Nt, dtype=X.dtype, device=X.device), W.R)
    H = 2.0 * (torch.einsum("btin,ij,btjm->bnm", S9[:, :-1], W.Q, S9[:, :-1])
               + 0.5 * torch.einsum("bin,bij,bjm->bnm", S9[:, -1], HV, S9[:, -1]) + R_blk
               + cfg.prox * torch.eye(n, dtype=X.dtype, device=X.device))
    g = 2.0 * (torch.einsum("btin,ij,btj->bn", S9[:, :-1], W.Q, e0[:, :-1])
               + U.reshape(B, -1) @ R_blk) + torch.einsum("bin,bi->bn", S9[:, -1], gV)
    G_term = torch.einsum("bti,bin->btn", tA, S9[:, -1])
    h_term = tb - torch.einsum("bti,bi->bt", tA, e0[:, -1])
    if n_extra(W, Nt) > 0:
        G_ext, h_ext = ext_rows(W, X, S, phi, offset)
        G_term, h_term = torch.cat([G_term, G_ext], 1), torch.cat([h_term, h_ext], 1)
    h_term = torch.maximum(h_term, cfg.term_relax * h_term)
    qp = SimpleNamespace(H=H, g=g, hull_A=hA, h_hull=h_hull, G_term=G_term, h_term=h_term)
    return qp, S, phi, d


def metric(qp, rho, sigma):
    """K = H + sigma I + rho (I kron Ah'Ah + Gt'Gt), and the rho-free part."""
    B, n = qp.g.shape
    Nt = qp.h_hull.shape[1]
    AA = torch.einsum("bfi,bfj->bij", qp.hull_A, qp.hull_A)
    blk = torch.einsum("st,bij->bsitj", torch.eye(Nt, dtype=AA.dtype, device=AA.device),
                       AA).reshape(B, n, n)
    M = blk + torch.einsum("bti,btj->bij", qp.G_term, qp.G_term)
    eye = torch.eye(n, dtype=AA.dtype, device=AA.device)
    return lambda r: qp.H + sigma * eye + r[:, None, None] * M


def exact_inverse(K):
    L, info = torch.linalg.cholesky_ex(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    return torch.where((info != 0)[:, None, None], torch.nan, torch.cholesky_solve(eye, L))


def newton_inverse(K, X0, iters):
    """K^-1 by `iters` symmetric Newton-Schulz steps from X0 after a rescale;
    the whole bank refactored exactly if any row's 3-step power estimate of
    the residual's spectral radius is beyond what `iters` steps contract."""
    B, n, _ = K.shape
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    Y = K @ X0
    s = (torch.diagonal(Y, dim1=-2, dim2=-1).sum(-1)
         / torch.clamp((Y * Y).sum((-2, -1)), min=1e-30))[:, None, None]
    Rm = s * Y - eye
    v = torch.sin(1.0 + torch.arange(n, dtype=K.dtype, device=K.device))[None, :, None]
    v = v.expand(B, n, 1) / float(np.sqrt(n))
    for _ in range(3):
        v = Rm @ v
        v = v / (torch.linalg.vector_norm(v, dim=-2, keepdim=True) + 1e-30)
    res = torch.linalg.vector_norm((Rm @ v)[..., 0], dim=-1)
    if bool(((res >= 0.01 ** (1.0 / 2 ** iters)) | ~torch.isfinite(res)).any()):
        return exact_inverse(K), True
    X, Yl = s * X0, s * Y
    for i in range(iters):
        X = 2.0 * X - X @ Yl
        X = 0.5 * (X + X.transpose(-1, -2))
        if i < iters - 1:
            Yl = K @ X
    return X, False


def admm(Kinv, qp, x, zh, zt, yh, yt, rho, a, iters):
    """`iters` over-relaxed ADMM iterations with a fixed metric inverse."""
    B, n = qp.g.shape
    Nt = qp.h_hull.shape[1]
    r2, r3 = rho[:, None], rho[:, None, None]
    ym = a.elastic_y_max
    for _ in range(iters):
        rhs = a.sigma * x - qp.g \
            + torch.einsum("btf,bfj->btj", r3 * zh - yh, qp.hull_A).reshape(B, n) \
            + torch.einsum("brn,br->bn", qp.G_term, r2 * zt - yt)
        xt = torch.einsum("bij,bj->bi", Kinv, rhs)
        x = a.alpha * xt + (1 - a.alpha) * x
        zh_hat = a.alpha * torch.einsum("btj,bfj->btf", xt.reshape(B, Nt, N_U), qp.hull_A) \
            + (1 - a.alpha) * zh
        zt_hat = a.alpha * torch.einsum("brn,bn->br", qp.G_term, xt) + (1 - a.alpha) * zt
        zh_new = torch.minimum(zh_hat + yh / r3, qp.h_hull)
        vt = zt_hat + yt / r2
        if ym > 0:
            zt_new = torch.where(vt > qp.h_term + ym / r2, vt - ym / r2,
                                 torch.minimum(vt, qp.h_term))
        else:
            zt_new = torch.minimum(vt, qp.h_term)
        yh = yh + r3 * (zh_hat - zh_new)
        yt = yt + r2 * (zt_hat - zt_new)
        if ym > 0:
            yt = torch.clamp(yt, 0.0, ym)
        zh, zt = zh_new, zt_new
    return x, zh, zt, yh, yt


def adapt_rho(rho, r_prim, r_dual, prim_scale, dual_scale, clip, lo, hi):
    ratio = (r_prim / torch.clamp(prim_scale, min=1e-6)) / torch.clamp(
        r_dual / torch.clamp(dual_scale, min=1e-6), min=1e-12)
    f = torch.clamp(torch.sqrt(ratio), 1.0 / clip, clip)
    f = torch.where(r_prim <= 1e-4, torch.ones_like(f), f)
    return torch.clamp(rho * f, lo, hi)


def solve_condensed(qp, a, yh, yt, rho0, kinv0, newton_iters):
    """The phase loop: metric inverse, ADMM, residuals, rho rule, refactor."""
    B, n = qp.g.shape
    Nt = qp.h_hull.shape[1]
    rho = torch.clamp(rho0, a.rho_min, a.rho_max)
    K_of = metric(qp, rho, a.sigma)
    rescued = False
    if kinv0 is None:
        kinv = exact_inverse(K_of(rho))
    else:
        kinv, rescued = newton_inverse(K_of(rho), kinv0, newton_iters)
    x = torch.zeros_like(qp.g)
    zh, zt = torch.clamp(qp.h_hull, max=0.0), torch.clamp(qp.h_term, max=0.0)
    ym = a.elastic_y_max
    for _ in range(a.phases):
        x, zh, zt, yh, yt = admm(kinv, qp, x, zh, zt, yh, yt, rho, a, a.iters)
        Gh = torch.einsum("btj,bfj->btf", x.reshape(B, Nt, N_U), qp.hull_A)
        Gt = torch.einsum("btn,bn->bt", qp.G_term, x)
        if ym > 0:
            term_gap = torch.where(yt >= 0.999 * ym, torch.clamp(Gt - qp.h_term, min=0.0),
                                   0.0).amax(1)
        else:
            term_gap = torch.zeros_like(rho)
        r_prim = torch.maximum((Gh - zh).abs().amax((1, 2)), (Gt - zt).abs().amax(1))
        Hx = torch.einsum("bij,bj->bi", qp.H, x)
        r_dual = (Hx + qp.g + torch.einsum("btf,bfj->btj", yh, qp.hull_A).reshape(B, n)
                  + torch.einsum("btn,bt->bn", qp.G_term, yt)).abs().amax(1)
        rho_new = adapt_rho(rho, r_prim, r_dual,
                            torch.maximum(Gh.abs().amax((1, 2)), zh.abs().amax((1, 2))),
                            torch.maximum(Hx.abs().amax(1), qp.g.abs().amax(1)),
                            a.adapt_clip, a.rho_min, a.rho_max)
        if a.phases > 1:
            if kinv0 is None:
                kinv = exact_inverse(K_of(rho_new))
            else:
                kinv, r = newton_inverse(K_of(rho_new), kinv, max(newton_iters, 2))
                rescued = rescued or r
        rho = rho_new
    return SimpleNamespace(x=x, y_hull=yh, y_term=yt, r_prim=r_prim, r_dual=r_dual, rho=rho,
                           kinv=kinv, term_gap=term_gap, rescued=rescued)


def merit_alpha(pl, bank, W, cfg, X, U, dX, dU, x_ref, u_ref, geo):
    """The candidate step length of least l1 merit, per row."""
    hA, hb, tA, tb = geo
    B, Nt = U.shape[:2]
    al = torch.tensor(cfg.ls_alphas, dtype=X.dtype, device=X.device)
    nA = al.shape[0]
    a = al[:, None, None, None]
    Uc = U + a * dU
    Xc = torch.cat([X[:, :1].expand(nA, B, 1, N_X), X[:, 1:] + a * dX], dim=2)
    rows = torch.arange(B, device=X.device).repeat_interleave(Nt).repeat(nA)
    fc = stage(pl, bank.ffg[rows], bank.r[rows], bank.u_comp[rows],
               Xc[:, :, :-1].reshape(-1, N_X), Uc.reshape(-1, N_U),
               u_ref[:Nt].repeat(nA * B, 1)).reshape(nA, B, Nt, N_X)
    e_run = Xc[:, :, 1:-1, :N_OPT] - x_ref[:, 1:-1]
    e_N = Xc[:, :, -1, :N_OPT] - x_ref[:, -1]
    J = (torch.einsum("abti,ij,abtj->ab", e_run, W.Q, e_run)
         + torch.einsum("abti,ij,abtj->ab", Uc, W.R, Uc)
         + terminal_value(bank, e_N.reshape(-1, N_OPT),
                          torch.arange(B, device=X.device).repeat(nA)).reshape(nA, B))
    u_r = _mv(rot_full(Xc[:, :, :-1, 9:13]).transpose(-1, -2), u_ref[:Nt])
    w = Uc + u_r + bank.u_comp[:, None] + bank.ffg[:, None]
    viol = ((fc - Xc[:, :, 1:]).abs().sum((2, 3))
            + torch.clamp(torch.einsum("abti,bfi->abtf", w, hA) - hb[:, None], min=0).sum((2, 3))
            + torch.clamp(torch.einsum("bti,abi->abt", tA, e_N) - tb, min=0).sum(2))
    if has_box(W):
        lb, ub = box(W, X)
        xs = Xc[:, :, 1:-1]
        viol = viol + torch.clamp(xs - ub, min=0).sum((2, 3))
        viol = viol + torch.clamp(lb - xs, min=0).sum((2, 3))
    if W.du_max is not None:
        dw = w[:, :, 1:] - w[:, :, :-1]
        viol = viol + torch.clamp(dw.abs() - W.du_max, min=0).sum((2, 3))
    m = J + cfg.ls_penalty * viol
    m = torch.where(torch.isfinite(m), m, torch.inf)
    return al[torch.argmin(m, dim=0)]


def per_row_ref(bank, x_ref):
    B = bank.r.shape[0]
    xr = x_ref.expand(B, *x_ref.shape)
    return torch.cat([xr[..., :6], bank.omega_des[:, None].expand(B, x_ref.shape[0], 3)], -1)


def sqp_condensed(pl, bank, W, cfg, c0, x_ref, u_ref, warm):
    B, Nt = warm.U.shape[:2]
    x_ref = per_row_ref(bank, x_ref)
    geo = geometry(bank)
    X = torch.cat([c0[:, None], warm.X[:, 1:]], 1)
    U, yh, yt, rho, kinv = warm.U, warm.y_hull, warm.y_term, warm.rho, warm.kinv
    rescues = 0
    for _ in range(cfg.sqp_iters):
        qp, S, phi, d = assemble_condensed(pl, bank, W, cfg, X, U, x_ref, u_ref, geo)
        sol = solve_condensed(qp, cfg.admm, yh, yt, rho, kinv, cfg.newton_iters)
        rescues += int(sol.rescued)
        dU = sol.x.reshape(B, Nt, N_U)
        dX = torch.einsum("btin,bn->bti", S, sol.x) + phi
        al = merit_alpha(pl, bank, W, cfg, X, U, dX, dU, x_ref, u_ref, geo)
        U = U + al[:, None, None] * dU
        X = torch.cat([X[:, :1], X[:, 1:] + al[:, None, None] * dX], 1)
        info = SimpleNamespace(r_prim=sol.r_prim, r_dual=sol.r_dual, term_gap=sol.term_gap,
                               defect=d.abs().amax((1, 2)), du=al * sol.x.abs().amax(1))
        yh, yt, rho, kinv = sol.y_hull, sol.y_term, sol.rho, sol.kinv
    K = min(cfg.cleanup_k, B) if cfg.cleanup_iters > 0 else 0
    cleaned = torch.zeros(B, dtype=torch.bool, device=c0.device)
    for _ in range(cfg.cleanup_rounds if K > 0 else 0):
        _, idx = torch.topk(info.r_prim + info.du + info.defect, K)
        cleaned[idx] = True
        bs = take(bank, idx)
        geo_s = tuple(t[idx] for t in geo)
        Xs, Us = X[idx], U[idx]
        qp, S, phi, d = assemble_condensed(pl, bs, W, cfg, Xs, Us, x_ref[idx], u_ref, geo_s)
        a = SimpleNamespace(**{**vars(cfg.admm), "iters": cfg.cleanup_iters,
                               "phases": cfg.cleanup_phases, "adapt_clip": 5.0})
        sol = solve_condensed(qp, a, yh[idx], yt[idx], rho[idx], None, cfg.newton_iters)
        dU = sol.x.reshape(K, Nt, N_U)
        dX = torch.einsum("btin,bn->bti", S, sol.x) + phi
        al = merit_alpha(pl, bs, W, cfg, Xs, Us, dX, dU, x_ref[idx], u_ref, geo_s)
        X, U = X.clone(), U.clone()
        X[idx] = torch.cat([Xs[:, :1], Xs[:, 1:] + al[:, None, None] * dX], 1)
        U[idx] = Us + al[:, None, None] * dU
        yh, yt, rho, kinv = yh.clone(), yt.clone(), rho.clone(), kinv.clone()
        yh[idx], yt[idx], rho[idx], kinv[idx] = sol.y_hull, sol.y_term, sol.rho, sol.kinv
        for k, v in (("r_prim", sol.r_prim), ("r_dual", sol.r_dual), ("term_gap", sol.term_gap),
                     ("defect", d.abs().amax((1, 2))), ("du", al * sol.x.abs().amax(1))):
            t = getattr(info, k).clone()
            t[idx] = v
            setattr(info, k, t)
    warm = SimpleNamespace(X=X, U=U, y_hull=yh, y_term=yt, rho=rho, kinv=kinv)
    info.cleaned = cleaned
    return warm, info, rescues


# ---------------------------------------------------------------------------
# the stagewise QP: Riccati factorization a phase, re-solves by doubling scans
# ---------------------------------------------------------------------------


def lqr_factor(A, Bm, c, Q, R, QN):
    """Riccati sweep on the quadratic data: gains K, Quu^-1, F = A - BK, P c."""
    Nt = A.shape[1]
    P = QN
    Ks, Qis, PCs = [None] * Nt, [None] * Nt, [None] * Nt
    for t in reversed(range(Nt)):
        At, Bt = A[:, t], Bm[:, t]
        BtP = Bt.transpose(-1, -2) @ P
        Qi = torch.linalg.inv(R + BtP @ Bt)
        Qux = BtP @ At
        K = Qi @ Qux
        PCs[t] = _mv(P, c[:, t])
        Pn = Q + At.transpose(-1, -2) @ P @ At - Qux.transpose(-1, -2) @ K
        P = 0.5 * (Pn + Pn.transpose(-1, -2))
        Ks[t], Qis[t] = K, Qi
    K, Qi, PC = torch.stack(Ks, 1), torch.stack(Qis, 1), torch.stack(PCs, 1)
    F = A - Bm @ K
    return SimpleNamespace(B=Bm, c=c, K=K, Qi=Qi, F=F, PC=PC,
                           bwd=_doubling(F.transpose(-1, -2), reverse=True),
                           fwd=_doubling(F, reverse=False))


def _shift(x, d, reverse):
    """x moved by d along axis 1, zero-filled: x[t + d] (reverse) or x[t - d]."""
    z = torch.zeros_like(x[:, :d])
    return torch.cat([x[:, d:], z], 1) if reverse else torch.cat([z, x[:, :-d]], 1)


def _doubling(M, reverse):
    """The level matrices of a doubling scan over the affine recurrence
    v_t = M_t v_{t -/+ 1} + m_t, with one more element (the end value) whose
    matrix is 0: level k holds the product of 2^k consecutive matrices."""
    Mc = torch.cat([M, torch.zeros_like(M[:, :1])], 1) if reverse else \
        torch.cat([torch.zeros_like(M[:, :1]), M], 1)
    levels, d = [], 1
    while d < Mc.shape[1]:
        levels.append(Mc)
        Mc = Mc @ _shift(Mc, d, reverse)
        d *= 2
    return levels


def _scan(levels, v, reverse):
    d = 1
    for Mc in levels:
        v = v + _mv(Mc, _shift(v, d, reverse))
        d *= 2
    return v


def lqr_resolve(f, q, r, qN):
    """The LQR with the factorized quadratic data and new linear terms q
    (B, Nt, n), r (B, Nt, m), qN (B, n), from x0 = 0: (X, U)."""
    m = q + _mv(f.F.transpose(-1, -2), f.PC) - _mv(f.K.transpose(-1, -2), r)
    p = _scan(f.bwd, torch.cat([m, qN[:, None]], 1), reverse=True)  # p_0 .. p_N
    k = _mv(f.Qi, r + _mv(f.B.transpose(-1, -2), f.PC + p[:, 1:]))
    n = f.c - _mv(f.B, k)
    X = _scan(f.fwd, torch.cat([torch.zeros_like(n[:, :1]), n], 1), reverse=False)
    return X, -_mv(f.K, X[:, :-1]) - k


def assemble_stagewise(pl, bank, W, cfg, X, U, x_ref, u_ref, geo):
    hA, hb, tA, tb = geo
    A, Bm, d = linearize(pl, bank, X, U, u_ref)
    h_hull = hb[:, None] - torch.einsum("bti,bfi->btf", stage_offset(bank, X, U, u_ref), hA)
    e = X[:, :, :N_OPT] - x_ref
    gV = terminal_grad(bank, e[:, -1])
    HV = terminal_hessian_psd(bank, e[:, -1])
    pad = lambda t: torch.nn.functional.pad(t, (0, N_X - N_OPT))
    h_term = tb - torch.einsum("bti,bi->bt", tA, e[:, -1])
    return SimpleNamespace(
        A=A, B=Bm, c=d, gx=pad(torch.cat([e[:, :-1] @ W.Q, 0.5 * gV[:, None]], 1)),
        QN=torch.nn.functional.pad(0.5 * HV, (0, N_X - N_OPT, 0, N_X - N_OPT)),
        gu=U @ W.R, hull_A=hA, h_hull=h_hull, T=pad(tA),
        h_term=torch.maximum(h_term, cfg.term_relax * h_term)), d


def solve_stagewise(qp, W, s, yh, yt, rho0):
    """The stagewise ADMM: x-updates by LQR re-solves, the elastic terminal
    rows, the rho rule; a Riccati factorization a phase."""
    B, Nt = qp.B.shape[:2]
    kw = dict(dtype=qp.A.dtype, device=qp.A.device)
    Q13 = torch.zeros(N_X, N_X, **kw)
    Q13[:N_OPT, :N_OPT] = W.Q
    hA, T = qp.hull_A, qp.T
    AA, TT = hA.transpose(1, 2) @ hA, T.transpose(1, 2) @ T
    gu2, gx2 = 2.0 * qp.gu, 2.0 * qp.gx[:, 1:]
    dX = torch.zeros(B, Nt + 1, N_X, **kw)
    dU = torch.zeros(B, Nt, N_U, **kw)
    zh, zt = torch.clamp(qp.h_hull, max=0.0), torch.clamp(qp.h_term, max=0.0)
    rho = torch.clamp(rho0, s.rho_min, s.rho_max)
    ym = s.elastic_y_max
    eye_n, eye_m = torch.eye(N_X, **kw), torch.eye(N_U, **kw)
    for _ in range(s.phases):
        r2, r3 = rho[:, None], rho[:, None, None]
        f = lqr_factor(qp.A, qp.B, qp.c, (2.0 * Q13 + s.sigma * eye_n).expand(B, N_X, N_X),
                       2.0 * W.R + s.sigma * eye_m + r3 * AA,
                       2.0 * qp.QN + s.sigma * eye_n + r3 * TT)
        for _ in range(s.iters):
            q_lin = gx2 - s.sigma * dX[:, 1:]
            qN = q_lin[:, -1] - r2 * _mv(T.transpose(1, 2), zt - yt / r2)
            q = torch.cat([torch.zeros_like(q_lin[:, :1]), q_lin[:, :-1]], 1)
            Xt, Ut = lqr_resolve(f, q, gu2 - s.sigma * dU - r3 * ((zh - yh / r3) @ hA), qN)
            dX = s.alpha * Xt + (1 - s.alpha) * dX
            dU = s.alpha * Ut + (1 - s.alpha) * dU
            zh_hat = s.alpha * (Ut @ hA.transpose(1, 2)) + (1 - s.alpha) * zh
            zt_hat = s.alpha * _mv(T, Xt[:, -1]) + (1 - s.alpha) * zt
            zh_new = torch.minimum(zh_hat + yh / r3, qp.h_hull)
            vt = zt_hat + yt / r2
            if ym > 0:
                zt_new = torch.where(vt > qp.h_term + ym / r2, vt - ym / r2,
                                     torch.minimum(vt, qp.h_term))
            else:
                zt_new = torch.minimum(vt, qp.h_term)
            yh = yh + r3 * (zh_hat - zh_new)
            yt = yt + r2 * (zt_hat - zt_new)
            if ym > 0:
                yt = torch.clamp(yt, 0.0, ym)
            zh, zt = zh_new, zt_new
        Gh, Gt = dU @ hA.transpose(1, 2), _mv(T, dX[:, -1])
        if ym > 0:
            term_gap = torch.where(yt >= 0.999 * ym, torch.clamp(Gt - qp.h_term, min=0.0),
                                   0.0).amax(1)
        else:
            term_gap = torch.zeros_like(rho)
        r_prim = torch.maximum((Gh - zh).abs().amax((1, 2)), (Gt - zt).abs().amax(1))
        dR = 2.0 * (dU @ W.R)
        r_dual = (dR + gu2 + yh @ hA).abs().amax((1, 2))
        rho = adapt_rho(rho, r_prim, r_dual,
                        torch.maximum(Gh.abs().amax((1, 2)), zh.abs().amax((1, 2))),
                        dR.abs().amax((1, 2)), s.adapt_clip, s.rho_min, s.rho_max)
    return SimpleNamespace(dX=dX, dU=dU, y_hull=yh, y_term=yt, rho=rho, r_prim=r_prim,
                           r_dual=r_dual, term_gap=term_gap)


def _sqp_stagewise_core(pl, bank, W, cfg, s, sqp_iters, c0, x_ref, u_ref, warm):
    geo = geometry(bank)
    X = torch.cat([c0[:, None], warm.X[:, 1:]], 1)
    U, yh, yt, rho = warm.U, warm.y_hull, warm.y_term, warm.rho
    for _ in range(sqp_iters):
        qp, d = assemble_stagewise(pl, bank, W, cfg, X, U, x_ref, u_ref, geo)
        sol = solve_stagewise(qp, W, s, yh, yt, rho)
        dX, dU = sol.dX[:, 1:], sol.dU
        al = merit_alpha(pl, bank, W, cfg, X, U, dX, dU, x_ref, u_ref, geo)
        U = U + al[:, None, None] * dU
        X = torch.cat([X[:, :1], X[:, 1:] + al[:, None, None] * dX], 1)
        yh, yt, rho = sol.y_hull, sol.y_term, sol.rho
        info = SimpleNamespace(r_prim=sol.r_prim, r_dual=sol.r_dual, term_gap=sol.term_gap,
                               defect=d.abs().amax((1, 2)), du=al * dU.abs().amax((1, 2)))
    return SimpleNamespace(X=X, U=U, y_hull=yh, y_term=yt, rho=rho, kinv=None), info


def sqp_stagewise(pl, bank, W, cfg, c0, x_ref, u_ref, warm):
    B = c0.shape[0]
    xr = per_row_ref(bank, x_ref)
    warm, info = _sqp_stagewise_core(pl, bank, W, cfg, cfg.stagewise, cfg.sqp_iters, c0, xr,
                                     u_ref, warm)
    K = min(cfg.cleanup_k, B) if cfg.cleanup_iters > 0 else 0
    cleaned = torch.zeros(B, dtype=torch.bool, device=c0.device)
    for _ in range(cfg.cleanup_rounds if K > 0 else 0):
        _, idx = torch.topk(info.r_prim + info.du + info.defect, K)
        cleaned[idx] = True
        s = SimpleNamespace(**{**vars(cfg.stagewise), "iters": cfg.cleanup_iters,
                               "phases": cfg.cleanup_phases, "adapt_clip": 5.0})
        sub = SimpleNamespace(**{k: (None if v is None else v[idx])
                                 for k, v in vars(warm).items()})
        w_c, i_c = _sqp_stagewise_core(pl, take(bank, idx), W, cfg, s, 1, c0[idx], xr[idx],
                                       u_ref, sub)
        for k in ("X", "U", "y_hull", "y_term", "rho"):
            t = getattr(warm, k).clone()
            t[idx] = getattr(w_c, k)
            setattr(warm, k, t)
        for k in vars(info):
            t = getattr(info, k).clone()
            t[idx] = getattr(i_c, k)
            setattr(info, k, t)
    info.cleaned = cleaned
    return warm, info, 0


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------


def allocate(D, bank, w, al):
    """Thruster commands for wrench commands w (B, 6): the total wrench
    (command + stuck-on force) kept if the hull test passes, else projected
    onto the attainable zonotope by FISTA; min |u|^2 s.t. D u = w_des,
    0 <= u <= u_ub by ADMM; a min-norm equality polish over healthy
    thrusters; the FISTA point where ADMM fails to realize the wrench."""
    B = w.shape[0]
    hA, hb, _, _ = geometry(bank)
    ff, u_ub, G, c = bank.ffg, bank.u_ub, bank.gen_G, bank.gen_c
    wt = w + ff
    feasible = (torch.einsum("bfi,bi->bf", hA, wt) <= hb + 1e-7).all(1)
    step = 1.0 / torch.clamp(bank.gen_L, min=1e-12)
    th = torch.full((B, N_T), 0.5, dtype=w.dtype, device=w.device)
    eta, t = th, 1.0
    for _ in range(al["fista_iters"]):
        grad = torch.einsum("bij,bi->bj", G, _mv(G, eta) + c - wt)
        th_new = torch.clamp(eta - step[:, None] * grad, 0.0, 1.0)
        t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        eta = th_new + ((t - 1.0) / t_new) * (th_new - th)
        th, t = th_new, t_new
    w_des = torch.where(feasible[:, None], wt, c + _mv(G, th)) - ff
    u_fb = torch.minimum(torch.clamp(th * bank.u_ub.new_tensor(float(al["max_thrust"])),
                                     min=0.0), u_ub)
    rho, sig, a = al["rho"], al["sigma"], al["alpha"]
    rho_eq = rho * al["rho_eq_scale"]
    rho_box = torch.where(u_ub <= 1e-12, torch.full_like(u_ub, rho_eq),
                          torch.full_like(u_ub, rho))
    # x-update matrix 2I + sigma I + rho_eq D'D + diag(rho_box), inverted directly
    Kx = torch.diag_embed(2.0 + sig + rho_box) + rho_eq * (D.T @ D)
    Kinv = torch.linalg.inv(Kx)
    x = torch.zeros(B, N_T, dtype=w.dtype, device=w.device)
    z_box, y_eq, y_box = torch.zeros_like(x), torch.zeros_like(w_des), torch.zeros_like(x)
    z_eq = w_des
    for _ in range(al["admm_iters"]):
        rhs = sig * x + (rho_eq * z_eq - y_eq) @ D + (rho_box * z_box - y_box)
        xt = _mv(Kinv, rhs)
        zh_eq = a * (xt @ D.T) + (1 - a) * z_eq
        zh_box = a * xt + (1 - a) * z_box
        x = a * xt + (1 - a) * x
        z_box_new = torch.minimum(torch.clamp(zh_box + y_box / rho_box, min=0.0), u_ub)
        y_eq = y_eq + rho_eq * (zh_eq - w_des)
        y_box = y_box + rho_box * (zh_box - z_box_new)
        z_eq, z_box = w_des, z_box_new
    u = torch.minimum(torch.clamp(x, min=0.0), u_ub)
    healthy = (u_ub > 1e-12).to(w.dtype)
    Dm = D[None] * healthy[:, None, :]
    W2 = Dm @ Dm.transpose(-1, -2) + 1e-6 * torch.eye(6, dtype=w.dtype, device=w.device)
    lam = torch.linalg.solve(W2, w_des - u @ D.T)
    u = torch.minimum(torch.clamp(u + healthy * (lam @ D), min=0.0), u_ub)
    eq_err = (u @ D.T - w_des).abs().amax(1)
    fb_err = (u_fb @ D.T - w_des).abs().amax(1)
    use_fb = (eq_err > 1e-2) & (fb_err < eq_err - 1e-9)
    return torch.where(use_fb[:, None], u_fb, u), feasible, use_fb


# ---------------------------------------------------------------------------
# the control step
# ---------------------------------------------------------------------------


def init_warm(pl, bank, W, cfg, c0, x_ref, u_ref):
    """The first warm start: the centre dynamics rolled out under zero
    deviation input, zero duals, rho at its start, the exact metric inverse
    (condensed backend)."""
    B = c0.shape[0]
    Nt = cfg.horizon
    kw = dict(dtype=c0.dtype, device=c0.device)
    x, Xs = c0, [c0]
    for _ in range(Nt):
        x = center_step(pl, bank.ffg, bank.r, x, bank.u_comp)
        Xs.append(x)
    warm = SimpleNamespace(X=torch.stack(Xs, 1), U=torch.zeros(B, Nt, N_U, **kw),
                           y_hull=torch.zeros(B, Nt, bank.hull_A.shape[1], **kw),
                           y_term=torch.zeros(B, bank.term_A.shape[1] + n_extra(W, Nt), **kw),
                           rho=torch.full((B,), cfg.admm.rho, **kw), kinv=None)
    if cfg.qp_backend == "condensed":
        qp, _, _, _ = assemble_condensed(pl, bank, W, cfg, warm.X, warm.U,
                                         per_row_ref(bank, x_ref), u_ref, geometry(bank))
        warm.kinv = exact_inverse(metric(qp, warm.rho, cfg.admm.sigma)(warm.rho))
    return warm


def control_step(pl, bank, W, cfg, x0, x_ref, u_ref, warm):
    """One bank-wide control step: (u_phys, wrench, the new warm start, info,
    whole-bank metric rescues, allocation hull test, fallback use)."""
    c0 = robot_to_center(bank.r, x0)
    solve = sqp_stagewise if cfg.qp_backend == "stagewise" else sqp_condensed
    new, info, rescues = solve(pl, bank, W, cfg, c0, x_ref, u_ref, warm)
    u_nom = _mv(rot_full(c0[:, 9:13]).transpose(-1, -2), u_ref[0])
    wrench = _mv(rot_full(bank.beta), new.U[:, 0] + u_nom + bank.u_comp)
    u, feasible, fallback = allocate(pl["D"], bank, wrench, {**cfg.alloc,
                                                             "max_thrust": pl["max_thrust"]})
    return SimpleNamespace(u_phys=u, wrench=wrench, warm=new, info=info, rescues=rescues,
                           hull_feasible=feasible, fallback=fallback)
