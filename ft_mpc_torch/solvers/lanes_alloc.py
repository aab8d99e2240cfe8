"""Batched thruster allocation, counterpart of `ft_mpc_tpu/solvers/lanes_alloc.py`.

Hull feasibility test, FISTA projection of the total wrench onto the
attainable zonotope, allocation ADMM (min |u|^2 s.t. D u = w_des,
0 <= u <= u_ub) with a Woodbury x-update through an unpivoted 6x6
Gauss-Jordan inverse, min-norm equality polish, fallback selection.
`allocate_thrusters_lanes` launches `csrc/alloc.cu` on CUDA tensors and runs
`alloc_plain` (same arithmetic in plain torch) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ft_mpc_torch import kernels
from ft_mpc_torch.solvers.allocation import AllocationResult

N_W = 6
N_T = 16
_BIG = 1e8


def _gauss_jordan6(W: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD (..., 6, 6) matrices by unpivoted Gauss-Jordan.

    W = I/rho_eq + D Dia^{-1} D^T is SPD with a bounded-away diagonal, so
    the natural pivot order is numerically safe.
    """
    n = W.shape[-1]
    eye = torch.eye(n, dtype=W.dtype, device=W.device).expand(W.shape)
    aug = torch.cat([W, eye], dim=-1)  # (..., 6, 12)
    for p in range(n):
        piv_row = aug[..., p, :] / aug[..., p, p : p + 1]
        col = aug[..., :, p]
        upd = aug - col[..., :, None] * piv_row[..., None, :]
        aug = torch.cat([upd[..., :p, :], piv_row[..., None, :], upd[..., p + 1 :, :]], dim=-2)
    return aug[..., :, n:]


def alloc_plain(D, w, ff, u_ub, hA, hb, G, c, step, mt, fista_iters, admm_iters,
                rho, rho_eq_scale, sigma, alpha):
    """Allocation in plain torch; returns (u (B,16), w_des (B,6), flags (B,3)).

    flags columns: was_clipped, used_fallback, equality error.
    """
    B = w.shape[0]
    w_total = w + ff
    hAw = torch.einsum("bfi,bi->bf", hA, w_total)
    feasible = (hAw <= hb + 1e-7).all(dim=1)

    theta = torch.full((B, N_T), 0.5, dtype=w.dtype, device=w.device)
    eta = theta
    t = 1.0
    for _ in range(fista_iters):
        r = torch.einsum("bij,bj->bi", G, eta) + c - w_total
        grad = torch.einsum("bij,bi->bj", G, r)
        theta_new = torch.clamp(eta - step[:, None] * grad, 0.0, 1.0)
        t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        eta = theta_new + ((t - 1.0) / t_new) * (theta_new - theta)
        theta, t = theta_new, t_new
    w_proj = c + torch.einsum("bij,bj->bi", G, theta)
    w_clipped = torch.where(feasible[:, None], w_total, w_proj)
    u_fallback = torch.minimum(torch.clamp(theta * mt[:, None], min=0.0), u_ub)
    w_des = w_clipped - ff

    rho_eq = rho * rho_eq_scale
    rho_box = torch.where(
        u_ub <= 1e-12, torch.full_like(u_ub, rho * rho_eq_scale), torch.full_like(u_ub, rho)
    )
    di = 1.0 / (2.0 + sigma + rho_box)
    eye6 = torch.eye(N_W, dtype=w.dtype, device=w.device)
    DD = D[:, None, :] * D[None, :, :]  # (6, 6, 16)
    Winv = _gauss_jordan6(eye6 / rho_eq + torch.einsum("aej,bj->bae", DD, di))

    d_mul = lambda v: v @ D.T  # (B, 16) -> (B, 6)
    dt_mul = lambda v: v @ D  # (B, 6) -> (B, 16)

    def kinv_apply(v):
        tv = di * v
        r6 = torch.einsum("bae,be->ba", Winv, d_mul(tv))
        return tv - di * dt_mul(r6)

    x = torch.zeros((B, N_T), dtype=w.dtype, device=w.device)
    z_eq = w_des
    z_box = torch.zeros_like(x)
    y_eq = torch.zeros_like(w_des)
    y_box = torch.zeros_like(x)
    for _ in range(admm_iters):
        rhs = sigma * x + dt_mul(rho_eq * z_eq - y_eq) + (rho_box * z_box - y_box)
        x_t = kinv_apply(rhs)
        x_new = alpha * x_t + (1.0 - alpha) * x
        zh_eq = alpha * d_mul(x_t) + (1.0 - alpha) * z_eq
        zh_box = alpha * x_t + (1.0 - alpha) * z_box
        z_eq_new = w_des  # clip(v, w_des, w_des)
        z_box_new = torch.minimum(torch.clamp(zh_box + y_box / rho_box, min=0.0), u_ub)
        y_eq = y_eq + rho_eq * (zh_eq - z_eq_new)
        y_box = y_box + rho_box * (zh_box - z_box_new)
        x, z_eq, z_box = x_new, z_eq_new, z_box_new

    u = torch.minimum(torch.clamp(x, min=0.0), u_ub)
    healthy = (u_ub > 1e-12).to(w.dtype)
    r_eq = w_des - d_mul(u)
    W2inv = _gauss_jordan6(1e-6 * eye6 + torch.einsum("aej,bj->bae", DD, healthy))
    lam = torch.einsum("bae,be->ba", W2inv, r_eq)
    u = torch.minimum(torch.clamp(u + healthy * dt_mul(lam), min=0.0), u_ub)

    eq_err = torch.abs(d_mul(u) - w_des).amax(dim=1)
    fb_err = torch.abs(d_mul(u_fallback) - w_des).amax(dim=1)
    use_fb = (eq_err > 1e-2) & (fb_err < eq_err - 1e-9)
    u = torch.where(use_fb[:, None], u_fallback, u)
    flags = torch.stack(
        [(~feasible).to(w.dtype), use_fb.to(w.dtype), torch.where(use_fb, fb_err, eq_err)],
        dim=1,
    )
    return u, w_des, flags


def _alloc_cuda(D, w, ff, u_ub, hA, hb, G, c, step, mt, fista_iters, admm_iters,
                rho, rho_eq_scale, sigma, alpha):
    ins = (D, w, ff, u_ub, hA, hb, G, c, step, mt)
    kernels.require_cuda_f32("allocate_thrusters_lanes", *ins)
    B, F = hb.shape
    u = torch.empty((B, N_T), dtype=torch.float32, device=w.device)
    w_des = torch.empty((B, N_W), dtype=torch.float32, device=w.device)
    flags = torch.empty((B, 3), dtype=torch.float32, device=w.device)
    fn = kernels.function(
        "alloc", "alloc_f32",
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
        + [ctypes.c_void_p],
    )
    err = fn(*(t.data_ptr() for t in ins), u.data_ptr(), w_des.data_ptr(),
             flags.data_ptr(), B, F, int(fista_iters), int(admm_iters),
             float(rho), float(rho_eq_scale), float(sigma), float(alpha),
             kernels.stream_of(w))
    kernels.check("alloc", "alloc_f32", err)
    allocate_thrusters_lanes.launches += 1
    return u, w_des, flags


def allocate_thrusters_lanes(
    wrench_cmd: torch.Tensor,  # (B, 6)
    D: torch.Tensor,  # (6, 16) shared
    u_ub: torch.Tensor,  # (B, 16)
    faulty_force_gen: torch.Tensor,  # (B, 6)
    hull_A: torch.Tensor,  # (B, F, 6)
    hull_b: torch.Tensor,  # (B, F)
    hull_mask: torch.Tensor,  # (B, F)
    gen_G: torch.Tensor,  # (B, 6, 16)
    gen_c: torch.Tensor,  # (B, 6)
    gen_L: torch.Tensor,  # (B,)
    max_thrust,
    fista_iters: int = 60,
    admm_iters: int = 40,
    rho: float = 1.0,
    rho_eq_scale: float = 1e3,
    sigma: float = 1e-6,
    alpha: float = 1.6,
) -> AllocationResult:
    """Batched allocation (float32 inside, outputs in the wrench's dtype)."""
    B = wrench_cmd.shape[0]
    F = hull_A.shape[1]
    dtype = wrench_cmd.dtype
    f32 = torch.float32
    dev = wrench_cmd.device
    expect = {
        "wrench_cmd": (wrench_cmd, (B, N_W)), "D": (D, (N_W, N_T)),
        "u_ub": (u_ub, (B, N_T)), "faulty_force_gen": (faulty_force_gen, (B, N_W)),
        "hull_A": (hull_A, (B, F, N_W)), "hull_b": (hull_b, (B, F)),
        "hull_mask": (hull_mask, (B, F)), "gen_G": (gen_G, (B, N_W, N_T)),
        "gen_c": (gen_c, (B, N_W)), "gen_L": (gen_L, (B,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"allocate_thrusters_lanes: {name} {tuple(t.shape)}, expected {shape}"
            )
    hA = hull_A * hull_mask[:, :, None]
    hb = torch.where(hull_mask > 0.5, hull_b, _BIG)
    step = 1.0 / torch.clamp(gen_L.to(f32), min=1e-12)
    mt = torch.as_tensor(max_thrust, dtype=f32, device=dev).expand(B)
    args = [t.to(f32).contiguous() for t in
            (D, wrench_cmd, faulty_force_gen, u_ub, hA, hb, gen_G, gen_c, step, mt)]
    run = alloc_plain if dev.type == "cpu" else _alloc_cuda
    u, w_des, flags = run(*args, fista_iters, admm_iters, rho, rho_eq_scale,
                          sigma, alpha)
    return AllocationResult(
        u_phys=u.to(dtype),
        wrench_clipped=w_des.to(dtype),
        was_clipped=flags[:, 0] > 0.5,
        r_prim=flags[:, 2].to(dtype),
        used_fallback=flags[:, 1] > 0.5,
    )


allocate_thrusters_lanes.launches = 0
