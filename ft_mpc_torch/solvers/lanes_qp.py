"""Batched condensed-QP solve: K^{-1} (exact cold start + Newton-Schulz warm
refresh) and fused ADMM iterations.  Counterpart of
`ft_mpc_tpu/solvers/lanes_qp.py`; the port keeps the module and function
names but has no lane layout: every tensor is batch-leading.

* `exact_kinv`: batched Cholesky + solve against the identity (a library
  call, as the JAX package leaves it to XLA).
* `newton_kinv`: symmetric Newton-Schulz refresh with a power-iteration
  spectral test and a whole-batch exact-refactor rescue.
* `admm_lanes`: `iters` ADMM iterations with a fixed K^{-1}; CUDA tensors
  launch `csrc/admm.cu`, CPU tensors run `admm_plain`.
* `solve_mpc_qp_lanes`: the phase loop around it -- residuals, term_gap,
  rho adaptation with the converged-lane freeze, per-phase refactor.

Matmuls that feed K^{-1} run in full fp32 (TF32 off, `ft_mpc_torch.pin_fp32_matmuls`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ft_mpc_torch import kernels
from ft_mpc_torch.solvers.admm import chol_inverse
from ft_mpc_torch.solvers.mpc_qp import (
    StructuredADMMConfig,
    StructuredMPCQP,
    elastic_gap,
    rho_factor,
)
from ft_mpc_torch.utils.logging import span

N_U = 6


class LanesSolution(NamedTuple):
    x: torch.Tensor  # (B, n)
    y_hull: torch.Tensor  # (B, Nt, F)
    y_term: torch.Tensor  # (B, T)
    r_prim: torch.Tensor  # (B,)
    r_dual: torch.Tensor  # (B,)
    rho: torch.Tensor  # (B,) float32
    kinv: torch.Tensor  # (B, n, n) float32 metric to carry into the next solve
    term_gap: torch.Tensor  # (B,) max violation of dual-saturated elastic rows


# ---------------------------------------------------------------------------
# K^{-1}: exact cold start + Newton-Schulz warm refresh
# ---------------------------------------------------------------------------


def exact_kinv(K: torch.Tensor) -> torch.Tensor:
    """Batched explicit inverse via Cholesky (cold-start path).

    A scenario whose factorization fails gets an all-NaN inverse, as the
    JAX path does; `newton_kinv`'s rescue test sees it as non-finite.
    """
    with span("ft_mpc.kinv_exact"):
        return chol_inverse(K)


def newton_kinv(K: torch.Tensor, X0: torch.Tensor, iters: int) -> torch.Tensor:
    """Refresh X ~= K^{-1} from a warm X0 by symmetric Newton-Schulz.

    The per-scenario rescale s = tr(K X0)/||K X0||_F^2 centers the spectrum
    of s K X0 around 1; each step X <- 2X - X K X squares the residual.  A
    3-step power iteration estimates rho(I - s K X0); if any scenario
    exceeds what `iters` steps can contract (or is non-finite), the whole
    batch is refactored exactly instead.
    """
    B, n, _ = K.shape
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    Y = K @ X0
    tr = torch.diagonal(Y, dim1=-2, dim2=-1).sum(-1)
    fn = torch.clamp((Y * Y).sum(dim=(-2, -1)), min=1e-30)
    s = (tr / fn)[:, None, None]
    R = s * Y - eye
    v = torch.sin(1.0 + torch.arange(n, dtype=K.dtype, device=K.device))[None, :, None]
    v = v.expand(B, n, 1) / torch.sqrt(torch.tensor(float(n), dtype=K.dtype))
    for _ in range(3):
        v = R @ v
        v = v / (torch.linalg.vector_norm(v, dim=-2, keepdim=True) + 1e-30)
    resid = torch.linalg.vector_norm((R @ v)[..., 0], dim=-1)

    # budget: iters Newton steps leave resid^(2^iters); require < ~1e-2
    threshold = float(0.01 ** (1.0 / 2**iters))
    # One host sync per refresh (the JAX path's lax.cond): only one branch
    # is computed.  Both flags (rescue, and rescue for a non-finite
    # residual) come over in one read.  A device-side select without the
    # sync is a place for a later change.
    nonfinite = ~torch.isfinite(resid)
    flags = torch.stack([((resid >= threshold) | nonfinite).any(), nonfinite.any()])
    with span("ft_mpc.sync"):
        rescue, rescue_nonfinite = flags.tolist()
    if rescue:
        newton_kinv.rescues += 1
        newton_kinv.rescues_nonfinite += int(rescue_nonfinite)
        return exact_kinv(K)
    X, Yl = s * X0, s * Y
    for i in range(iters):
        X = 2.0 * X - X @ Yl
        X = 0.5 * (X + X.transpose(-1, -2))
        if i < iters - 1:
            Yl = K @ X
    return X


newton_kinv.rescues = 0  # whole-batch exact refactors taken
newton_kinv.rescues_nonfinite = 0  # of those, taken with a non-finite residual


def build_K(qp: StructuredMPCQP, rho: torch.Tensor, sigma: float):
    """K = H + sigma I + rho (I_Nt kron Ah^T Ah + Gt^T Gt), batched, float32.

    Returns (K, M_rho) so per-phase rebuilds reuse M_rho.
    """
    B, n = qp.g.shape
    Nt = qp.h_hull.shape[1]
    f32 = torch.float32
    AhTAh = torch.einsum("bfi,bfj->bij", qp.hull_A, qp.hull_A).to(f32)
    GtTGt = torch.einsum("bti,btj->bij", qp.G_term, qp.G_term).to(f32)
    eye_nt = torch.eye(Nt, dtype=f32, device=AhTAh.device)
    blk = torch.einsum("st,bij->bsitj", eye_nt, AhTAh).reshape(B, n, n)
    M_rho = blk + GtTGt
    eye = torch.eye(n, dtype=f32, device=AhTAh.device)
    K = qp.H.to(f32) + sigma * eye + rho.to(f32)[:, None, None] * M_rho
    return K, M_rho


# ---------------------------------------------------------------------------
# fused ADMM iterations with a fixed K^{-1}
# ---------------------------------------------------------------------------


def admm_plain(Kinv, hull_A, h_hull, G_term, h_term, g, x0, zh0, zt0, yh0, yt0,
               rho, sigma, alpha, iters, elastic_y_max=0.0):
    """`iters` over-relaxed ADMM iterations in plain torch (input dtype).

    Same iteration as the kernel (and `_admm_kernel`): implicit stage-hull
    block, dense terminal rows, exact hinge prox + dual clamp when elastic.
    """
    B, n = g.shape
    Nt = h_hull.shape[1]
    inv_rho = 1.0 / rho
    r3, r2 = rho[:, None, None], rho[:, None]
    x, zh, zt, yh, yt = x0, zh0, zt0, yh0, yt0
    for _ in range(iters):
        gty = torch.einsum("btf,bfj->btj", r3 * zh - yh, hull_A).reshape(B, n)
        gty = gty + torch.einsum("brn,br->bn", G_term, r2 * zt - yt)
        rhs = sigma * x - g + gty
        x_t = torch.einsum("bij,bj->bi", Kinv, rhs)
        x_new = alpha * x_t + (1.0 - alpha) * x
        gh_t = torch.einsum("btj,bfj->btf", x_t.reshape(B, Nt, N_U), hull_A)
        gt_t = torch.einsum("brn,bn->br", G_term, x_t)
        zh_hat = alpha * gh_t + (1.0 - alpha) * zh
        zt_hat = alpha * gt_t + (1.0 - alpha) * zt
        zh_new = torch.minimum(zh_hat + yh * inv_rho[:, None, None], h_hull)
        vt = zt_hat + yt * inv_rho[:, None]
        if elastic_y_max > 0:
            soft_shift = elastic_y_max * inv_rho[:, None]
            zt_new = torch.where(
                vt > h_term + soft_shift, vt - soft_shift, torch.minimum(vt, h_term)
            )
        else:
            zt_new = torch.minimum(vt, h_term)
        yh_new = yh + r3 * (zh_hat - zh_new)
        yt_new = yt + r2 * (zt_hat - zt_new)
        if elastic_y_max > 0:
            yt_new = torch.clamp(yt_new, 0.0, elastic_y_max)
        x, zh, zt, yh, yt = x_new, zh_new, zt_new, yh_new, yt_new
    return x, zh, zt, yh, yt


def _admm_cuda(Kinv, hull_A, h_hull, G_term, h_term, g, x0, zh0, zt0, yh0, yt0,
               rho, sigma, alpha, iters, elastic_y_max):
    ins = (Kinv, hull_A, h_hull, G_term, h_term, g, x0, zh0, zt0, yh0, yt0, rho)
    kernels.require_cuda_f32("admm_lanes", *ins)
    B, Nt, F = h_hull.shape
    T = h_term.shape[1]
    outs = [torch.empty_like(t) for t in (x0, zh0, zt0, yh0, yt0)]
    fn = kernels.function(
        "admm", "admm_f32",
        [ctypes.c_void_p] * 17
        + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p],
    )
    design = admm_design(Nt, F, T)
    err = fn(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
             B, Nt, F, T, float(sigma), float(alpha), int(iters),
             float(elastic_y_max), kernels.stream_of(Kinv))
    kernels.check("admm", "admm_f32", err)
    admm_lanes.launches += 1
    admm_lanes.launches_by_design[design] += 1
    return tuple(outs)


ADMM_DESIGNS = ("registers", "cluster", "device")


def admm_design(Nt: int, F: int, T: int) -> str:
    """Which design of `csrc/admm.cu` admm_f32 runs at these sizes:
    'registers' (K^-1 and G_term in registers: Nt <= 16, F <= 32, T <= 64),
    'cluster' (K^-1, G_term and the hull state in the shared memory of a
    cluster of 1, 2, 4 or 8 blocks: Nt <= 85 at F=32, T=64, T <= 4291 at
    Nt=15) or 'device' (K^-1 and G_term read from device memory).  Asks the
    built library."""
    fn = kernels.function("admm", "admm_design", [ctypes.c_int] * 3)
    code = fn(int(Nt), int(F), int(T))
    if code < 0:
        raise ValueError(f"admm_lanes: no kernel design takes Nt={Nt}, F={F}, T={T}")
    return ADMM_DESIGNS[code]


def admm_plan(Nt: int, F: int, T: int) -> dict:
    """admm_f32's plan at these sizes, from the built library: the design,
    the blocks a scenario takes (`cluster`, 1 outside the cluster design),
    a block's dynamic shared memory in bytes, the cluster design's lanes per
    row (`group`), float4 per lane (`chunks`) and `threads` a block, and
    cudaOccupancyMaxActiveClusters of its launch (`max_active_clusters`)."""
    fn = kernels.function("admm", "admm_plan", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 7)()
    code = fn(int(Nt), int(F), int(T), out)
    if code < 0:
        raise ValueError(f"admm_lanes: no kernel design takes Nt={Nt}, F={F}, T={T}")
    kernels.check("admm", "admm_plan", out[6])
    return {"design": ADMM_DESIGNS[code], "cluster": out[0], "smem_bytes": out[1],
            "group": out[2], "chunks": out[3], "threads": out[4],
            "max_active_clusters": out[5]}


def admm_lanes(Kinv, hull_A, h_hull, G_term, h_term, g, x0, zh0, zt0, yh0, yt0,
               rho, sigma, alpha, iters, elastic_y_max=0.0):
    """ADMM iterations for a batch, float32 (batch-leading shapes).

    Kinv (B,n,n), hull_A (B,F,6), h_hull/zh0/yh0 (B,Nt,F), G_term (B,T,n),
    h_term/zt0/yt0 (B,T), g/x0 (B,n), rho (B,).  Returns float32
    (x, zh, zt, yh, yt).  CUDA tensors launch `csrc/admm.cu`; CPU tensors
    run `admm_plain`.
    """
    B, n = g.shape
    Nt, F = h_hull.shape[1:]
    T = h_term.shape[1]
    expect = {
        "Kinv": (Kinv, (B, n, n)), "hull_A": (hull_A, (B, F, N_U)),
        "G_term": (G_term, (B, T, n)), "x0": (x0, (B, n)),
        "zh0": (zh0, (B, Nt, F)), "yh0": (yh0, (B, Nt, F)),
        "zt0": (zt0, (B, T)), "yt0": (yt0, (B, T)), "rho": (rho, (B,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"admm_lanes: {name} {tuple(t.shape)}, expected {shape}")
    if Nt * N_U != n:
        raise ValueError(f"admm_lanes: n={n} is not 6 * Nt={Nt}")
    args = [t.to(torch.float32).contiguous() for t in
            (Kinv, hull_A, h_hull, G_term, h_term, g, x0, zh0, zt0, yh0, yt0, rho)]
    if args[0].device.type == "cpu":
        return admm_plain(*args, float(sigma), float(alpha), int(iters),
                          float(elastic_y_max))
    return _admm_cuda(*args, sigma, alpha, iters, elastic_y_max)


admm_lanes.launches = 0
admm_lanes.launches_by_design = dict.fromkeys(ADMM_DESIGNS, 0)  # of `launches`


# ---------------------------------------------------------------------------
# phase loop with the same semantics as solve_mpc_qp
# ---------------------------------------------------------------------------


def solve_mpc_qp_lanes(
    qp: StructuredMPCQP,
    cfg: StructuredADMMConfig = StructuredADMMConfig(),
    y_hull0: torch.Tensor | None = None,
    y_term0: torch.Tensor | None = None,
    rho0: torch.Tensor | None = None,
    kinv0: torch.Tensor | None = None,
    newton_iters: int = 2,
) -> LanesSolution:
    """Batched structured-QP solve (counterpart of the JAX entry point).

    With `kinv0` the metric is Newton-refreshed from it; without, it is
    factored exactly (and refactored exactly per phase).  There are no
    padded lanes in the port, so no padding rho is needed.
    """
    with span("ft_mpc.qp"):
        return _solve_phases(qp, cfg, y_hull0, y_term0, rho0, kinv0, newton_iters)


def _solve_phases(qp, cfg, y_hull0, y_term0, rho0, kinv0, newton_iters) -> LanesSolution:
    B, n = qp.g.shape
    Nt = qp.h_hull.shape[1]
    dtype = qp.H.dtype
    f32 = torch.float32
    dev = qp.H.device

    yh = torch.zeros_like(qp.h_hull) if y_hull0 is None else y_hull0
    yt = torch.zeros_like(qp.h_term) if y_term0 is None else y_term0
    if rho0 is None:
        rho = torch.full((B,), cfg.rho, dtype=f32, device=dev)
    else:
        rho = torch.clamp(rho0.expand(B), cfg.rho_min, cfg.rho_max).to(f32)

    _, M_rho = build_K(qp, rho, cfg.sigma)
    eye = torch.eye(n, dtype=f32, device=dev)
    H32 = qp.H.to(f32)

    def make_kinv(rho, kinv_prev, iters):
        with span("ft_mpc.kinv"):
            K = H32 + cfg.sigma * eye + rho[:, None, None] * M_rho
            if kinv_prev is None:
                return exact_kinv(K)
            return newton_kinv(K, kinv_prev, iters)

    kinv = make_kinv(rho, kinv0, newton_iters)

    # same cold start as mpc_qp: x = 0, z = min(G 0, h) = min(0, h)
    x = torch.zeros((B, n), dtype=dtype, device=dev)
    zh = torch.clamp(qp.h_hull, max=0.0)
    zt = torch.clamp(qp.h_term, max=0.0)
    for _ in range(cfg.phases):
        with span("ft_mpc.admm"):
            x, zh, zt, yh_n, yt_n = (
                t.to(dtype) for t in admm_lanes(
                    kinv, qp.hull_A, qp.h_hull, qp.G_term, qp.h_term, qp.g,
                    x, zh, zt, yh, yt, rho, cfg.sigma, cfg.alpha, cfg.iters,
                    cfg.elastic_y_max,
                )
            )

        # residuals + rho adaptation (the rule of mpc_qp.solve_mpc_qp)
        Gh = torch.einsum("btj,bfj->btf", x.reshape(B, Nt, N_U), qp.hull_A)
        Gt_x = torch.einsum("btn,bn->bt", qp.G_term, x)
        term_res = torch.abs(Gt_x - zt)
        if cfg.elastic_y_max > 0:
            term_gap = elastic_gap(yt_n, Gt_x, qp.h_term, cfg.elastic_y_max, 1)
        else:
            term_gap = torch.zeros((B,), dtype=dtype, device=dev)
        r_prim = torch.maximum(
            torch.abs(Gh - zh).amax(dim=(1, 2)), term_res.amax(dim=1)
        )
        gty = (
            torch.einsum("btf,bfj->btj", yh_n, qp.hull_A).reshape(B, n)
            + torch.einsum("btn,bt->bn", qp.G_term, yt_n)
        )
        Hx = torch.einsum("bij,bj->bi", qp.H, x)
        r_dual = torch.abs(Hx + qp.g + gty).amax(dim=1)
        prim_scale = torch.maximum(torch.abs(Gh).amax(dim=(1, 2)),
                                   torch.abs(zh).amax(dim=(1, 2)))
        dual_scale = torch.maximum(torch.abs(Hx).amax(dim=1), torch.abs(qp.g).amax(dim=1))
        # the converged-lane freeze also spares a warm K^-1 needless refreshes
        factor = rho_factor(r_prim, prim_scale, r_dual, dual_scale, cfg.adapt_clip)
        rho_new = torch.clamp(rho * factor.to(f32), cfg.rho_min, cfg.rho_max)
        if cfg.phases > 1:
            # exact refactor per phase on the cold path (rho may jump 5x);
            # Newton refresh when the caller carries a warm inverse
            kinv = make_kinv(rho_new, None if kinv0 is None else kinv,
                             max(newton_iters, 2))
        yh, yt, rho = yh_n, yt_n, rho_new
    return LanesSolution(
        x=x, y_hull=yh, y_term=yt, r_prim=r_prim, r_dual=r_dual, rho=rho,
        kinv=kinv, term_gap=term_gap,
    )
