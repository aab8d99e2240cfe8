"""Batched LQR re-solve for the stagewise (long-horizon) backend, counterpart
of `ft_mpc_tpu/solvers/lanes_riccati.py`.

The stagewise ADMM's x-update is an LQR re-solve against a fixed Riccati
factorization (`solvers/riccati.py:lqr_resolve`): a backward then a forward
affine sweep of 13-vector recursions over the horizon.  `lqr_resolve_lanes`
keeps the JAX wrapper's name and batch-leading shapes; the port has no lane
layout and no padding.  On CUDA tensors each sweep is one launch of a
hand-written kernel of `csrc/riccati.cu` (one warp per scenario, the stage
loop inside the kernel); on CPU tensors the sweeps run their plain versions,
`riccati.resolve_bwd_plain` and `riccati.resolve_fwd_plain`.  Like the JAX
wrapper it works in float32 and casts back to the input dtype.
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from ft_mpc_torch import kernels
from ft_mpc_torch.solvers.riccati import (
    LQRFactorization,
    resolve_bwd_plain,
    resolve_fwd_plain,
)

N_X = 13
N_U = 6


def _check_shapes(name, B, named):
    """named: {argument: (tensor, its shape after the batch axis)}."""
    for key, (t, shape) in named.items():
        if tuple(t.shape) != (B, *shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"the kernel takes {(B, *shape)}")


def riccati_bwd_lanes(F, Bm, K, Quu_inv, PC, q, r, qN):
    """Backward sweep on the card: ks (B, Nt, 6).  float32 CUDA tensors only."""
    kernels.require_cuda_f32("riccati_bwd_lanes", F, Bm, K, Quu_inv, PC, q, r, qN)
    B, Nt = F.shape[:2]
    _check_shapes("riccati_bwd_lanes", B, {
        "F": (F, (Nt, N_X, N_X)), "B": (Bm, (Nt, N_X, N_U)), "K": (K, (Nt, N_U, N_X)),
        "Quu_inv": (Quu_inv, (Nt, N_U, N_U)), "PC": (PC, (Nt, N_X)),
        "q": (q, (Nt, N_X)), "r": (r, (Nt, N_U)), "qN": (qN, (N_X,)),
    })
    ks = torch.empty((B, Nt, N_U), dtype=torch.float32, device=F.device)
    fn = kernels.function(
        "riccati", "riccati_bwd_f32",
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(F.data_ptr(), Bm.data_ptr(), K.data_ptr(), Quu_inv.data_ptr(),
             PC.data_ptr(), q.data_ptr(), r.data_ptr(), qN.data_ptr(), ks.data_ptr(),
             B, Nt, kernels.stream_of(F))
    kernels.check("riccati", "riccati_bwd_f32", err)
    riccati_bwd_lanes.launches += 1
    return ks


def riccati_fwd_lanes(F, Bm, c, K, ks, x0):
    """Forward sweep on the card: (X (B, Nt+1, 13), U (B, Nt, 6)).  float32
    CUDA tensors only."""
    kernels.require_cuda_f32("riccati_fwd_lanes", F, Bm, c, K, ks, x0)
    B, Nt = F.shape[:2]
    _check_shapes("riccati_fwd_lanes", B, {
        "F": (F, (Nt, N_X, N_X)), "B": (Bm, (Nt, N_X, N_U)), "c": (c, (Nt, N_X)),
        "K": (K, (Nt, N_U, N_X)), "ks": (ks, (Nt, N_U)), "x0": (x0, (N_X,)),
    })
    X = torch.empty((B, Nt + 1, N_X), dtype=torch.float32, device=F.device)
    U = torch.empty((B, Nt, N_U), dtype=torch.float32, device=F.device)
    fn = kernels.function(
        "riccati", "riccati_fwd_f32",
        [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(F.data_ptr(), Bm.data_ptr(), c.data_ptr(), K.data_ptr(), ks.data_ptr(),
             x0.data_ptr(), X.data_ptr(), U.data_ptr(), B, Nt, kernels.stream_of(F))
    kernels.check("riccati", "riccati_fwd_f32", err)
    riccati_fwd_lanes.launches += 1
    return X, U


riccati_bwd_lanes.launches = 0
riccati_fwd_lanes.launches = 0


def lqr_resolve_lanes(fact: LQRFactorization, q, r, qN, x0):
    """Batched `lqr_resolve` as two sweeps, one kernel launch each on the card.

    fact: an `LQRFactorization` whose leaves carry a leading batch axis B.
    q (B, Nt, n), r (B, Nt, m), qN (B, n), x0 (B, n).
    Returns (X (B, Nt+1, n), U (B, Nt, m)) in fact.F's dtype.  float32
    inside (a float32 contiguous input is used as it is, not copied).  CUDA
    tensors launch `csrc/riccati.cu` (n = 13, m = 6 only); CPU tensors run
    the plain sweeps.
    """
    dtype = fact.F.dtype
    f = LQRFactorization(*(x.to(torch.float32).contiguous() for x in fact))
    q, r, qN, x0 = (x.to(torch.float32).contiguous() for x in (q, r, qN, x0))
    if f.F.device.type == "cpu":
        ks = resolve_bwd_plain(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
        X, U = resolve_fwd_plain(f.F, f.B, f.c, f.K, ks, x0)
    else:
        with record_function("ft_mpc.riccati"):
            ks = riccati_bwd_lanes(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
            X, U = riccati_fwd_lanes(f.F, f.B, f.c, f.K, ks, x0)
    return X.to(dtype), U.to(dtype)
