"""Condensing (prediction matrices), counterpart of
`ft_mpc_tpu/solvers/lanes_condense.py`.

    S_t = A_t S_{t-1} (+ B_t at column block t),  phi_t = A_t phi_{t-1} + d_t

`condense_lanes` keeps the JAX wrapper's name and batch-leading shapes; the
port has no lane layout.  On a CUDA tensor it launches the hand-written
kernel `csrc/condense.cu` (one block per scenario, carry in shared memory);
on a CPU tensor it runs `condense_plain`, the same recursion in plain torch.
Like the JAX wrapper it works in float32 and casts back to the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ft_mpc_torch import kernels

N_X = 13
N_U = 6


def condense_plain(A_stack, B_stack, defects):
    """The recursion in plain torch, in the input dtype, any leading dims.

    A_stack (..., Nt, 13, 13), B_stack (..., Nt, 13, 6), defects (..., Nt, 13)
    -> S_all (..., Nt, 13, 6 Nt), phi_all (..., Nt, 13).
    """
    Nt = A_stack.shape[-3]
    lead = A_stack.shape[:-3]
    n = Nt * N_U
    S = A_stack.new_zeros(*lead, N_X, n)
    phi = A_stack.new_zeros(*lead, N_X)
    S_all, phi_all = [], []
    for t in range(Nt):
        A_t = A_stack[..., t, :, :]
        S = A_t @ S
        blk = S[..., N_U * t : N_U * (t + 1)] + B_stack[..., t, :, :]
        S = torch.cat([S[..., : N_U * t], blk, S[..., N_U * (t + 1) :]], dim=-1)
        phi = (A_t @ phi.unsqueeze(-1)).squeeze(-1) + defects[..., t, :]
        S_all.append(S)
        phi_all.append(phi)
    return torch.stack(S_all, dim=-3), torch.stack(phi_all, dim=-2)


def _condense_cuda(A, Bm, d):
    kernels.require_cuda_f32("condense_lanes", A, Bm, d)
    B, Nt = A.shape[:2]
    S = torch.empty((B, Nt, N_X, Nt * N_U), dtype=torch.float32, device=A.device)
    phi = torch.empty((B, Nt, N_X), dtype=torch.float32, device=A.device)
    fn = kernels.function(
        "condense", "condense_f32",
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(A.data_ptr(), Bm.data_ptr(), d.data_ptr(), S.data_ptr(),
             phi.data_ptr(), B, Nt, kernels.stream_of(A))
    kernels.check("condense", "condense_f32", err)
    condense_lanes.launches += 1
    return S, phi


def condense_lanes(A_stack, B_stack, defects):
    """Batched prediction matrices: (S_all (B,Nt,13,n), phi (B,Nt,13)).

    float32 inside, cast back to the input dtype.  CUDA tensors launch
    `csrc/condense.cu`; CPU tensors run `condense_plain`.
    """
    B, Nt = A_stack.shape[:2]
    if (A_stack.shape[2:] != (N_X, N_X) or B_stack.shape != (B, Nt, N_X, N_U)
            or defects.shape != (B, Nt, N_X)):
        raise ValueError(
            f"condense_lanes: shapes {tuple(A_stack.shape)}, "
            f"{tuple(B_stack.shape)}, {tuple(defects.shape)}"
        )
    dtype = A_stack.dtype
    A, Bm, d = (x.to(torch.float32).contiguous() for x in (A_stack, B_stack, defects))
    if A.device.type == "cpu":
        S, phi = condense_plain(A, Bm, d)
    else:
        S, phi = _condense_cuda(A, Bm, d)
    return S.to(dtype), phi.to(dtype)


condense_lanes.launches = 0
