"""LQR-structured QP solves by Riccati recursion, counterpart of
`ft_mpc_tpu/solvers/riccati.py` (sequential variants).

The stagewise backend keeps the block-banded KKT structure of the MPC QP
and solves it by a Riccati recursion over the horizon:

  * `lqr_solve` (mode 'scan'): the classic backward sweep and forward
    rollout (`lqr_backward_scan`, `lqr_forward`), the independent oracle of
    the tests;
  * `lqr_factor`: the backward sweep on the quadratic data only, done once
    per ADMM phase;
  * `lqr_resolve`: a matvec-only backward and forward sweep against that
    factorization with new linear terms, done every ADMM iteration.  Its two
    halves, `resolve_bwd_plain` and `resolve_fwd_plain`, are the plain
    versions of the two CUDA kernels in `csrc/riccati.cu`
    (`solvers/lanes_riccati.py`).

Every function takes any leading batch dims: stage data is
(..., Nt, n, n) / (..., Nt, n), and the stage loop is a Python loop whose
13x13 / 6x6 products and inverses are batched over the leading dims.  The
dtype follows the inputs.  The associative-scan variants of the JAX module
are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LQRProblem(NamedTuple):
    """min sum_t 1/2 x_t'Q_t x_t + q_t'x_t + 1/2 u_t'R_t u_t + r_t'u_t
           + 1/2 x_N'QN x_N + qN'x_N
       s.t. x_{t+1} = A_t x_t + B_t u_t + c_t,  x_0 given."""

    A: torch.Tensor  # (..., Nt, n, n)
    B: torch.Tensor  # (..., Nt, n, m)
    c: torch.Tensor  # (..., Nt, n)
    Q: torch.Tensor  # (..., Nt, n, n)
    q: torch.Tensor  # (..., Nt, n)
    R: torch.Tensor  # (..., Nt, m, m)
    r: torch.Tensor  # (..., Nt, m)
    QN: torch.Tensor  # (..., n, n)
    qN: torch.Tensor  # (..., n)
    x0: torch.Tensor  # (..., n)


class LQRSolution(NamedTuple):
    X: torch.Tensor  # (..., Nt+1, n)
    U: torch.Tensor  # (..., Nt, m)
    P: torch.Tensor  # (..., Nt+1, n, n) value Hessians
    p: torch.Tensor  # (..., Nt+1, n)


class LQRFactorization(NamedTuple):
    """Quadratic part of the Riccati recursion, reusable across re-solves.

    Within an ADMM phase the quadratic data (A, B, Q, R, QN) is constant and
    only the linear terms (q, r, qN) change, so the factorization is built
    once and every iteration is a matvec-sized `lqr_resolve`.
    """

    A: torch.Tensor  # (..., Nt, n, n)
    B: torch.Tensor  # (..., Nt, n, m)
    c: torch.Tensor  # (..., Nt, n)
    P: torch.Tensor  # (..., Nt+1, n, n) value Hessians
    K: torch.Tensor  # (..., Nt, m, n) feedback gains
    Quu_inv: torch.Tensor  # (..., Nt, m, m)
    F: torch.Tensor  # (..., Nt, n, n) closed loop A - B K
    PC: torch.Tensor  # (..., Nt, n) P_{t+1} c_t


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mTv(M, v):
    """M' v without materializing the transpose."""
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _mT(M):
    return M.transpose(-1, -2)


def _inv(M):
    # inv_ex: the same LU inverse as linalg.inv without its host-side error
    # check, which would synchronize the device once per stage
    return torch.linalg.inv_ex(M).inverse


def _gains_from_value(P_next, p_next, A, B, c, R, r):
    """Stage feedback (K, k) and cross terms given V_{t+1}."""
    BtP = _mT(B) @ P_next
    Quu = R + BtP @ B
    Qux = BtP @ A
    qu = r + _mv(BtP, c) + _mTv(B, p_next)
    Quu_inv = _inv(Quu)
    return Quu_inv @ Qux, _mv(Quu_inv, qu), Qux, qu


def lqr_backward_scan(prob: LQRProblem):
    """Sequential Riccati sweep. Returns (P (..,Nt+1,n,n), p (..,Nt+1,n), K, k)."""
    Nt = prob.A.shape[-3]
    P, p = prob.QN, prob.qN
    Ps, ps, Ks, ks = [P], [p], [], []
    for t in reversed(range(Nt)):
        A, B, c = prob.A[..., t, :, :], prob.B[..., t, :, :], prob.c[..., t, :]
        K, k, Qux, _ = _gains_from_value(P, p, A, B, c, prob.R[..., t, :, :],
                                         prob.r[..., t, :])
        AtP = _mT(A) @ P
        P_new = prob.Q[..., t, :, :] + AtP @ A - _mT(Qux) @ K
        p = prob.q[..., t, :] + _mv(AtP, c) + _mTv(A, p) - _mTv(Qux, k)
        P = 0.5 * (P_new + _mT(P_new))
        Ps.append(P)
        ps.append(p)
        Ks.append(K)
        ks.append(k)
    rev = lambda xs, dim: torch.stack(xs[::-1], dim=dim)
    return rev(Ps, -3), rev(ps, -2), rev(Ks, -3), rev(ks, -2)


def lqr_forward(prob: LQRProblem, P_all, p_all):
    """Forward rollout given the value functions."""
    Nt = prob.A.shape[-3]
    x = prob.x0
    Xs, Us = [x], []
    for t in range(Nt):
        A, B, c = prob.A[..., t, :, :], prob.B[..., t, :, :], prob.c[..., t, :]
        K, k, _, _ = _gains_from_value(
            P_all[..., t + 1, :, :], p_all[..., t + 1, :], A, B, c,
            prob.R[..., t, :, :], prob.r[..., t, :],
        )
        u = -_mv(K, x) - k
        x = _mv(A, x) + _mv(B, u) + c
        Xs.append(x)
        Us.append(u)
    return torch.stack(Xs, dim=-2), torch.stack(Us, dim=-2)


def lqr_solve(prob: LQRProblem, mode: str = "scan") -> LQRSolution:
    """Solve the LQR problem exactly (mode 'scan' only)."""
    if mode != "scan":
        raise NotImplementedError(
            f"lqr_solve mode {mode!r}: the associative-scan variants are not "
            "ported (ROADMAP A6)"
        )
    P_all, p_all, _, _ = lqr_backward_scan(prob)
    X, U = lqr_forward(prob, P_all, p_all)
    return LQRSolution(X=X, U=U, P=P_all, p=p_all)


def lqr_factor(A, B, c, Q, R, QN) -> LQRFactorization:
    """Backward Riccati sweep on the quadratic data only.

    A (..., Nt, n, n), B (..., Nt, n, m), c (..., Nt, n), QN (..., n, n).
    Q and R carry a stage axis like A, or lack it ((..., n, n)) and hold for
    every stage.
    """
    Nt = A.shape[-3]
    Q_t = (lambda t: Q[..., t, :, :]) if Q.dim() == A.dim() else (lambda t: Q)
    R_t = (lambda t: R[..., t, :, :]) if R.dim() == A.dim() else (lambda t: R)
    P = QN
    Ps, Ks, Quu_invs = [QN], [], []
    for t in reversed(range(Nt)):
        A_t, B_t = A[..., t, :, :], B[..., t, :, :]
        BtP = _mT(B_t) @ P
        Quu_inv = _inv(R_t(t) + BtP @ B_t)
        Qux = BtP @ A_t
        K = Quu_inv @ Qux
        P_new = Q_t(t) + _mT(A_t) @ P @ A_t - _mT(Qux) @ K
        P = 0.5 * (P_new + _mT(P_new))
        Ps.append(P)
        Ks.append(K)
        Quu_invs.append(Quu_inv)
    rev = lambda xs: torch.stack(xs[::-1], dim=-3)
    P_all, Ks, Quu_invs = rev(Ps), rev(Ks), rev(Quu_invs)
    return LQRFactorization(
        A=A, B=B, c=c, P=P_all, K=Ks, Quu_inv=Quu_invs,
        F=A - B @ Ks, PC=_mv(P_all[..., 1:, :, :], c),
    )


def resolve_bwd_plain(F, B, K, Quu_inv, PC, q, r, qN):
    """Backward affine sweep of `lqr_resolve`; returns ks (..., Nt, m).

        w = PC_t + p_{t+1};  k_t = Quu_inv_t (r_t + B_t' w);
        p_t = q_t + F_t' w - K_t' r_t,   p_Nt = qN

    The plain version of kernel `riccati_bwd_f32`.
    """
    Nt = F.shape[-3]
    p = qN
    ks = []
    for t in reversed(range(Nt)):
        w = PC[..., t, :] + p
        r_t = r[..., t, :]
        ks.append(_mv(Quu_inv[..., t, :, :], r_t + _mTv(B[..., t, :, :], w)))
        p = q[..., t, :] + _mTv(F[..., t, :, :], w) - _mTv(K[..., t, :, :], r_t)
    return torch.stack(ks[::-1], dim=-2)


def resolve_fwd_plain(F, B, c, K, ks, x0):
    """Forward sweep of `lqr_resolve`; returns (X (..., Nt+1, n), U (..., Nt, m)).

        u_t = -K_t x_t - k_t;  x_{t+1} = F_t x_t + c_t - B_t k_t

    The plain version of kernel `riccati_fwd_f32`.
    """
    Nt = F.shape[-3]
    x = x0
    Xs, Us = [x], []
    for t in range(Nt):
        k = ks[..., t, :]
        Us.append(-_mv(K[..., t, :, :], x) - k)
        x = _mv(F[..., t, :, :], x) + c[..., t, :] - _mv(B[..., t, :, :], k)
        Xs.append(x)
    return torch.stack(Xs, dim=-2), torch.stack(Us, dim=-2)


def lqr_resolve(fact: LQRFactorization, q, r, qN, x0):
    """Solve the LQR with new linear terms against an existing factorization.

    q (..., Nt, n), r (..., Nt, m), qN (..., n), x0 (..., n) ->
    (X (..., Nt+1, n), U (..., Nt, m)).  The plain version of the kernel
    pair behind `lqr_resolve_lanes`.
    """
    ks = resolve_bwd_plain(fact.F, fact.B, fact.K, fact.Quu_inv, fact.PC, q, r, qN)
    return resolve_fwd_plain(fact.F, fact.B, fact.c, fact.K, ks, x0)
