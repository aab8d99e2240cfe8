"""LQR-structured QP solves by Riccati recursion, counterpart of
`ft_mpc_tpu/solvers/riccati.py` (sequential variants).

The stagewise backend keeps the block-banded KKT structure of the MPC QP
and solves it by a Riccati recursion over the horizon:

  * `lqr_solve` (mode 'scan'): the classic backward sweep and forward
    rollout (`lqr_backward_scan`, `lqr_forward`), the independent oracle of
    the tests; mode 'assoc' does both passes as associative scans;
  * `lqr_factor`: the backward sweep on the quadratic data only, done once
    per ADMM phase;
  * `lqr_resolve`: a matvec-only backward and forward sweep against that
    factorization with new linear terms, done every ADMM iteration.  Its two
    halves, `resolve_bwd_plain` and `resolve_fwd_plain`, are the plain
    versions of the two CUDA kernels in `csrc/riccati.cu`
    (`solvers/lanes_riccati.py`).

The associative-scan variants (`lqr_backward_assoc`, `lqr_forward_assoc`,
`lqr_resolve_assoc`, `lqr_factor_assoc`, `lqr_solve(mode='assoc')`) compute
the same recursions with O(log Nt) depth: each is an `_assoc_scan` over the
horizon, whose every level is one batched combine over all its pairs
(the odd/even recursion of `jax.lax.associative_scan`).

Every function takes any leading batch dims: stage data is
(..., Nt, n, n) / (..., Nt, n); the sequential stage loops are Python loops
whose 13x13 / 6x6 products and inverses are batched over the leading dims.
The dtype follows the inputs.
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


# ---------------------------------------------------------------------------
# associative-scan (parallel-in-horizon) variants
# ---------------------------------------------------------------------------


def _assoc_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of `fn` over axis 0 of every leaf of the tuple `elems`.

    `fn(a, b)` combines two tuples of stacked elements, a earlier in scan
    order than b, batched over axis 0 and any other leading dims.  The
    recursion is that of `jax.lax.associative_scan`: combine adjacent pairs,
    scan the half-length sequence, fill in the even positions; with
    `reverse` the sequence is scanned from its end (a suffix scan, where `fn`
    gets the LATER element first), as `associative_scan(reverse=True)` does.
    """
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        reduced = fn(tuple(e[0:-1:2] for e in es), tuple(e[1::2] for e in es))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in es))
        else:
            even = fn(odd, tuple(e[2::2] for e in es))
        even = tuple(torch.cat([e[:1], r], dim=0) for e, r in zip(es, even))
        out = []
        for ev, od in zip(even, odd):
            full = ev.new_empty((n, *ev.shape[1:]))
            full[0::2] = ev
            full[1::2] = od
            out.append(full)
        return tuple(out)

    out = scan(tuple(elems))
    if reverse:
        out = tuple(torch.flip(e, (0,)) for e in out)
    return out


# The scans run over axis 0: stage stacks of matrices (..., Nt, a, b) and of
# vectors (..., Nt, a) move their stage axis there and back.
def _m0(M):
    return M.movedim(-3, 0)


def _v0(v):
    return v.movedim(-2, 0)


def _mats_back(M):
    return M.movedim(0, -3)


def _vecs_back(v):
    return v.movedim(0, -2)


def lqr_backward_assoc(prob: LQRProblem):
    """Parallel-in-horizon backward pass: the value functions V_t for every t
    by one associative scan over value-function elements (A, b, C, eta, J)
    with the combination rule of Sarkka & Garcia-Fernandez (2020).

    Returns (P (..., Nt+1, n, n), p (..., Nt+1, n)), as `lqr_backward_scan`.
    """
    n = prob.A.shape[-1]
    eye = torch.eye(n, dtype=prob.A.dtype, device=prob.A.device)
    A, B, Q, R = map(_m0, (prob.A, prob.B, prob.Q, prob.R))
    c, q, r = map(_v0, (prob.c, prob.q, prob.r))

    # one stage's conditional value message with the control optimized out;
    # convention V(x) = 1/2 x'Jx - eta'x, so eta = -q for a stage cost +q'x
    Rinv = _inv(R)
    C = B @ Rinv @ _mT(B)
    b = c - _mv(B, _mv(Rinv, r))

    def combine(later, earlier):
        # the suffix scan passes the block LATER in time first
        A_j, b_j, C_j, eta_j, J_j = later
        A_i, b_i, C_i, eta_i, J_i = earlier
        M = _inv(eye + C_i @ J_j)
        AjM = A_j @ M
        A_new = AjM @ A_i
        b_new = _mv(AjM, b_i + _mv(C_i, eta_j)) + b_j
        C_new = AjM @ C_i @ _mT(A_j) + C_j
        N_ = _inv(eye + J_j @ C_i)
        eta_new = _mv(_mT(A_i) @ N_, eta_j - _mv(J_j, b_i)) + eta_i
        J_new = _mT(A_i) @ N_ @ J_j @ A_i + J_i
        return (A_new, b_new, C_new, eta_new, J_new)

    # terminal element: V_N(x) = 1/2 x'QN x + qN'x  ->  (0, 0, 0, -qN, QN)
    zM = torch.zeros_like(prob.QN)[None]
    term = (zM, torch.zeros_like(prob.qN)[None], zM, -prob.qN[None], prob.QN[None])
    elems = tuple(torch.cat([e, t], dim=0) for e, t in zip((A, b, C, -q, Q), term))
    _, _, _, etas, Js = _assoc_scan(combine, elems, reverse=True)
    # back to the V(x) = 1/2 x'Px + p'x convention of the sequential sweep
    return _mats_back(Js), -_vecs_back(etas)


def lqr_forward_assoc(prob: LQRProblem, P_all, p_all):
    """Forward rollout as one associative composition of affine maps."""
    K, k, _, _ = _gains_from_value(P_all[..., 1:, :, :], p_all[..., 1:, :], prob.A,
                                   prob.B, prob.c, prob.R, prob.r)
    F = prob.A - prob.B @ K
    f = prob.c - _mv(prob.B, k)

    def compose(e_i, e_j):
        # x -> F_j (F_i x + f_i) + f_j
        F_i, f_i = e_i
        F_j, f_j = e_j
        return (F_j @ F_i, _mv(F_j, f_i) + f_j)

    Fs, fs = _assoc_scan(compose, (_m0(F), _v0(f)))
    X_tail = _mv(_mats_back(Fs), prob.x0[..., None, :]) + _vecs_back(fs)  # x_1..x_Nt
    X = torch.cat([prob.x0[..., None, :], X_tail], dim=-2)
    U = -_mv(K, X[..., :-1, :]) - k
    return X, U


def lqr_resolve_assoc(fact: LQRFactorization, q, r, qN, x0):
    """`lqr_resolve` with both passes as associative scans (O(log Nt) depth).

    Given the factorization the backward pass is the affine recursion
        p_t = F_t' p_{t+1} + g_t,   g_t = q_t + F_t' PC_t - K_t' r_t,
    and the forward pass x_{t+1} = F_t x_t + (c_t - B_t k_t): both are
    compositions of affine maps, each one scan of batched combines.
    """
    Ft_T = _mT(fact.F)
    g = q + _mv(Ft_T, fact.PC) - _mv(_mT(fact.K), r)

    def compose_bwd(later, earlier):
        # the suffix composite applies the earlier map after the later one
        A_l, b_l = later
        A_e, b_e = earlier
        return (A_e @ A_l, _mv(A_e, b_l) + b_e)

    As, bs = _assoc_scan(compose_bwd, (_m0(Ft_T), _v0(g)), reverse=True)
    p = _mv(_mats_back(As), qN[..., None, :]) + _vecs_back(bs)  # p_t, t = 0..Nt-1
    p_next = torch.cat([p[..., 1:, :], qN[..., None, :]], dim=-2)  # p_{t+1}
    ks = _mv(fact.Quu_inv, r + _mv(_mT(fact.B), fact.PC + p_next))

    d = fact.c - _mv(fact.B, ks)

    def compose_fwd(a, b):
        # a earlier, b later: the composite applies b after a
        A_a, b_a = a
        A_b, b_b = b
        return (A_b @ A_a, _mv(A_b, b_a) + b_b)

    Fs, fs = _assoc_scan(compose_fwd, (_m0(fact.F), _v0(d)))
    X_tail = _mv(_mats_back(Fs), x0[..., None, :]) + _vecs_back(fs)  # x_1..x_Nt
    X = torch.cat([x0[..., None, :], X_tail], dim=-2)
    U = -_mv(fact.K, X[..., :-1, :]) - ks
    return X, U


def lqr_factor_assoc(A, B, c, Q, R, QN) -> LQRFactorization:
    """`lqr_factor` with the value-Hessian pass parallel in the horizon.

    P_t comes from `lqr_backward_assoc`; the gains then depend only on
    P_{t+1} per stage, so they are one batched solve over all stages.  Q and
    R carry a stage axis like A, or lack it and hold for every stage.
    """
    Nt, n, m = B.shape[-3:]
    lead = A.shape[:-3]
    Q = Q if Q.dim() == A.dim() else Q[..., None, :, :].expand(*lead, Nt, n, n)
    R = R if R.dim() == A.dim() else R[..., None, :, :].expand(*lead, Nt, m, m)
    kw = dict(dtype=A.dtype, device=A.device)
    prob = LQRProblem(
        A=A, B=B, c=c, Q=Q, q=torch.zeros(*lead, Nt, n, **kw), R=R,
        r=torch.zeros(*lead, Nt, m, **kw), QN=QN, qN=torch.zeros(*lead, n, **kw),
        x0=torch.zeros(*lead, n, **kw),
    )
    P_all, _ = lqr_backward_assoc(prob)
    P_next = P_all[..., 1:, :, :]
    BtP = _mT(B) @ P_next  # B_t' P_{t+1}
    Quu_inv = _inv(R + BtP @ B)
    K = Quu_inv @ (BtP @ A)
    return LQRFactorization(A=A, B=B, c=c, P=P_all, K=K, Quu_inv=Quu_inv,
                            F=A - B @ K, PC=_mv(P_next, c))


def lqr_solve(prob: LQRProblem, mode: str = "scan") -> LQRSolution:
    """Solve the LQR problem exactly.  mode: 'scan' | 'assoc'."""
    if mode == "scan":
        P_all, p_all, _, _ = lqr_backward_scan(prob)
        X, U = lqr_forward(prob, P_all, p_all)
    elif mode == "assoc":
        P_all, p_all = lqr_backward_assoc(prob)
        X, U = lqr_forward_assoc(prob, P_all, p_all)
    else:
        raise ValueError(f"unknown mode {mode}")
    return LQRSolution(X=X, U=U, P=P_all, p=p_all)
