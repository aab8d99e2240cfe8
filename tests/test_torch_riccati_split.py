"""The Riccati re-solve kernel (`csrc/riccati.cu`, namespace
split) on the CPU: its per-phase preparation and the algebra of its
chunked sweeps, against the plain sweeps `resolve_bwd_plain` and
`resolve_fwd_plain`.

`split_resolve` below mirrors the kernel's algebra in plain torch on the
prepared records: the horizon cut into chunks of L stages, each chunk's
recursion from a zero carry (pass 1), a walk over the chunk boundaries
through the transfer matrices Psi_c = F_{t1-1} ... F_{t0}, each chunk again
from its true carry (pass 2), for the backward and then the forward sweep.
It is the oracle of what the kernel computes, kept here and not in the
package (the package's plain version of the kernel is the sequential pair).
The kernel itself runs only on the card (`tests/test_torch_cuda.py`).

Inputs are made with numpy from a seed: random well-posed factorizations
from `lqr_factor` (as `tests/test_torch_cuda.py:riccati_case`), and the
factorization and linear terms a stagewise lanes solve hands its re-solve
on snapshot rows at Nt=240.  Tolerances, relative to each output's scale
(max |ref|, at least 1): float64 1e-10 (the same recursion summed in
another order); float32 2e-5 (`tests/test_stagewise.py:399-401`'s class).
The path's closed loop does not contract: over its 240 stages the
transfer matrix's spectral radius reaches 7.06, over a chunk of 15 stages
its 2-norm 5.9, so the walk amplifies rounding as the sequential sweep does,
no more.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.ops.dynamics import BodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center
from ft_mpc_torch.solvers import lanes_riccati as lr
from ft_mpc_torch.solvers import mpc_qp_stagewise as tsw
from ft_mpc_torch.solvers import riccati as rc
from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory
from torch_parity import F64, gentle_states, load_flat, torch_bank

torch.set_num_threads(1)

N, M = 13, 6
F32 = torch.float32
# (Nt, L): one chunk, several (a last chunk shorter than L where L does not
# divide Nt), and a chunk a stage
CHUNKINGS = [(240, 240), (240, 15), (240, 11), (240, 1), (61, 61), (61, 4), (61, 1),
             (7, 7), (7, 3), (7, 1), (1, 1)]


def riccati_case(rng, B, Nt):
    """A random well-posed LQR factorization (float64) and linear terms with
    non-zero qN and x0."""
    c = lambda a: torch.as_tensor(a, dtype=F64)
    A = 0.95 * np.eye(N) + 0.04 * rng.standard_normal((B, Nt, N, N))
    Bm = 0.3 * rng.standard_normal((B, Nt, N, M))
    d = 0.05 * rng.standard_normal((B, Nt, N))
    fact = rc.lqr_factor(c(A), c(Bm), c(d), c(0.5 * np.eye(N)), c(0.2 * np.eye(M)),
                         c(np.eye(N)).expand(B, N, N))
    lin = [c(rng.standard_normal(sh)) for sh in ((B, Nt, N), (B, Nt, M), (B, N), (B, N))]
    return fact, lin


def unpack(rec):
    """The record's sections (`lanes_riccati.REC_OFFSETS`) as blocks."""
    o = lr.REC_OFFSETS
    B, Nt = rec.shape[:2]
    sec = lambda name, *shape: rec[..., o[name]:o[name] + int(np.prod(shape))].reshape(
        B, Nt, *shape)
    return dict(Quu_inv=sec("Quu_inv", M, M), BPC=sec("BPC", M), FPC=sec("FPC", N),
                Ft=sec("Ft", N, N), Bt=sec("Bt", M, N), K=sec("K", M, N), F=sec("F", N, N),
                c=sec("c", N))


def mv(Mt, v):
    return (Mt @ v.unsqueeze(-1)).squeeze(-1)


def mTv(Mt, v):
    return (v.unsqueeze(-2) @ Mt).squeeze(-2)


def split_resolve(rec, psi, L, q, r, qN, x0):
    """The split re-solve on prepared records: (ks, X, U)."""
    s = unpack(rec)
    F, Bm, K, Qi = s["F"], s["Bt"].transpose(-1, -2), s["K"], s["Quu_inv"]
    np.testing.assert_array_equal(s["Ft"].numpy(), F.transpose(-1, -2).numpy())
    B, Nt = rec.shape[:2]
    chunks = [(t0, min(t0 + L, Nt)) for t0 in range(0, Nt, L)]
    C = len(chunks)
    assert (psi is None) == (C == 1)
    a = q + s["FPC"] - mTv(K, r)  # carry-free term of p_t = F_t' p_{t+1} + a_t

    def bwd_chunk(t0, t1, p, ks=None):
        for t in reversed(range(t0, t1)):
            if ks is not None:
                ks[:, t] = mv(Qi[:, t], r[:, t] + s["BPC"][:, t] + mTv(Bm[:, t], p))
            p = a[:, t] + mTv(F[:, t], p)
        return p

    d = [bwd_chunk(t0, t1, torch.zeros_like(qN)) for t0, t1 in chunks]
    ends = [None] * C
    ends[-1] = qN
    for ci in range(C - 1, 0, -1):
        ends[ci - 1] = mTv(psi[:, ci], ends[ci]) + d[ci]
    ks = torch.empty((B, Nt, M), dtype=rec.dtype)
    for (t0, t1), p in zip(chunks, ends):
        bwd_chunk(t0, t1, p, ks)

    g = s["c"] - mv(Bm, ks)  # carry-free term of x_{t+1} = F_t x_t + g_t

    def fwd_chunk(t0, t1, x, X=None, U=None):
        for t in range(t0, t1):
            if X is not None:
                X[:, t] = x
                U[:, t] = -mv(K[:, t], x) - ks[:, t]
            x = mv(F[:, t], x) + g[:, t]
        return x

    e = [fwd_chunk(t0, t1, torch.zeros_like(x0)) for t0, t1 in chunks]
    starts = [x0]
    for ci in range(C - 1):
        starts.append(mv(psi[:, ci], starts[ci]) + e[ci])
    X = torch.empty((B, Nt + 1, N), dtype=rec.dtype)
    U = torch.empty((B, Nt, M), dtype=rec.dtype)
    for (t0, t1), x in zip(chunks, starts):
        x = fwd_chunk(t0, t1, x, X, U)
    X[:, Nt] = x
    return ks, X, U


def plain_pair(f, q, r, qN, x0):
    ks = rc.resolve_bwd_plain(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
    return (ks, *rc.resolve_fwd_plain(f.F, f.B, f.c, f.K, ks, x0))


def assert_close(got, ref, dtype):
    for name, a, b in zip(("ks", "X", "U"), got, ref):
        a, b = a.double().numpy(), b.double().numpy()
        atol = (1e-10 if dtype == F64 else 2e-5) * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def check_split(fact, lin, L, dtype):
    f = rc.LQRFactorization(*(t.to(dtype).contiguous() for t in fact))
    q, r, qN, x0 = (t.to(dtype) for t in lin)
    rec, psi = lr.riccati_prepare_plain(f, L)
    assert rec.dtype == dtype and rec.shape == (*f.F.shape[:2], lr.REC)
    assert_close(split_resolve(rec, psi, L, q, r, qN, x0), plain_pair(f, q, r, qN, x0), dtype)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("Nt,L", CHUNKINGS)
def test_split_algebra_matches_plain_sweeps(Nt, L, dtype):
    rng = np.random.default_rng(100 + Nt + L)
    fact, lin = riccati_case(rng, 3, Nt)
    check_split(fact, lin, L, dtype)


def test_prepare_plain_layout():
    """Every record section is the factorization's block or its product
    with PC, the padding zero; psi the chunks' ordered products."""
    rng = np.random.default_rng(5)
    (f, _) = riccati_case(rng, 2, 10)
    rec, psi = lr.riccati_prepare_plain(f, 4)
    s = unpack(rec)
    for name in ("Quu_inv", "K", "F", "c"):
        np.testing.assert_array_equal(s[name].numpy(), getattr(f, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(s["Ft"].numpy(), f.F.transpose(-1, -2).numpy())
    np.testing.assert_array_equal(s["Bt"].numpy(), f.B.transpose(-1, -2).numpy())
    np.testing.assert_allclose(s["FPC"].numpy(),
                               np.einsum("btij,bti->btj", f.F.numpy(), f.PC.numpy()),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(s["BPC"].numpy(),
                               np.einsum("btia,bti->bta", f.B.numpy(), f.PC.numpy()),
                               rtol=0, atol=1e-13)
    used = np.zeros(lr.REC, dtype=bool)
    for name, o in lr.REC_OFFSETS.items():
        used[o:o + s[name][0, 0].numel()] = True
    assert not rec[..., ~torch.as_tensor(used)].any()
    assert all(o % 4 == 0 for o in lr.REC_OFFSETS.values()) and lr.REC % 4 == 0
    assert psi.shape == (2, 3, N, N)  # chunks [0, 4), [4, 8), [8, 10)
    Fn = f.F.numpy()
    for ci, (t0, t1) in enumerate(((0, 4), (4, 8), (8, 10))):
        want = np.eye(N)[None]
        for t in range(t0, t1):
            want = Fn[:, t] @ want
        np.testing.assert_allclose(psi[:, ci].numpy(), want, rtol=0, atol=1e-13)
    assert lr.riccati_prepare_plain(f, 10)[1] is None


@pytest.fixture(scope="module")
def captured():
    """The factorization (float64, before the re-solve's float32 cast) and
    the last linear terms a stagewise lanes solve hands its re-solve: the
    snapshot's healthy, single- and double-fault rows at Nt=240, from the
    port's own assembly (`spiraling._assemble_stagewise`)."""
    Nt = 240
    rows = [0, 3, 22]
    bank = torch_bank(load_flat(rows))
    params = BodyParams.default(0.1, dtype=F64, device="cpu")
    w = tsp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3,
                                      dtype=F64, device="cpu")
    cfg = tsp.MPCConfig(horizon=Nt, sqp_iters=1, qp_backend="stagewise",
                        stagewise=tsw.StagewiseConfig(iters=3, rho=50.0, mode="lanes"))
    traj = generate_trajectory("hover", 0.1, (Nt + 2) * 0.1)
    x_ref, u_ref = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1,
                                             Nt + 1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    x_ref, u_ref = t(x_ref[: Nt + 1]), t(u_ref[: Nt + 1])
    c0 = robot_to_center(bank.r, t(gentle_states(len(rows))))
    warm = tsp.init_warmstart(params, bank, cfg, c0)
    qp, _ = tsp._assemble_stagewise(params, bank, w, cfg, warm.X, warm.U,
                                    tsp._per_scenario_ref(bank, x_ref, len(rows)), u_ref,
                                    *tsp._masked_geometry(bank))
    seen = {}
    real_prep, real_resolve = tsw.prepare_resolve, tsw.lqr_resolve_lanes

    def prep(fact):
        seen["fact"] = fact
        return real_prep(fact)

    def resolve(fact, *lin):
        seen["lin"] = lin
        return real_resolve(fact, *lin)

    tsw.prepare_resolve, tsw.lqr_resolve_lanes = prep, resolve
    try:
        tsw.solve_mpc_qp_stagewise_lanes(qp, cfg.stagewise)
    finally:
        tsw.prepare_resolve, tsw.lqr_resolve_lanes = real_prep, real_resolve
    return seen["fact"], seen["lin"]


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("L", [240, 15, 11])
def test_split_algebra_on_a_captured_stagewise_qp(captured, L, dtype):
    fact, lin = captured
    assert fact.F.dtype == F64 and fact.F.shape == (3, 240, N, N)
    check_split(fact, lin, L, dtype)


def test_resolve_lanes_takes_a_preparation_on_the_cpu():
    """On the CPU `prepare_resolve` only casts (no launch, no records), and
    `lqr_resolve_lanes` gives the same on the preparation as on the
    factorization it was made from."""
    rng = np.random.default_rng(9)
    fact, (q, r, qN, x0) = riccati_case(rng, 2, 12)
    counts = lambda: (lr.riccati_prepare_lanes.launches, lr.riccati_bwd_lanes.launches,
                      lr.riccati_fwd_lanes.launches)
    n0 = counts()
    prep = lr.prepare_resolve(fact)
    assert prep.design == "plain" and prep.rec is None and prep.dtype == F64
    assert prep.fact.F.dtype == F32
    X1, U1 = lr.lqr_resolve_lanes(prep, q, r, qN, x0)
    X2, U2 = lr.lqr_resolve_lanes(fact, q, r, qN, x0)
    assert counts() == n0
    assert X1.dtype == F64
    np.testing.assert_array_equal(X1.numpy(), X2.numpy())
    np.testing.assert_array_equal(U1.numpy(), U2.numpy())


def test_split_launchers_refuse_cpu_tensors():
    rng = np.random.default_rng(4)
    fact, (q, r, qN, x0) = riccati_case(rng, 1, 6)
    f = rc.LQRFactorization(*(t.float() for t in fact))
    with pytest.raises(ValueError, match="riccati_prepare_lanes: tensor on cpu"):
        lr.riccati_prepare_lanes(f, 3)
    rec, psi = lr.riccati_prepare_plain(f, 3)
    prep = lr.RiccatiPrep(f, F32, "chunked", 3, rec, psi)
    with pytest.raises(ValueError, match="riccati_split_lanes: tensor on cpu"):
        lr.riccati_split_lanes(prep, *(t.float() for t in (q, r, qN, x0)))
