"""The CUDA kernels of ft_mpc_torch against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one (decided when the
test runs).  The file imports no JAX, so on a machine with a card and no JAX
it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: both sides are float32 on the card and differ only in summation
order.  condense rtol 1e-5 (a 15-step recursion of 13-term sums); ADMM x
atol 5e-5 and y atol 5e-4 (`tests/test_lanes.py:61-64`); allocation u atol
2e-3 N (`tests/test_lanes_alloc.py:75-78`); a whole control step u_phys
atol 2e-2 N (`tests/test_lanes.py:174-178`); the Riccati sweeps atol 2e-5 on
O(1) data (`tests/test_stagewise.py:399-401`), over 240 stages too because
the closed loop contracts.  The linearization kernel against the plain
vmap(jacfwd) in the same dtype: float64 rtol 1e-12 (float64 rounding of
one RK4 step and its tangents), float32 rtol 1e-5 (the same few hundred
roundings of 6e-8, taken in another order and with fused multiply-adds),
each of the scale of A, of B and, for the defects, of the states.  The
terminal kernel against `terminal_plain` in the same dtype: float64 1e-12 of
each output's scale; float32 1e-6 (V, the gradient, and the Hessian off the
omega block's diagonal) and 5e-5 of H's scale on that diagonal, where the
PSD shift lands: `_eigmin_sym3`'s arccos amplifies float32 rounding by
1 / sqrt(1 - r^2) where two eigenvalues nearly meet at the scale of the
block (the plain float32 version reads 1e-5 of that scale from float64 on
the same inputs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as sp
from ft_mpc_torch.geometry.scenario import load_bank_snapshot, take_rows, tile_bank
from ft_mpc_torch.ops import linearize as lin
from ft_mpc_torch.ops.dynamics import BodyParams, robot_step
from ft_mpc_torch.ops import terminal as ot
from ft_mpc_torch.solvers import lanes_alloc as la
from ft_mpc_torch.solvers import lanes_condense as lc
from ft_mpc_torch.solvers import lanes_qp as lq
from ft_mpc_torch.solvers import lanes_riccati as lr
from ft_mpc_torch.solvers import riccati as rc
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig, StructuredMPCQP
from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig
from ft_mpc_torch.terminal import poly as tpoly
from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

F32 = torch.float32


@pytest.fixture
def dev():
    """The card; skips where there is none (never decided at import)."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(7)


def np_(t):
    return t.detach().cpu().double().numpy()


@pytest.mark.parametrize("B,Nt", [(300, 15), (2048, 15), (5, 15), (1, 1), (5, 1), (5, 2),
                                  (1, 2), (2, 86), (3, 240)])
def test_condense_kernel_matches_plain(dev, gen, B, Nt):
    """One thread per two columns of S (and one for phi), at most 256 a
    block: Nt = 1 and 2 fill part of one warp, Nt = 86 (259 threads) puts 3
    in a second block, Nt = 240 takes 3 blocks a scenario.  Long horizons
    get a contracting A (as riccati_case): a recursion that grows over 240
    stages leaves its small entries to the summation order."""
    A = (np.eye(13) + 0.08 * gen.standard_normal((B, Nt, 13, 13)) if Nt <= 15 else
         0.95 * np.eye(13) + 0.04 * gen.standard_normal((B, Nt, 13, 13)))
    Bm = 0.1 * gen.standard_normal((B, Nt, 13, 6))
    d = 0.01 * gen.standard_normal((B, Nt, 13))
    args = [torch.as_tensor(x, dtype=F32, device=dev) for x in (A, Bm, d)]
    n0 = lc.condense_lanes.launches
    S, phi = lc.condense_lanes(*args)
    torch.cuda.synchronize()
    assert lc.condense_lanes.launches == n0 + 1
    S_ref, phi_ref = lc.condense_plain(*args)
    np.testing.assert_allclose(np_(S), np_(S_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(phi), np_(phi_ref), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        lc._condense_cuda(args[0].double(), args[1], args[2])


def linearize_case(gen, B, Nt, dtype, device, per_row=False):
    """(params, bank, X, U, u_ref) on B rows of the bench bank: states
    of +-0.3 about hover with unit quaternions, inputs of +-0.5 N, a
    reference one stage longer than the horizon; `per_row` gives each row
    its own mass, inertia and dt (a randomized bank's plant)."""
    bank = tile_bank(load_bank_snapshot(device=device, dtype=dtype), -(-B // 32))
    bank = take_rows(bank, torch.arange(B, device=device))
    params = BodyParams.default(0.1, dtype=dtype, device=device)
    c = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if per_row:
        I = np.stack([np.diag([0.2, 0.3, 0.25] * gen.uniform(0.8, 1.2, 3)) for _ in range(B)])
        params = params._replace(mass=c(16.8 * gen.uniform(0.85, 1.15, B)), inertia=c(I),
                                 inertia_inv=c(np.linalg.inv(I)),
                                 dt=c(gen.uniform(0.08, 0.12, B)))
    q = gen.standard_normal((B, Nt + 1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    X = np.concatenate([0.3 * gen.standard_normal((B, Nt + 1, 9)), q], axis=-1)
    return (params, bank, c(X), c(0.5 * gen.standard_normal((B, Nt, 6))),
            c(gen.standard_normal((Nt + 1, 6))))


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["float64", "float32"])
@pytest.mark.parametrize("B,Nt,per_row", [
    (2048, 15, False),  # the condensed cell
    (256, 15, False),   # its cleanup's K = B/8
    (512, 240, False),  # the stagewise cell
    (64, 240, False),   # its cleanup's K
    (17, 15, False),    # the census's cleanup (B=137): a partly filled last block
    (1, 15, False),
    (1, 240, False),
    (64, 15, True),     # per-row mass, inertia and dt
    (3, 240, True),
])
def test_linearize_kernel_matches_plain(dev, gen, B, Nt, per_row, dtype):
    """One warp a stage, eight stages a block, in the caller's dtype:
    A, B and the defects against vmap(jacfwd) on the same card, contiguous,
    one launch a call and no plain call."""
    args = linearize_case(gen, B, Nt, dtype, dev, per_row)
    n0, p0 = lin.linearize_lanes.launches, lin.linearize_lanes.plain_calls
    out = lin.linearize_lanes(*args, Nt)
    torch.cuda.synchronize()
    assert lin.linearize_lanes.launches == n0 + 1
    assert lin.linearize_lanes.plain_calls == p0
    ref = lin.linearize_plain(*args, Nt)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    # a defect is the difference of two states: its rounding scales with theirs
    scales = (ref[0].abs().max(), ref[1].abs().max(), args[2].abs().max())
    for o, r, s, shape in zip(out, ref, scales,
                              [(B, Nt, 13, 13), (B, Nt, 13, 6), (B, Nt, 13)]):
        assert o.dtype == dtype and tuple(o.shape) == shape and o.is_contiguous()
        assert torch.isfinite(o).all()
        np.testing.assert_allclose(np_(o), np_(r), rtol=0, atol=rtol * float(s))


TOL_TERMINAL_F64 = 1e-12
TOL_TERMINAL_F32 = 1e-6
TOL_TERMINAL_SHIFT_F32 = 5e-5


def terminal_case(gen, B, dtype, device, lead=(), K=None, zero_rows=0, omega=0.1):
    """(term, e): the terminal tables of B rows of the bench bank (committed
    terminal-cache entries: K1 = 8 polynomial and K2 = 12 sqrt-abs terms), cut
    or zero-padded to K = (K1, K2) terms, rows 1..zero_rows given the
    placeholder tables (all zero but app); errors (*lead, B, 9) of 0.3 on
    positions and velocities and `omega` on the omega block (0.1: the PSD
    shift active on most rows and not on some), row 0's omega exactly 0."""
    term = take_rows(tile_bank(load_bank_snapshot(device=device, dtype=dtype), -(-B // 32)),
                     torch.arange(B, device=device)).term
    if K is not None:
        def fit(c, pw, k):
            n = min(k, c.shape[1])
            return (torch.nn.functional.pad(c[:, :n], (0, k - n)).contiguous(),
                    torch.nn.functional.pad(pw[:, :n], (0, 0, 0, k - n)).contiguous())
        poly_c, poly_pow = fit(term.poly_c, term.poly_pow, K[0])
        sqrt_c, sqrt_pow = fit(term.sqrt_c, term.sqrt_pow, K[1])
        term = term._replace(poly_c=poly_c, poly_pow=poly_pow, sqrt_c=sqrt_c,
                             sqrt_pow=sqrt_pow)
    if zero_rows:
        rows = slice(1, 1 + zero_rows)
        term = type(term)(*[t.clone() for t in term])
        for k, t in term._asdict().items():
            if k != "app":
                t[rows] = 0
    e = gen.standard_normal((*lead, B, 9)) * 0.3
    e[..., 6:9] *= omega / 0.3
    e[..., 0, 6:9] = 0.0
    return term, torch.as_tensor(e, dtype=dtype, device=device)


def terminal_gaps(got, ref):
    """Distances of the kernel's outputs from the reference's, each over the
    reference output's largest entry: V, the gradient, the Hessian off the
    omega block's diagonal and on it (where the PSD shift lands)."""
    got, ref = (got,) if torch.is_tensor(got) else got, (ref,) if torch.is_tensor(ref) else ref
    gaps = {}
    for name, g, r in zip(("V", "g", "H"), got, ref):
        d = (g.double() - r.double()).abs()
        s = max(1.0, float(r.abs().max()))
        if name == "H":
            diag = torch.zeros(9, 9, dtype=torch.bool, device=d.device)
            diag[6:, 6:] = torch.eye(3, dtype=torch.bool, device=d.device)
            gaps["H_diag"] = float(d[..., diag].max()) / s
            d = d[..., ~diag]
        gaps[name] = float(d.max()) / s
    return gaps


def terminal_agrees(gaps, dtype, diag_f64=None, plain_diag_f64=None) -> bool:
    """float64: every gap within TOL_TERMINAL_F64.  float32: V, the gradient
    and H off the omega diagonal within TOL_TERMINAL_F32 of the plain
    version; on the diagonal the kernel's distance from the float64 plain
    version within TOL_TERMINAL_SHIFT_F32, or within 4 times the plain
    float32 version's own distance from it."""
    if dtype == torch.float64:
        return max(gaps.values()) <= TOL_TERMINAL_F64
    off = all(v <= TOL_TERMINAL_F32 for k, v in gaps.items() if k != "H_diag")
    if diag_f64 is None:
        return off
    return off and diag_f64 <= max(TOL_TERMINAL_SHIFT_F32, 4 * plain_diag_f64)


def shift_active(term, e):
    """Rows whose omega block the plain version shifts."""
    lam = torch.func.vmap(lambda t, w: tpoly._eigmin_sym3(
        torch.func.hessian(lambda x: tpoly._extra_value(t, x))(w)))
    return lam(term, e[..., 6:9]) < 0


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["float64", "float32"])
@pytest.mark.parametrize("B,lead,derivs,K,zero_rows,omega", [
    (2048, (), True, None, 0, 0.1),     # the fleet cells' assembly
    (2048, (), True, None, 0, 1.0),     # tumbling-size omega errors
    (256, (), True, None, 0, 0.1),      # their cleanup's K = B/8
    (137, (), True, None, 4, 0.1),      # the census cell, with placeholder rows
    (17, (), True, None, 0, 0.1),       # the census's cleanup: a partly filled block
    (1, (), True, None, 0, 0.1),        # the per-scenario path
    (2048, (3,), False, None, 0, 0.1),  # the line search's candidates
    (2048, (3,), False, None, 0, 1.0),
    (137, (3,), False, None, 4, 0.1),
    (1, (3,), False, None, 0, 0.1),
    (64, (), True, (3, 5), 0, 0.1),     # tables other than the bank's
    (64, (), True, (0, 32), 2, 0.1),
    (64, (3,), False, (32, 1), 0, 0.1),
])
def test_terminal_kernel_matches_plain(dev, gen, B, lead, derivs, K, zero_rows, omega, dtype):
    """One thread a row, the rows of P and H through shared memory: V, or
    V, the gradient and the PSD-shifted Hessian, against the plain vmap
    expressions on the same card; one launch a call and no plain call."""
    term, e = terminal_case(gen, B, dtype, dev, lead, K, zero_rows, omega)
    n0, p0 = ot.terminal_lanes.launches, ot.terminal_lanes.plain_calls
    out = ot.terminal_lanes(term, e, derivs=derivs)
    torch.cuda.synchronize()
    assert (ot.terminal_lanes.launches, ot.terminal_lanes.plain_calls) == (n0 + 1, p0)
    ref = ot.terminal_plain(term, e, derivs)
    shapes = [(*lead, B), (*lead, B, 9), (*lead, B, 9, 9)]
    for o, shape in zip((out,) if not derivs else out, shapes):
        assert o.dtype == dtype and tuple(o.shape) == shape and o.is_contiguous()
        assert torch.isfinite(o).all()
    gaps = terminal_gaps(out, ref)
    diag = {}
    if derivs and dtype == F32:
        term64 = type(term)(*[t.double() if t.is_floating_point() else t for t in term])
        ref64 = ot.terminal_plain(term64, e.double(), True)
        diag = dict(diag_f64=terminal_gaps(out, ref64)["H_diag"],
                    plain_diag_f64=terminal_gaps(ref, ref64)["H_diag"])
    assert terminal_agrees(gaps, dtype, **diag), (gaps, diag)
    if derivs and K is None and B >= 17 and omega < 1.0:
        active = shift_active(term, e)
        assert 0 < int(active.sum()) < B


def test_terminal_kernel_launches_in_a_condensed_step(dev):
    """A warm-started condensed step (2 SQP iterations, the cleanup) on 64
    rows: 7 launches (3 assemblies, 3 line searches, the trajectory's cost)
    and no plain call."""
    B, Nt = 64, 15
    cfg = sp.MPCConfig(
        horizon=Nt, sqp_iters=2, newton_iters=3, cleanup_iters=100, cleanup_k=8,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
    )
    traj = generate_trajectory("hover", 0.1, 5)
    xr, ur = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, Nt + 1)
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    bank = _bank(B, dev)
    params = BodyParams.default(0.1, device=dev)
    w = sp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3, device=dev)
    x0_t, x_ref, u_ref = t(x0), t(xr[: Nt + 1]), t(ur[: Nt + 1])
    warm = sp.init_warmstart_batch(params, bank, w, cfg, sp.robot_to_center(bank.r, x0_t),
                                   x_ref, u_ref)
    n0, p0 = ot.terminal_lanes.launches, ot.terminal_lanes.plain_calls
    out = sp.get_control_batch(params, bank, w, cfg, x0_t, x_ref, u_ref, warm)
    torch.cuda.synchronize()
    assert torch.isfinite(out.u_phys).all()
    assert (ot.terminal_lanes.launches - n0, ot.terminal_lanes.plain_calls - p0) == (7, 0)


def admm_case(gen, T, device, B=260, Nt=15, F=32, masked=False):
    """A random QP with its exact metric K^-1 (`exact_kinv`, whose output is
    not exactly symmetric), cold-started as `solve_mpc_qp_lanes` does.
    `masked`: each row keeps a random number of its F facets and pads the
    rest as `_masked_geometry` does (zero rows, offset 1e8)."""
    n = 6 * Nt
    c = lambda a: torch.as_tensor(a, dtype=F32, device=device)
    Hq = gen.standard_normal((B, n, 24))
    hull_A = gen.standard_normal((B, F, 6))
    h_hull = np.abs(gen.standard_normal((B, Nt, F))) + 0.5
    if masked:
        live = np.arange(F)[None, :] < gen.integers(F // 2, F + 1, B)[:, None]
        hull_A = hull_A * live[:, :, None]
        h_hull = np.where(live[:, None, :], h_hull, 1e8)
    qp = StructuredMPCQP(
        H=c(np.einsum("bik,bjk->bij", Hq, Hq) * 0.1 + 2.0 * np.eye(n)),
        g=c(gen.standard_normal((B, n))),
        hull_A=c(hull_A),
        h_hull=c(h_hull),
        G_term=c(gen.standard_normal((B, T, n)) * 0.1),
        h_term=c(np.abs(gen.standard_normal((B, T))) + 0.5),
    )
    rho = c(gen.uniform(1.0, 5.0, B))
    K, _ = lq.build_K(qp, rho, 1e-6)
    zeros = torch.zeros_like
    return [lq.exact_kinv(K), qp.hull_A, qp.h_hull, qp.G_term, qp.h_term, qp.g,
            zeros(qp.g), torch.clamp(qp.h_hull, max=0.0), torch.clamp(qp.h_term, max=0.0),
            zeros(qp.h_hull), zeros(qp.h_term), rho]


@pytest.mark.parametrize("B,Nt,F,T,y_max,design,cluster", [
    (260, 15, 32, 64, 1e3, "registers", 1),  # the main path's shape: 8 warps
    (256, 15, 32, 64, 0.0, "registers", 1),  # the cleanup's batch, hinge prox off
    (3, 15, 20, 37, 1e3, "registers", 1),    # masked facets, a partly filled row tile
    (1, 15, 20, 1, 0.0, "registers", 1),
    (3, 1, 32, 64, 1e3, "registers", 1),     # one stage: one warp, one live column of six
    (1, 1, 20, 37, 0.0, "registers", 1),
    (260, 15, 32, 232, 1e3, "cluster", 1),   # rate rows alone: one block holds it all
    (64, 15, 32, 428, 0.0, "cluster", 1),    # state box alone
    (260, 15, 32, 596, 1e3, "cluster", 2),   # state box and rate rows: two blocks
    (3, 15, 20, 596, 0.0, "cluster", 2),     # masked facets
    (256, 20, 32, 64, 1e3, "cluster", 1),    # longer horizons at T=64
    (256, 38, 32, 64, 0.0, "cluster", 2),
    (256, 40, 32, 64, 1e3, "cluster", 2),
    (64, 60, 32, 64, 1e3, "cluster", 4),
    (16, 80, 32, 64, 0.0, "cluster", 8),
    (4, 2, 20, 2000, 0.0, "cluster", 4),     # two blocks own no stage, only rows
    (8, 90, 32, 64, 1e3, "device", 1),       # beyond the largest cluster
])
def test_admm_kernel_matches_plain(dev, gen, B, Nt, F, T, y_max, design, cluster):
    """admm_f32 keeps K^-1 and G_term in registers for Nt <= 16, F <= 32,
    T <= 64, in the shared memory of a cluster of 1, 2, 4 or 8 blocks where
    they fit (Nt <= 85 at F=32, T=64), and reads them from device memory
    beyond."""
    args = admm_case(gen, T, dev, B=B, Nt=Nt, F=F, masked=F < 32)
    plan = lq.admm_plan(Nt, F, T)
    assert lq.admm_design(Nt, F, T) == design == plan["design"]
    assert plan["cluster"] == cluster
    if design == "cluster":
        assert plan["max_active_clusters"] > 0
    n0 = lq.admm_lanes.launches
    d0 = lq.admm_lanes.launches_by_design[design]
    out = lq.admm_lanes(*args, 1e-6, 1.6, 60, y_max)
    torch.cuda.synchronize()
    assert lq.admm_lanes.launches == n0 + 1
    assert lq.admm_lanes.launches_by_design[design] == d0 + 1
    ref = lq.admm_plain(*[a.contiguous() for a in args], 1e-6, 1.6, 60, y_max)
    assert all(torch.isfinite(r).all() for r in ref)
    np.testing.assert_allclose(np_(out[0]), np_(ref[0]), atol=5e-5)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(np_(o), np_(r), atol=5e-4)


def _bank(rows, device):
    bank = tile_bank(load_bank_snapshot(device=device, dtype=F32), -(-rows // 32))
    return take_rows(bank, torch.arange(rows, device=device))


def alloc_hull(gen, bank, masked):
    """The bank's hull (A, b, mask) as numpy; `masked`: each row keeps a
    random number (0 to all) of its live facets, and F is padded from 32 to
    40 with masked facets, so the hull test stages two chunks of facets."""
    A, b, m = (t.cpu().numpy() for t in (bank.hull_A, bank.hull_b, bank.hull_mask))
    if masked:
        B = m.shape[0]
        keep = gen.integers(0, m.sum(axis=1) + 1)
        m = m * (np.cumsum(m, axis=1) <= keep[:, None])
        A = np.concatenate([A, np.zeros((B, 8, 6), A.dtype)], axis=1)
        b = np.concatenate([b, np.ones((B, 8), b.dtype)], axis=1)
        m = np.concatenate([m, np.zeros((B, 8), m.dtype)], axis=1)
    return A, b, m


@pytest.mark.parametrize("iters", [(60, 40), (1, 1)], ids=["60x40", "1x1"])
@pytest.mark.parametrize("facets", ["snapshot", "masked"])
@pytest.mark.parametrize("B", [1, 3, 17, 512, 2048])
def test_alloc_kernel_matches_plain(dev, gen, B, facets, iters):
    """A group of 16 lanes per scenario, two scenarios a warp: odd B leaves
    an idle group in the last warp, which runs a copy of the last scenario
    and stores nothing.  Rows (31 + 7 i) mod 32 of the snapshot
    start with a double fault, then singles, and from B=17 on hold every
    pattern (one or two dead thrusters, u_ub = 0).  Demands of +-0.5 clip
    about a quarter of the rows and send a few to the fallback.  (Far larger
    demands put rows on the eq_err = 1e-2 fallback threshold, where float32
    summation order decides the branch.)"""
    rows = torch.as_tensor((31 + 7 * np.arange(B)) % 32)
    bank = take_rows(load_bank_snapshot(device="cpu", dtype=F32), rows)
    dead = (bank.u_ub == 0).sum(dim=1)
    assert int(dead[0]) == 2 and (B < 3 or int(dead[1]) == 1)
    wr = gen.uniform(-0.5, 0.5, (B, 6))
    hull = alloc_hull(gen, bank, facets == "masked")
    fista, admm = iters

    def call(device):
        params = BodyParams.default(0.1, device=device)
        b = take_rows(load_bank_snapshot(device=device, dtype=F32), rows.to(device))
        hA, hb, hm = (torch.as_tensor(a, dtype=F32, device=device) for a in hull)
        return la.allocate_thrusters_lanes(
            torch.as_tensor(wr, dtype=F32, device=device), params.D, b.u_ub,
            b.faulty_force_gen, hA, hb, hm, b.gen_G, b.gen_c, b.gen_L, params.max_thrust,
            fista_iters=fista, admm_iters=admm,
        )

    n0 = la.allocate_thrusters_lanes.launches
    out = call(dev)
    torch.cuda.synchronize()
    assert la.allocate_thrusters_lanes.launches == n0 + 1
    ref = call("cpu")
    if B >= 17:
        assert 0 < int(ref.was_clipped.sum()) < B
    np.testing.assert_array_equal(np_(out.was_clipped), np_(ref.was_clipped))
    np.testing.assert_array_equal(np_(out.used_fallback), np_(ref.used_fallback))
    np.testing.assert_allclose(np_(out.u_phys), np_(ref.u_phys), atol=2e-3)


def _step_card_vs_cpu(dev, B, Nt, box=False, cleanup_k=4):
    """One warm-started condensed step on B rows, card (kernels) vs CPU
    (plain); with `box` the reactive.yaml weights of
    tests/test_config_bounds.py (0.5 m/s velocity box, du_max rate rows).
    Returns (card output, CPU output, ADMM launches by design on the card)."""
    cfg = sp.MPCConfig(
        horizon=Nt, sqp_iters=2, newton_iters=3, cleanup_iters=100, cleanup_k=cleanup_k,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
    )
    traj = generate_trajectory("hover", 0.1, max(5, (Nt + 2) * 0.1))
    xr, ur = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, Nt + 1)
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x_ub = np.full(13, 1e8)
    x_ub[3:6] = 0.5
    bounds = dict(x_lb=-x_ub, x_ub=x_ub, du_max=[2.0, 2.0, 2.0, 1.0, 1.0, 1.0]) if box else {}
    outs, by_design = [], None
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, dtype=F32, device=device)
        bank = _bank(B, device)
        params = BodyParams.default(0.1, device=device)
        w = sp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3,
                                         device=device, **bounds)
        x0_t, x_ref, u_ref = t(x0), t(xr[: Nt + 1]), t(ur[: Nt + 1])
        c0 = sp.robot_to_center(bank.r, x0_t)
        warm = sp.init_warmstart_batch(params, bank, w, cfg, c0, x_ref, u_ref)
        launches = lq.admm_lanes.launches
        before = dict(lq.admm_lanes.launches_by_design)
        outs.append(sp.get_control_batch(params, bank, w, cfg, x0_t, x_ref, u_ref, warm))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert lq.admm_lanes.launches > launches
            by_design = {k: v - before[k] for k, v in lq.admm_lanes.launches_by_design.items()}
    assert torch.isfinite(outs[0].u_phys).all()
    np.testing.assert_allclose(np_(outs[0].wrench), np_(outs[1].wrench), atol=2e-2)
    # u_phys where both allocations took the same branches: a wrench on a
    # hull facet meets the hull test's margin, decided there by rounding
    branch = lambda o: torch.stack([o.alloc.was_clipped, o.alloc.used_fallback], 1).cpu()
    same = (branch(outs[0]) == branch(outs[1])).all(dim=1).numpy()
    assert same.sum() >= B - B // 8
    np.testing.assert_allclose(np_(outs[0].u_phys)[same], np_(outs[1].u_phys)[same], atol=2e-2)
    return outs[0], outs[1], by_design


def test_control_step_card_matches_cpu(dev):
    """One warm-started step on 16 rows: card (kernels) vs CPU (plain)."""
    _step_card_vs_cpu(dev, 16, 8)


def test_boxed_control_step_card_matches_cpu(dev):
    """The condensed step with the state box and rate rows at Nt=15 (T=596)
    on 32 rows: every ADMM launch in the cluster design, card vs CPU, and
    the planned stage velocities inside the 0.5 m/s box on both."""
    card, cpu, by_design = _step_card_vs_cpu(dev, 32, 15, box=True, cleanup_k=8)
    # 2 SQP iterations and 2 cleanup phases
    assert by_design["cluster"] == 4 and sum(by_design.values()) == 4
    for out in (card, cpu):
        v = out.warm.X[:, 1:-1, 3:6].abs().amax().item()
        assert v <= 0.5 + 1e-3, v


def riccati_case(gen, B, Nt, device):
    """A random well-posed LQR factorization (float32, on `device`) and linear
    terms with non-zero qN and x0."""
    c = lambda a: torch.as_tensor(a, dtype=F32, device=device)
    A = 0.95 * np.eye(13) + 0.04 * gen.standard_normal((B, Nt, 13, 13))
    Bm = 0.3 * gen.standard_normal((B, Nt, 13, 6))
    d = 0.05 * gen.standard_normal((B, Nt, 13))
    fact = rc.lqr_factor(c(A), c(Bm), c(d), c(0.5 * np.eye(13)), c(0.2 * np.eye(6)),
                         c(np.eye(13)).expand(B, 13, 13))
    lin = [c(gen.standard_normal(sh)) for sh in ((B, Nt, 13), (B, Nt, 6), (B, 13), (B, 13))]
    return fact, lin


@pytest.mark.parametrize("B,Nt", [(64, 240), (8, 240), (512, 240), (70, 240), (64, 61),
                                  (5, 1), (3, 7), (3, 2300)])
def test_riccati_kernels_match_plain(dev, gen, B, Nt):
    """`csrc/riccati.cu` against the plain sweeps: the preparation against
    `riccati_prepare_plain`; the backward and forward sweeps alone
    (`riccati_bwd_lanes`, `riccati_fwd_lanes`, and parts 1 and 2) and fused,
    at the chunk `riccati_plan` gives and at one chunk; the pair through
    `lqr_resolve_lanes` against `lqr_resolve`, with its launches counted by
    design.  Nt = 1 and 7 end inside the kernel's rings, Nt = 240 wraps
    them; at Nt = 2300 the block does not stage the linear terms."""
    f, (q, r, qN, x0) = riccati_case(gen, B, Nt, dev)
    bwd, fwd, prep_k = lr.riccati_bwd_lanes, lr.riccati_fwd_lanes, lr.riccati_prepare_lanes
    by = lr.riccati_split_lanes.launches_by_design
    counts = lambda: (bwd.launches, fwd.launches, prep_k.launches, dict(by))
    plan = lr.riccati_plan(B, Nt)
    design = lr.riccati_design(B, Nt)
    L, C = plan["chunk"], plan["chunks"]
    assert design == plan["design"] == ("chunked" if C > 1 else "sequential")
    assert design == ("chunked" if B <= 320 and Nt > 1 else "sequential")
    assert 1 <= L <= Nt and C == -(-Nt // L) and plan["threads"] == 32 * C
    assert plan["blocks_per_sm"] >= 1 and plan["staged"] == (Nt < 2000)
    plus = lambda n, d, k: {**n, d: n[d] + k}

    n0 = counts()
    ks = bwd(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
    ks_ref = rc.resolve_bwd_plain(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
    X, U = fwd(f.F, f.B, f.c, f.K, ks_ref, x0)
    torch.cuda.synchronize()
    n1 = counts()  # each: a preparation and one sweep
    assert n1 == (n0[0] + 1, n0[1] + 1, n0[2] + 2, plus(n0[3], design, 2))
    X_ref, U_ref = rc.resolve_fwd_plain(f.F, f.B, f.c, f.K, ks_ref, x0)
    assert X.shape == (B, Nt + 1, 13) and U.shape == (B, Nt, 6)
    np.testing.assert_allclose(np_(ks), np_(ks_ref), atol=2e-5)
    np.testing.assert_allclose(np_(X), np_(X_ref), atol=2e-5)
    np.testing.assert_allclose(np_(U), np_(U_ref), atol=2e-5)
    np.testing.assert_array_equal(np_(X[:, 0]), np_(x0))

    for chunk in sorted({L, Nt}):
        rec, psi = lr.riccati_prepare_lanes(f, chunk)
        rec_ref, psi_ref = lr.riccati_prepare_plain(f, chunk)
        np.testing.assert_allclose(np_(rec), np_(rec_ref), rtol=0, atol=1e-5)
        assert (psi is None) == (psi_ref is None) == (chunk == Nt)
        if psi is not None:
            np.testing.assert_allclose(np_(psi), np_(psi_ref), rtol=0, atol=1e-5)
        prep = lr.RiccatiPrep(f, F32, lr.RICCATI_DESIGNS[psi is not None], chunk, rec, psi)
        n1 = counts()
        ks_s = lr.riccati_split_lanes(prep, q, r, qN, x0, parts=1)
        X_s, U_s = lr.riccati_split_lanes(prep, q, r, qN, x0, parts=2, ks=ks_ref)
        X_p, U_p = lr.riccati_split_lanes(prep, q, r, qN, x0)
        torch.cuda.synchronize()
        np.testing.assert_allclose(np_(ks_s), np_(ks_ref), atol=2e-5)
        for got in ((X_s, U_s), (X_p, U_p)):
            np.testing.assert_allclose(np_(got[0]), np_(X_ref), atol=2e-5)
            np.testing.assert_allclose(np_(got[1]), np_(U_ref), atol=2e-5)
            np.testing.assert_array_equal(np_(got[0][:, 0]), np_(x0))
        # parts 1 and 3 count a backward sweep, parts 2 and 3 a forward one
        assert counts() == (n1[0] + 2, n1[1] + 2, n1[2], plus(n1[3], prep.design, 3))

    f64 = rc.LQRFactorization(*(t.double() for t in f))  # float32 inside, cast back
    n2 = counts()
    Xp, Up = lr.lqr_resolve_lanes(f64, q.double(), r.double(), qN.double(), x0.double())
    assert Xp.dtype == torch.float64
    Xr, Ur = rc.lqr_resolve(f, q, r, qN, x0)
    np.testing.assert_allclose(np_(Xp), np_(Xr), atol=2e-5)
    np.testing.assert_allclose(np_(Up), np_(Ur), atol=2e-5)
    # prepared on the fly: one preparation, one fused launch
    assert counts() == (n2[0] + 1, n2[1] + 1, n2[2] + 1, plus(n2[3], design, 1))
    with pytest.raises(ValueError):
        lr.riccati_bwd_lanes(f.F.double(), f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
    with pytest.raises(ValueError):
        lr.riccati_fwd_lanes(f.F, f.B, f.c, f.K, ks_ref[:, :-1] if Nt > 1 else ks_ref[:1], x0)
    with pytest.raises(ValueError):
        lr.riccati_split_lanes(prep, q, r, qN, x0, parts=2)  # the forward sweep reads ks


def test_stagewise_step_card_matches_cpu(dev):
    """One stagewise step (mode 'lanes', worst-2 cleanup) on 8 rows: card
    (sweep kernels) vs CPU (plain sweeps)."""
    B, Nt = 8, 30
    cfg = sp.MPCConfig(
        horizon=Nt, sqp_iters=2, qp_backend="stagewise", cleanup_iters=80, cleanup_k=2,
        stagewise=StagewiseConfig(iters=40, phases=1, rho=50.0, adapt_clip=1.5, mode="lanes"),
    )
    traj = generate_trajectory("hover", 0.1, 30)
    xr, ur = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, Nt + 1)
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 9] = 1.0
    outs = []
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, dtype=F32, device=device)
        bank = _bank(B, device)
        params = BodyParams.default(0.1, device=device)
        w = sp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3,
                                         device=device)
        x0_t, x_ref, u_ref = t(x0), t(xr[: Nt + 1]), t(ur[: Nt + 1])
        warm = sp.init_warmstart_batch(params, bank, w, cfg, sp.robot_to_center(bank.r, x0_t),
                                       x_ref, u_ref)
        assert warm.kinv is None
        launches = (lr.riccati_bwd_lanes.launches, lr.riccati_fwd_lanes.launches,
                    lr.riccati_prepare_lanes.launches)
        outs.append(sp.get_control_batch(params, bank, w, cfg, x0_t, x_ref, u_ref, warm))
        if device.type == "cuda":
            torch.cuda.synchronize()
            # one re-solve a launch of both sweeps; one preparation a phase
            # (2 SQP + 2 cleanup)
            resolves = 2 * 40 + 2 * 80
            assert (lr.riccati_bwd_lanes.launches, lr.riccati_fwd_lanes.launches,
                    lr.riccati_prepare_lanes.launches) == (
                launches[0] + resolves, launches[1] + resolves, launches[2] + 4)
    assert torch.isfinite(outs[0].u_phys).all()
    np.testing.assert_allclose(np_(outs[0].wrench), np_(outs[1].wrench), atol=2e-2)
    branch = lambda o: torch.stack([o.alloc.was_clipped, o.alloc.used_fallback], 1).cpu()
    same = (branch(outs[0]) == branch(outs[1])).all(dim=1).numpy()
    assert same.sum() >= B - 1
    np.testing.assert_allclose(np_(outs[0].u_phys)[same], np_(outs[1].u_phys)[same], atol=2e-2)


def _loop_setup(device, B, Nt):
    cfg = sp.MPCConfig(
        horizon=Nt, sqp_iters=2, newton_iters=3, cleanup_iters=100, cleanup_k=4,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
    )
    traj = generate_trajectory("hover", 0.1, 5)
    xr, ur = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, Nt + 1)
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=device)
    w = sp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3, device=device)
    return (BodyParams.default(0.1, device=device), _bank(B, device), w, cfg, t(x0), t(xr),
            t(ur))


def test_closed_loop_card_matches_cpu_same_state(dev, monkeypatch):
    """3 steps of `batched_rollout_lanes` at B=32 on the card; the CPU port
    takes every step's controller call from the card's state and warm start
    (comparing two loops rolled apart would measure chaos, not the port)."""
    from ft_mpc_torch.sim import env

    B, Nt, steps = 32, 8, 3
    calls = []
    real = env.get_control_batch

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(env, "get_control_batch", recording)
    params, bank, w, cfg, x0, xr, ur = _loop_setup(dev, B, Nt)
    n0 = (lc.condense_lanes.launches, lq.admm_lanes.launches, la.allocate_thrusters_lanes.launches)
    hist = env.batched_rollout_lanes(params, bank, w, cfg, env.SimConfig(steps=steps,
                                     noise_mode="none"), x0, xr, ur)
    torch.cuda.synchronize()
    n1 = (lc.condense_lanes.launches, lq.admm_lanes.launches, la.allocate_thrusters_lanes.launches)
    # per step: condensing 2 + 1 (cleanup), ADMM 2 + 2 (cleanup phases),
    # allocation 1; the warm start condenses once more
    assert tuple(b - a for a, b in zip(n0, n1)) == (3 * steps + 1, 4 * steps, steps)
    assert hist.u_phys.shape == (B, steps, 16) and torch.isfinite(hist.state).all()
    assert len(calls) == steps
    cpu = _loop_setup(torch.device("cpu"), B, Nt)
    for args, out in calls:
        x0_s, xr_s, ur_s, warm = args[4:]
        warm_c = type(warm)(*(None if t is None else t.cpu() for t in warm))
        ref = sp.get_control_batch(*cpu[:4], x0_s.cpu(), xr_s.cpu(), ur_s.cpu(), warm_c)
        np.testing.assert_allclose(np_(out.wrench), np_(ref.wrench), atol=2e-2)
        branch = lambda o: torch.stack([o.alloc.was_clipped, o.alloc.used_fallback], 1).cpu()
        same = (branch(out) == branch(ref)).all(dim=1).numpy()
        assert same.sum() >= B - B // 8
        np.testing.assert_allclose(np_(out.u_phys)[same], np_(ref.u_phys)[same], atol=2e-2)


def test_rollout_refuses_noise_without_generator(dev):
    """On the card as on the CPU: noise is drawn only from a generator the
    caller passes, on the tensors' device."""
    from ft_mpc_torch.geometry.scenario import load_demo_scenario
    from ft_mpc_torch.sim import env

    sc = load_demo_scenario("quadratic", device=dev)
    params = BodyParams.default(0.1, device=dev)
    w = sp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3, device=dev)
    cfg = sp.MPCConfig(horizon=6, sqp_iters=1)
    traj = generate_trajectory("hover", 0.1, 2)
    xr, ur = prepare_center_trajectory(traj, np_(sc.omega_des), 16.8, 0.1, 7)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    x0 = np.zeros(13)
    x0[9] = 1.0
    args = (params, sc, w, cfg, env.SimConfig(steps=2), t(x0), t(xr), t(ur))
    with pytest.raises(ValueError, match="torch.Generator"):
        env.rollout(*args)
    hist = env.rollout(*args, torch.Generator(device=dev).manual_seed(0))
    assert hist.state.device.type == "cuda" and torch.isfinite(hist.state).all()
    assert hist.u_phys.shape == (2, 16)


HULL_MARGIN = 1e-7  # the allocation's hull test: hull_A w_total <= hull_b + 1e-7
FALLBACK_EQ_ERR = 1e-2  # the fallback replaces u only above this equality error


def _flip_on_threshold(bank, out_g, out_c) -> bool:
    """Whether the allocation branches that differ between a card step and
    the CPU step (one row) sit on a threshold: the hull test within float32
    rounding of its margin on either side's wrench, or decided otherwise by
    the exact test; the fallback where the side that kept its u has an
    equality error above half the fallback threshold."""
    hA = (bank.hull_A * bank.hull_mask[..., None]).double().cpu()
    hb = torch.where(bank.hull_mask > 0.5, bank.hull_b, 1e8).double().cpu()
    ff = bank.faulty_force_gen.double().cpu()
    near, side = False, []
    for w in (out_g.wrench, out_c.wrench):
        wt = w.double().cpu() + ff
        slack = torch.einsum("bfi,bi->bf", hA, wt) - hb - HULL_MARGIN
        band = 8 * 2.0 ** -24 * (torch.einsum("bfi,bi->bf", hA.abs(), wt.abs()) + hb.abs())
        near |= bool((slack.abs() <= band).any())
        side.append(bool((slack > 0).any()))
    if bool(out_g.alloc.was_clipped.cpu().ne(out_c.alloc.was_clipped).any()):
        return near or side[0] != side[1]
    kept = out_c if bool(out_g.alloc.used_fallback.any()) else out_g
    return float(kept.alloc.r_prim.max()) > FALLBACK_EQ_ERR / 2


def test_lanes_step_b1_card_matches_cpu(dev):
    """The accuracy harness's lanes leg on the card: `get_control_batch` at
    B=1 with the cleanup at K=1 over 4 rounds, the (10, 11) scenario, three
    chained steps from the reference demo's state; each step also taken by
    the CPU port from the card's state and warm start.  The wrench within
    2e-2, u_phys within 2e-2 where the allocation took the same branches, a
    flip only on a threshold."""
    from torch.utils._pytree import tree_map

    from ft_mpc_torch.benchmarks import accuracy as acc

    _, _, lanes = acc.configs()
    assert (lanes.cleanup_k, lanes.cleanup_rounds) == (1, 4)
    sides = []
    for device in (dev, torch.device("cpu")):
        params, sc, w, xr, ur, x0 = acc.setup(device, F32)
        sides.append((params, tree_map(lambda x: x[None], sc), w, xr, ur, x0))
    params, bank, w, xr, ur, x0 = sides[0]
    c_params, c_bank, c_w = sides[1][:3]
    warm = sp.init_warmstart_batch(params, bank, w, lanes, sp.robot_to_center(bank.r, x0[None]),
                                   xr[:16], ur[:16])
    x = x0[None]
    for step in range(3):
        n0 = (lc.condense_lanes.launches, lq.admm_lanes.launches,
              la.allocate_thrusters_lanes.launches)
        out = sp.get_control_batch(params, bank, w, lanes, x, xr[step : step + 16],
                                   ur[step : step + 16], warm)
        torch.cuda.synchronize()
        n1 = (lc.condense_lanes.launches, lq.admm_lanes.launches,
              la.allocate_thrusters_lanes.launches)
        # condensing 2 + 4 cleanup rounds, ADMM 2 + 4 x 2 cleanup phases, allocation 1
        assert tuple(b - a for a, b in zip(n0, n1)) == (6, 10, 1)
        warm_c = type(warm)(*(None if t is None else t.cpu() for t in warm))
        ref = sp.get_control_batch(c_params, c_bank, c_w, lanes, x.cpu(),
                                   xr[step : step + 16].cpu(), ur[step : step + 16].cpu(),
                                   warm_c)
        assert torch.isfinite(out.u_phys).all() and torch.isfinite(out.warm.X).all()
        np.testing.assert_allclose(np_(out.wrench), np_(ref.wrench), atol=2e-2)
        same = bool((out.alloc.was_clipped.cpu() == ref.alloc.was_clipped).all()
                    and (out.alloc.used_fallback.cpu() == ref.alloc.used_fallback).all())
        if same:
            np.testing.assert_allclose(np_(out.u_phys), np_(ref.u_phys), atol=2e-2)
        else:
            assert _flip_on_threshold(c_bank, out, ref), step
        assert float(out.u_phys[0, 10:12].abs().max()) <= 1e-6
        x = robot_step(params, bank.fault, x, out.u_phys)  # no noise
        warm = sp.shift_warmstart(out.warm, sp.robot_to_center(bank.r, x))


@pytest.mark.parametrize("dtype", [torch.float64, F32], ids=["float64", "float32"])
def test_value_function_card_matches_cpu_float64(dev, dtype):
    """The terminal pipeline's grid of 3131 QPs (healthy, DEFAULT_TUNING, the
    committed entry's eMPC) as one batched `admm_solve` on the card against
    the port's float64 CPU run.  Float64 on the card: V within 1e-8, the
    feasible points equal.  Float32: V within 1e-3 of its scale where both
    are feasible; points decided otherwise have an r_prim within a factor 20
    of the 1e-4 threshold."""
    from ft_mpc_torch.terminal import pipeline as tpl

    # the healthy float32 entry's eMPC: r_in, dt and uimax as the pipeline computes them
    empc = tpl.empc_ingredients(1.0, 1.0, 28.223997436523497, 0.10000000149011612, 5.0,
                                0.09419650192430588)
    pts, V, rp = tpl.value_function_grid(empc, 3, device=dev, dtype=dtype)
    pts_c, V_c, rp_c = tpl.value_function_grid(empc, 3, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(pts, pts_c)
    feas, feas_c = rp < tpl.FEASIBLE_R_PRIM, rp_c < tpl.FEASIBLE_R_PRIM
    assert feas_c.sum() > 100
    if dtype == torch.float64:
        np.testing.assert_array_equal(feas, feas_c)
        np.testing.assert_allclose(V, V_c, rtol=0, atol=1e-8)
    else:
        both = feas & feas_c
        np.testing.assert_allclose(V[both], V_c[both], rtol=0,
                                   atol=1e-3 * np.abs(V_c[both]).max())
        differ = feas != feas_c
        band = np.abs(np.log(np.stack([rp, rp_c])[:, differ] / tpl.FEASIBLE_R_PRIM))
        assert np.all(band.min(axis=0) <= np.log(20.0))


def test_spiraling_mpc_card_matches_cpu(dev):
    """`SpiralingMPC.get_control` (the per-scenario path, no kernel) for one
    step of the healthy float32 plant, card against CPU, at the float32
    end-to-end class."""
    from ft_mpc_torch.api import SpiralingMPC

    x0 = np.zeros(13)
    x0[0:3] = [0.2, -0.1, 0.15]
    x0[6:10] = [0.0, 0.0, 0.0, 1.0]
    x0[10:13] = [0.0, 0.05, 0.5]
    us = []
    for device in (dev, torch.device("cpu")):
        mpc = SpiralingMPC(BodyParams.default(0.1, F32, device))
        mpc.load_trajectory("hover", 3.0)
        n0 = lq.admm_lanes.launches
        us.append(mpc.get_control(x0, 0.0))
        assert lq.admm_lanes.launches == n0
    assert np.isfinite(us[0]).all() and us[0].shape == (16,)
    np.testing.assert_allclose(us[0], us[1], rtol=0, atol=2e-2)


def test_two_shards_on_one_card_equal_per_shard_steps(dev):
    """`sharded_control_step_lanes` on ["cuda:0", "cuda:0"]: each shard is
    `get_control_batch` on its own rows (the same calls on the same card),
    launching the three kernels once per shard as often as one step does."""
    from ft_mpc_torch.parallel import mesh as pm

    B, Nt = 32, 8
    params, bank, w, cfg, x0, xr, ur = _loop_setup(dev, B, Nt)
    xr, ur = xr[: Nt + 1], ur[: Nt + 1]
    mesh = pm.make_scenario_mesh([dev, dev])
    assert mesh.size == 2 and mesh.devices[0] == mesh.devices[1]
    c0 = sp.robot_to_center(bank.r, x0)
    warm = pm.sharded_init_warmstart(mesh, params, bank, w, cfg, c0, xr, ur)
    n0 = (lc.condense_lanes.launches, lq.admm_lanes.launches,
          la.allocate_thrusters_lanes.launches)
    out, metrics = pm.sharded_control_step_lanes(mesh, params, bank, w, cfg, x0, xr, ur, warm)
    torch.cuda.synchronize()
    n1 = (lc.condense_lanes.launches, lq.admm_lanes.launches,
          la.allocate_thrusters_lanes.launches)
    assert tuple(b - a for a, b in zip(n0, n1)) == (2 * 3, 2 * 4, 2 * 1), (n0, n1)
    half = B // 2
    for i, shard in enumerate(out.shards):
        rows = torch.arange(i * half, (i + 1) * half, device=dev)
        own = sp.get_control_batch(params, take_rows(bank, rows), w, cfg, x0[rows], xr, ur,
                                   warm.shards[i])
        for name in ("u_phys", "wrench"):
            np.testing.assert_allclose(np_(getattr(shard, name)), np_(getattr(own, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
    cost = torch.stack([s.info.cost.mean() for s in out.shards]).mean()
    assert float(metrics.mean_cost) == pytest.approx(float(cost), rel=1e-6)
    assert float(metrics.max_r_prim) == max(float(s.info.r_prim.max()) for s in out.shards)
    assert metrics.u_phys.gather().shape == (B, 16)


def _planar_bank(cache_dir, device, rows):
    """Planar healthy, (6) and (2) stuck on, DEFAULT_TUNING, the float32
    plant (misses of an empty cache: the pipeline runs), tiled to `rows`."""
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.geometry.scenario import stack_scenarios
    from ft_mpc_torch.models.planar import planar_body_params, planar_fault
    from ft_mpc_torch.utils.faults import BrokenThruster

    host = planar_body_params(0.1, F32, "cpu")
    scs = [build_scenario_with_terminal(host, planar_fault(f), DEFAULT_TUNING,
                                        cache_dir=cache_dir, device="cpu")
           for f in ([], [BrokenThruster(6, 1.0)], [BrokenThruster(2, 1.0)])]
    bank = tile_bank(stack_scenarios(scs, device=device, dtype=F32).scenarios, -(-rows // 3))
    return planar_body_params(0.1, F32, device), take_rows(bank, torch.arange(rows,
                                                                               device=device))


def test_planar_bank_kernels_match_plain(dev, tmp_path):
    """Kernels 1-3 on the planar bank's own inputs (a degenerate wrench hull
    with equality rows, thrusters 8-15 dead): one condensed step at B=64,
    then each kernel against its plain version on that step's data."""
    B, Nt = 64, 15
    params, bank = _planar_bank(tmp_path, dev, B)
    cfg = sp.MPCConfig(
        horizon=Nt, sqp_iters=2, newton_iters=3, cleanup_iters=100, cleanup_k=8,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
    )
    w = sp.MPCWeights.from_diagonals([1] * 6 + [2] * 3, [0.1] * 3 + [0.01] * 3, device=dev)
    traj = generate_trajectory("hover", 0.1, 5)
    xr, ur = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 14.5, 0.1, Nt + 1)
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13))
    x0[:, 0:2] = rng.uniform(-0.5, 0.5, (B, 2))
    yaw = rng.uniform(-np.pi, np.pi, B)
    x0[:, 8], x0[:, 9] = np.sin(yaw / 2), np.cos(yaw / 2)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    x0, x_ref, u_ref = t(x0), t(xr[: Nt + 1]), t(ur[: Nt + 1])
    warm = sp.init_warmstart_batch(params, bank, w, cfg, sp.robot_to_center(bank.r, x0),
                                   x_ref, u_ref)
    out = sp.get_control_batch(params, bank, w, cfg, x0, x_ref, u_ref, warm)
    torch.cuda.synchronize()
    assert torch.isfinite(out.u_phys).all()
    assert float(out.u_phys[:, 8:].abs().max()) <= 1e-6

    # kernel 1: the stage jacobians of the step's trajectory
    X = torch.cat([sp.robot_to_center(bank.r, x0)[:, None], out.warm.X[:, 1:]], dim=1)
    A, Bm, d = (a.float().contiguous() for a in sp._linearize(params, bank, cfg, X,
                                                              out.warm.U, u_ref))
    S, phi = lc.condense_lanes(A, Bm, d)
    S0, phi0 = lc.condense_plain(A, Bm, d)
    np.testing.assert_allclose(np_(S), np_(S0), rtol=1e-5, atol=1e-5 * float(S0.abs().max()))
    np.testing.assert_allclose(np_(phi), np_(phi0), rtol=1e-5,
                               atol=1e-5 * max(1.0, float(phi0.abs().max())))

    # kernel 2: the condensed QP of that trajectory with its exact metric
    x_ref_b = sp._per_scenario_ref(bank, x_ref, B)
    qp, _, _, _ = sp._assemble_condensed_batch(params, bank, w, cfg, X, out.warm.U, x_ref_b,
                                               u_ref, *sp._masked_geometry(bank))
    rho = out.warm.rho.float()
    K, _ = lq.build_K(qp, rho, cfg.admm.sigma)
    f = lambda a: a.float().contiguous()
    args = [f(lq.exact_kinv(K)), f(qp.hull_A), f(qp.h_hull), f(qp.G_term), f(qp.h_term),
            f(qp.g), torch.zeros_like(f(qp.g)), f(torch.clamp(qp.h_hull, max=0.0)),
            f(torch.clamp(qp.h_term, max=0.0)), f(out.warm.y_hull), f(out.warm.y_term), rho]
    hyper = (cfg.admm.sigma, cfg.admm.alpha, 60, cfg.admm.elastic_y_max)
    got, ref = lq.admm_lanes(*args, *hyper), lq.admm_plain(*args, *hyper)
    for g, r in zip(got, ref):
        assert torch.isfinite(r).all()
        scale = max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= 5e-4 * scale

    # kernel 3: the step's wrenches, card against the CPU's plain version,
    # u compared where both took the same branches (the hull test sits on
    # facets of the degenerate hull)
    def alloc(device):
        b = tree_to(bank, device)
        p = BodyParams(*(x.to(device) for x in params))
        return la.allocate_thrusters_lanes(out.wrench.to(device), p.D, b.u_ub,
                                           b.faulty_force_gen, b.hull_A, b.hull_b,
                                           b.hull_mask, b.gen_G, b.gen_c, b.gen_L,
                                           p.max_thrust)

    n0 = la.allocate_thrusters_lanes.launches
    a_g = alloc(dev)
    assert la.allocate_thrusters_lanes.launches == n0 + 1
    a_c = alloc(torch.device("cpu"))
    branch = lambda o: torch.stack([o.was_clipped, o.used_fallback], 1).cpu()
    same = (branch(a_g) == branch(a_c)).all(dim=1).numpy()
    assert same.sum() >= B - B // 8
    np.testing.assert_allclose(np_(a_g.u_phys)[same], np_(a_c.u_phys)[same], atol=1e-2)
    assert float(a_g.u_phys[:, 8:].abs().max()) <= 1e-6


def tree_to(tree, device):
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.to(device), tree)


def test_bench_entry_on_card(dev):
    """`ft_mpc_torch.benchmarks.bench` at B=2048 on the card, 1 warm-up and 1
    timed window of 10 chained steps: no failed gate (finite outputs,
    max_term_gap <= 0.4, the gap rows within bench.py's pinned set), the
    card named, launches 3 / 5 / 1 a step."""
    from ft_mpc_torch.benchmarks import bench

    rec = bench.main(device=dev, windows=1)
    assert rec["failed_gates"] == []
    assert rec["batch"] == 2048 and rec["pinned_gap_rows"] is not None
    assert rec["card"] == torch.cuda.get_device_name(dev) and rec["power_limit"]
    per = rec["launches_per_step"]
    assert (per["condense_lanes"], per["admm_lanes"], per["allocate_thrusters_lanes"]) == (3, 5, 1)
    assert per["riccati_bwd_lanes"] == per["riccati_prepare_lanes"] == 0
