"""The port's host geometry and terminal tables against the JAX package.

The same numpy inputs go through `ft_mpc_tpu` and `ft_mpc_torch`, float64:
spiral parameters (1e-12), attainable-wrench zonotopes (padded arrays
exactly equal: the port runs the same numpy operations in the same order),
the batched hull engine (the port's build of the C++ source against the JAX
package's, exactly; the port's numpy path against its engine as facet sets, 1e-9 as
`tests/test_runtime.py` holds them: the numpy path rounds its normals to
10 decimals and the engine takes them from cofactors, not an SVD),
polytope LPs and the MCAIS on the double integrator of
`tests/test_terminal.py:35` (1e-9), quadratic terminal ingredients (1e-10)
and the cross-term tables (1e-12).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from ft_mpc_torch.controllers.spiral_params import SpiralParameters as TSpiral
from ft_mpc_torch.geometry import invariant as tinv
from ft_mpc_torch.geometry import zonotope as tzon
from ft_mpc_torch.geometry.polytope import Polytope as TPolytope
from ft_mpc_torch.ops.dynamics import build_thruster_matrix
from ft_mpc_torch.runtime import native as tnative
from ft_mpc_torch.terminal import poly as tpoly
from ft_mpc_torch.terminal.quadratic import quadratic_terminal_ingredients as t_quad
from ft_mpc_tpu.controllers.spiral_params import SpiralParameters as JSpiral
from ft_mpc_tpu.geometry import invariant as jinv
from ft_mpc_tpu.geometry import zonotope as jzon
from ft_mpc_tpu.geometry.polytope import Polytope as JPolytope
from ft_mpc_tpu.runtime import native as jnative
from ft_mpc_tpu.terminal import poly as jpoly
from ft_mpc_tpu.terminal.quadratic import quadratic_terminal_ingredients as j_quad

D = build_thruster_matrix()
MASS, J = 16.8, np.diag([0.2, 0.3, 0.25])
Q9 = np.array([1, 1, 1, 1, 1, 1, 2, 2, 2.0])
R6 = np.array([0.1, 0.1, 0.1, 0.01, 0.01, 0.01])


def _fault(pattern, intensity=1.0):
    broken = np.zeros(16)
    inten = np.zeros(16)
    broken[list(pattern)] = 1.0
    inten[list(pattern)] = intensity
    return broken, inten


ORBITS = [
    dict(),  # the reference's default orbit
    dict(omega_des=(0.1, -0.25, 0.45), r_dir=(0.6, 0.0, 0.8), f_virt_mag=2.25),
]


@pytest.mark.parametrize("orbit", ORBITS, ids=["default", "searched"])
def test_spiral_parameters_match(orbit):
    fw = D @ (_fault((10, 11))[0] * 3.4)
    a = TSpiral.compute(MASS, J, fw, **orbit)
    b = JSpiral.compute(MASS, J, fw, **orbit)
    for name in ("omega_des", "r_dir", "f_virt", "compensation_force", "r", "M", "beta"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=0, atol=1e-12)


WRENCH_CASES = {
    "healthy": ((), 1.0),
    "single": ((3,), 1.0),
    "double": ((10, 11), 1.0),
    "partial": ((4,), 0.35),
    "dead_pair": ((0, 7), 0.0),
}


@pytest.mark.parametrize("case", list(WRENCH_CASES))
def test_attainable_wrench_polytope_exact(case):
    pattern, intensity = WRENCH_CASES[case]
    broken, inten = _fault(pattern, intensity)
    a = tzon.attainable_wrench_polytope(D, 3.4, broken, inten)
    b = jzon.attainable_wrench_polytope(D, 3.4, broken, inten)
    assert a.num_facets == b.num_facets > 0
    for x, y in zip(a.as_padded(32), b.as_padded(32)):
        np.testing.assert_array_equal(x, y)


def test_zonotope_halfspaces_degenerate_exact():
    """A planar craft: the generators span 3 of the 6 wrench axes, so the
    set is flat; both packages recurse into the span and pin the rest."""
    rng = np.random.default_rng(4)
    G = np.zeros((6, 8))
    G[[0, 1, 5]] = rng.standard_normal((3, 8))
    c = rng.standard_normal(6)
    a = tzon.zonotope_halfspaces(c, G)
    b = jzon.zonotope_halfspaces(c, G)
    assert a.num_facets == b.num_facets > 6
    np.testing.assert_array_equal(a.A, b.A)
    np.testing.assert_array_equal(a.b, b.b)
    # the three complement directions are pinned by +-equality rows
    assert np.sum(np.abs(a.A[:, [2, 3, 4]]).sum(axis=1) > 0.5) >= 6


def _bank_patterns():
    pats = [(), (3,), (10, 11), (0, 5, 12), (12, 13, 14, 15)]  # the last: rank 4
    broken = np.zeros((len(pats) + 1, 16))
    inten = np.zeros((len(pats) + 1, 16))
    for s, p in enumerate(pats):
        broken[s], inten[s] = _fault(p)
    broken[-1], inten[-1] = _fault((4,), 0.35)
    return broken, inten


def test_batched_wrench_hulls_native_matches_jax_native():
    broken, inten = _bank_patterns()
    assert jnative.native_available()
    got = tnative.batched_wrench_hulls(D, 3.4, broken, inten, max_facets=64)
    ref = jnative.batched_wrench_hulls(D, 3.4, broken, inten, max_facets=64)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)
    # the rank-4 row came back empty from the engine and was recomputed
    assert got[2][4].sum() > 0
    assert tnative.lib_path().is_file()


def test_batched_wrench_hulls_numpy_engine():
    broken, inten = _bank_patterns()
    nat = tnative.batched_wrench_hulls(D, 3.4, broken, inten, max_facets=64)
    num = tnative.batched_wrench_hulls(D, 3.4, broken, inten, max_facets=64,
                                       engine="numpy")
    for s in range(len(broken)):
        ref = jzon.attainable_wrench_polytope(D, 3.4, broken[s], inten[s])
        for x, y in zip((num[0][s], num[1][s], num[2][s]), ref.as_padded(64)):
            np.testing.assert_array_equal(x, y)
        n = int(nat[2][s].sum())
        assert n == int(num[2][s].sum())
        rows = lambda A, b: np.hstack([A[:n], b[:n, None]])
        a, b = rows(nat[0][s], nat[1][s]), rows(num[0][s], num[1][s])
        # the same facet set: a one-to-one match of rows within 1e-9
        dist = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
        assert dist.min(axis=1).max() <= 1e-9 and dist.min(axis=0).max() <= 1e-9
        assert len(set(dist.argmin(axis=1))) == n
    with pytest.raises(ValueError):
        tnative.batched_wrench_hulls(D, 3.4, broken, inten, engine="qhull")


def _double_integrator():
    """tests/test_terminal.py:35: a stable closed loop and its constraints."""
    h = 0.5
    Ad = np.array([[1, h], [0, 1]])
    Bd = np.array([[h * h / 2], [h]])
    K = np.array([[0.5, 1.0]])
    C = np.vstack([np.eye(2), -np.eye(2), K, -K])
    d = np.array([1.0, 1.0, 1.0, 1.0, 0.4, 0.4])
    return Ad - Bd @ K, C, d


def test_mcais_and_polytope_lps_match():
    A_cl, C, d = _double_integrator()
    a, b = tinv.mcais(A_cl, C, d), jinv.mcais(A_cl, C, d)
    assert a.num_facets == b.num_facets
    np.testing.assert_allclose(a.A, b.A, rtol=0, atol=1e-9)
    np.testing.assert_allclose(a.b, b.b, rtol=0, atol=1e-9)
    # redundant rows of a stacked set, support values, the largest box
    A2 = np.vstack([C, 0.5 * C, C @ A_cl])
    b2 = np.concatenate([d, d, d])
    ta, ja = TPolytope(A2, b2), JPolytope(A2, b2)
    ra, rb = ta.reduce(), ja.reduce()
    np.testing.assert_allclose(ra.A, rb.A, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ra.b, rb.b, rtol=0, atol=1e-9)
    for v in itertools.product((-1.0, 0.3, 1.0), repeat=2):
        assert abs(a.support(np.array(v)) - b.support(np.array(v))) <= 1e-9
    for fixed in (None, np.array([0.1, -0.05])):
        for x, y in zip(a.largest_contained_box(fixed), b.largest_contained_box(fixed)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-9)
    for x, y in zip(a.chebyshev_center(), b.chebyshev_center()):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-9)
    np.testing.assert_allclose(a.vertices(), b.vertices(), rtol=0, atol=1e-9)
    box_t = TPolytope.from_box([-1, -2], [3, 4])
    box_j = JPolytope.from_box([-1, -2], [3, 4])
    np.testing.assert_array_equal(box_t.A, box_j.A)
    np.testing.assert_array_equal(box_t.b, box_j.b)


@pytest.mark.parametrize("pattern", [(), (10, 11)])
def test_quadratic_terminal_ingredients_match(pattern):
    sp = JSpiral.compute(MASS, J, D @ (_fault(pattern)[0] * 3.4))
    a = t_quad(Q9, R6, sp.M, [1.0, 1.0, 1.0], 0.1, time_scaling=5.0)
    b = j_quad(Q9, R6, sp.M, [1.0, 1.0, 1.0], 0.1, time_scaling=5.0)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(a[3].A, b[3].A)
    np.testing.assert_array_equal(a[3].b, b[3].b)


@pytest.mark.parametrize("prefactor_all", [True, False])
def test_cross_term_tables_and_assembly_match(prefactor_all):
    sp = JSpiral.compute(MASS, J, D @ (_fault((10, 11))[0] * 3.4))
    Minv = np.linalg.inv(sp.M)
    qt = float(np.linalg.norm(Minv.T @ np.diag(R6) @ Minv))
    args = (MASS, J, sp.r, sp.omega_des, np.diag(Q9), np.array([1.0, 0.8, 1.2]), qt, 0.37)
    for x, y in zip(tpoly.cross_term_tables(*args, prefactor_all=prefactor_all),
                    jpoly.cross_term_tables(*args, prefactor_all=prefactor_all)):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(3)
    P9 = rng.standard_normal((9, 9))
    P9 = P9 @ P9.T
    a = tpoly.assemble_terminal_poly(P9, np.ones(9), 0.5, *args, prefactor_all=prefactor_all)
    b = jpoly.assemble_terminal_poly(P9, np.ones(9), 0.5, *args, prefactor_all=prefactor_all)
    assert a.poly_c.shape == (tpoly.MAX_POLY_TERMS,) and a.sqrt_c.shape == (tpoly.MAX_SQRT_TERMS,)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    q = tpoly.quadratic_terminal(P9, np.ones(9), 0.5)
    for x, y in zip(q, jpoly.quadratic_terminal(P9, np.ones(9), 0.5)):
        np.testing.assert_array_equal(x, y)
    assert tpoly.SQRTABS_APP == jpoly.SQRTABS_APP
