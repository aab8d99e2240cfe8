"""Attainable-wrench sets by zonotope facet enumeration, counterpart of
`ft_mpc_tpu/geometry/zonotope.py` (host numpy, the same operations in the
same order, so the facet rows come out in the same order).

W = { D u : u_i in [0, f_max] (healthy), u_i = f_fault_i (broken) } is a
zonotope: the Minkowski sum of the segments [0, f_max] D[:, i] over healthy
thrusters, translated by the stuck-on fault wrench.  Every facet normal is
orthogonal to d-1 distinct generator directions: the nullspaces of all
rank-(d-1) subsets, both signs, deduplicated; the offset is the support
function h(n) = n.c0 + sum_i max(0, n.g_i).  A set whose generators span a
proper subspace (a planar craft) recurses in the span's coordinates and
pins the complement with +-equality rows.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np

from ft_mpc_torch.geometry.polytope import Polytope


def _distinct_directions(G: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """Collapse collinear columns of G (d, m) to distinct unit directions."""
    norms = np.linalg.norm(G, axis=0)
    cols = G[:, norms > tol] / norms[norms > tol]
    # Canonical sign: first nonzero component positive.
    out = []
    for v in cols.T:
        idx = np.argmax(np.abs(v) > tol)
        v = v if v[idx] > 0 else -v
        if not any(np.linalg.norm(v - w) < tol for w in out):
            out.append(v)
    return np.array(out).T if out else np.zeros((G.shape[0], 0))


def zonotope_halfspaces(
    center: np.ndarray, generators: np.ndarray, tol: float = 1e-9
) -> Polytope:
    """H-representation of Z = center + sum_i [0, 1] * generators[:, i].

    Args:
        center: (d,) translation.
        generators: (d, m) segment generators.

    Returns:
        Polytope with unit-norm facet rows.
    """
    d = center.shape[0]

    # Degenerate case: generators span a proper subspace (e.g. a planar
    # craft embedded in the 6-d wrench space).  Represent the flat set as
    # facets *within* the span plus +-equality halfspaces pinning the
    # orthogonal complement, by recursing in the span's coordinates.
    if generators.size:
        U, sv, _ = np.linalg.svd(generators)
    else:
        U, sv = np.eye(d), np.zeros(0)
    rank = int(np.sum(sv > tol * max(1.0, sv[0] if sv.size else 1.0)))
    if rank < d:
        span = U[:, :rank].T  # (rank, d) orthonormal rows spanning the set
        null = U[:, rank:].T  # (d - rank, d)
        inner = zonotope_halfspaces(span @ center, span @ generators, tol)
        A_in = inner.A @ span  # lift back
        A_eq = np.vstack([null, -null])
        b_eq = np.concatenate([null @ center, -null @ center])
        return Polytope(
            np.vstack([A_in, A_eq]), np.concatenate([inner.b, b_eq])
        ).normalized()

    if d == 1:
        lo = center[0] + np.minimum(generators[0], 0.0).sum()
        hi = center[0] + np.maximum(generators[0], 0.0).sum()
        return Polytope(np.array([[1.0], [-1.0]]), np.array([hi, -lo]))

    dirs = _distinct_directions(generators, tol)
    k = dirs.shape[1]
    if k < d - 1:
        raise ValueError(
            f"zonotope is degenerate: only {k} distinct directions in R^{d}"
        )

    # All (d-1)-subsets of distinct directions, batched SVD for nullspaces.
    subsets = np.array(list(combinations(range(k), d - 1)))  # (K, d-1)
    S = dirs.T[subsets]  # (K, d-1, d) rows are the chosen directions
    _, sv, Vt = np.linalg.svd(S)
    full_rank = sv[:, -1] > 1e-8 * np.maximum(1.0, sv[:, 0])
    normals = Vt[full_rank, -1, :]  # (K', d) nullspace vectors
    if normals.shape[0] == 0:
        raise ValueError("no facet normals found")

    # Canonical sign: first significantly-nonzero component positive.
    first_idx = np.argmax(np.abs(normals) > tol, axis=1)
    signs = np.sign(normals[np.arange(len(normals)), first_idx])
    normals = normals * signs[:, None]

    normals = np.unique(np.round(normals, 10), axis=0)
    # Both orientations are (potential) facets.
    N = np.vstack([normals, -normals])  # (2K, d)
    # Support function: h(n) = n.c + sum_i max(0, n.g_i)
    proj = N @ generators  # (2K, m)
    b = N @ center + np.maximum(proj, 0.0).sum(axis=1)
    return Polytope(N, b).normalized()


def attainable_wrench_polytope(
    D: np.ndarray,
    max_thrust: float,
    broken: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
) -> Polytope:
    """Attainable generalized-force set under a fault pattern.

    Semantics match `InputBounds.calc_input_bounds`
    (`ft_mpc/controllers/tools/input_bounds.py:43-76`): healthy thrusters
    range over [0, max_thrust]; broken thrusters are pinned to
    intensity * max_thrust.  Note the set *includes* the fault wrench (it is
    the set of total wrenches, controllable + stuck-on).

    Args:
        D: (6, 16) thruster allocation matrix.
        broken: (16,) 0/1 mask, None = all healthy.
        intensity: (16,) stuck-on intensity in [0, 1].
    """
    m = D.shape[1]
    broken = np.zeros(m) if broken is None else np.asarray(broken, dtype=np.float64)
    intensity = (
        np.zeros(m) if intensity is None else np.asarray(intensity, dtype=np.float64)
    )
    healthy = broken < 0.5
    center = D @ (broken * intensity * max_thrust)
    generators = D[:, healthy] * max_thrust
    return zonotope_halfspaces(center, generators)
