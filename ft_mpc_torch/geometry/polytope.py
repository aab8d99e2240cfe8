"""Host-side polytope math (numpy + scipy), counterpart of
`ft_mpc_tpu/geometry/polytope.py`: the same functions on the same float64
arrays, so a polytope built here equals the JAX package's row for row.

Redundancy removal (`reduce`) is one HiGHS LP per row; `as_padded` gives
fixed-shape (A, b, mask) arrays so polytopes of varying facet count stack
along a scenario axis.  Off the hot path: runs once per fault pattern when
a scenario bank is built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.optimize import linprog
from scipy.spatial import ConvexHull, HalfspaceIntersection


@dataclass
class Polytope:
    """Halfspace representation {x : A x <= b}."""

    A: np.ndarray
    b: np.ndarray

    def __post_init__(self):
        self.A = np.asarray(self.A, dtype=np.float64)
        self.b = np.asarray(self.b, dtype=np.float64).reshape(-1)
        assert self.A.shape[0] == self.b.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    @property
    def num_facets(self) -> int:
        return self.A.shape[0]

    @classmethod
    def from_box(cls, lower, upper) -> "Polytope":
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        n = lower.shape[0]
        A = np.vstack([np.eye(n), -np.eye(n)])
        b = np.concatenate([upper, -lower])
        return cls(A, b)

    @classmethod
    def from_vertices(cls, vertices) -> "Polytope":
        hull = ConvexHull(np.asarray(vertices, dtype=np.float64))
        eq = np.unique(np.round(hull.equations, 12), axis=0)
        return cls(eq[:, :-1], -eq[:, -1])

    def normalized(self) -> "Polytope":
        """Scale each row so ||A_i|| = 1 (improves solver conditioning)."""
        norms = np.linalg.norm(self.A, axis=1)
        norms = np.where(norms < 1e-12, 1.0, norms)
        return Polytope(self.A / norms[:, None], self.b / norms)

    def contains(self, x, tol: float = 1e-9) -> bool:
        return bool(np.all(self.A @ np.asarray(x) <= self.b + tol))

    def chebyshev_center(self) -> tuple[np.ndarray, float]:
        """Center and radius of the largest inscribed ball (one LP)."""
        norms = np.linalg.norm(self.A, axis=1)
        # max r  s.t.  A x + ||A_i|| r <= b   ->  linprog minimizes, so use -r.
        c = np.zeros(self.dim + 1)
        c[-1] = -1.0
        A_ub = np.hstack([self.A, norms[:, None]])
        res = linprog(c, A_ub=A_ub, b_ub=self.b, bounds=[(None, None)] * self.dim + [(0, None)])
        if not res.success:
            raise RuntimeError(f"chebyshev_center LP failed: {res.message}")
        return res.x[:-1], float(res.x[-1])

    def largest_contained_box(
        self, fixed_center: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Largest-volume axis-aligned box inside the polytope.

        Returns (center, half_widths). Maximizes sum(log w) subject to
        A c + |A| w <= b -- the log-volume program of the reference's
        `MyPolytope.largest_contained_box` (`ft_mpc/util/polytope.py:37-63`),
        solved with SLSQP seeded at the Chebyshev ball instead of a
        cvxpy/exponential-cone build.  With `fixed_center`, only the
        half-widths are optimized (the reference's `fixed_point` mode).
        """
        from scipy.optimize import minimize

        Aabs = np.abs(self.A)
        c0, r0 = self.chebyshev_center()
        n = self.dim
        w0 = np.full(n, max(r0, 1e-6) / np.sqrt(n))

        if fixed_center is not None:
            c_fix = np.asarray(fixed_center, dtype=np.float64)
            slack = self.b - self.A @ c_fix

            def neg_logvol(w):
                return -np.sum(np.log(np.maximum(w, 1e-12)))

            def grad(w):
                return -1.0 / np.maximum(w, 1e-12)

            cons = {"type": "ineq", "fun": lambda w: slack - Aabs @ w,
                    "jac": lambda w: -Aabs}
            res = minimize(neg_logvol, w0, jac=grad, constraints=[cons],
                           bounds=[(1e-12, None)] * n, method="SLSQP",
                           options={"maxiter": 200, "ftol": 1e-12})
            return c_fix, np.maximum(res.x, 0.0)

        def neg_logvol(z):
            return -np.sum(np.log(np.maximum(z[n:], 1e-12)))

        def grad(z):
            g = np.zeros(2 * n)
            g[n:] = -1.0 / np.maximum(z[n:], 1e-12)
            return g

        J = np.hstack([self.A, Aabs])
        cons = {"type": "ineq", "fun": lambda z: self.b - J @ z,
                "jac": lambda z: -J}
        z0 = np.concatenate([c0, w0])
        res = minimize(neg_logvol, z0, jac=grad, constraints=[cons],
                       bounds=[(None, None)] * n + [(1e-12, None)] * n,
                       method="SLSQP", options={"maxiter": 300, "ftol": 1e-12})
        z = res.x
        return z[:n], np.maximum(z[n:], 0.0)

    def vertices(self) -> np.ndarray:
        """V-representation via halfspace intersection about the Chebyshev center."""
        center, radius = self.chebyshev_center()
        if radius <= 0:
            raise RuntimeError("polytope has empty interior; cannot enumerate vertices")
        halfspaces = np.hstack([self.A, -self.b[:, None]])
        hs = HalfspaceIntersection(halfspaces, center)
        return hs.intersections

    def support(self, direction: np.ndarray) -> float:
        """max_x { d^T x : x in P } via one LP."""
        res = linprog(-np.asarray(direction), A_ub=self.A, b_ub=self.b,
                      bounds=[(None, None)] * self.dim)
        if not res.success:
            raise RuntimeError(f"support LP failed: {res.message}")
        return float(-res.fun)

    def reduce(self, tol: float = 1e-9) -> "Polytope":
        """Remove redundant constraints (LP per row, HiGHS)."""
        mask_nonzero = np.linalg.norm(self.A, axis=1) > 1e-12
        A = self.A[mask_nonzero]
        b = self.b[mask_nonzero]
        keep = np.ones(A.shape[0], dtype=bool)
        for i in range(A.shape[0]):
            others = keep.copy()
            others[i] = False
            res = linprog(
                -A[i],
                A_ub=np.vstack([A[others], A[i][None, :]]),
                b_ub=np.concatenate([b[others], [b[i] + 1.0]]),
                bounds=[(None, None)] * A.shape[1],
            )
            if res.success and -res.fun <= b[i] + tol:
                keep[i] = False  # redundant
        return Polytope(A[keep], b[keep])

    def minkowski_subtract_ball(self, r: float) -> "Polytope":
        """P minus the ball {||x|| <= r}: each facet moves in by r ||A_i||."""
        return Polytope(self.A, self.b - np.linalg.norm(self.A, axis=1) * r)

    def minkowski_add_vector(self, v: np.ndarray) -> "Polytope":
        """P plus {v}: translate by v (exact in H-rep: b += A @ v)."""
        return Polytope(self.A, self.b + self.A @ np.asarray(v))

    def set_subtraction_along_vector(self, v: np.ndarray) -> "Polytope":
        """Shrink by the segment [-v, v]:  b -= |A @ v|."""
        return Polytope(self.A, self.b - np.abs(self.A @ np.asarray(v)))

    def transform_input(self, M: np.ndarray) -> "Polytope":
        """{y : A (M y) <= b} -- the preimage of P under x = M y."""
        return Polytope(self.A @ M, self.b)

    def as_padded(self, max_facets: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fixed-shape (A, b, mask) for device-side batching.

        Padded rows are 0 x <= 1 (always satisfied) with mask 0.
        """
        n = self.num_facets
        if n > max_facets:
            raise ValueError(f"polytope has {n} facets > max_facets={max_facets}")
        A = np.zeros((max_facets, self.dim))
        b = np.ones(max_facets)
        mask = np.zeros(max_facets)
        A[:n] = self.A
        b[:n] = self.b
        mask[:n] = 1.0
        return A, b, mask
