"""Maximal constrained admissible invariant sets (MCAIS), counterpart of
`ft_mpc_tpu/geometry/invariant.py` (host numpy + HiGHS).

For a stable closed loop x+ = A_cl x with constraints C x <= d, the maximal
admissible set O_inf = { x : C A_cl^k x <= d for all k >= 0 } by the
Gilbert-Tan iteration: add the layers C A_cl^k until the next one is
redundant (support LPs over the current polytope), then drop redundant rows.
"""

from __future__ import annotations

import numpy as np

from ft_mpc_torch.geometry.polytope import Polytope


def mcais(A_cl: np.ndarray, C: np.ndarray, d: np.ndarray, max_iter: int = 200,
          tol: float = 1e-9) -> Polytope:
    """Maximal admissible invariant set for x+ = A_cl x, {Cx <= d}.

    Requires A_cl strictly stable (else the iteration may not terminate;
    bounded by max_iter with a warning margin).
    """
    A_cl = np.asarray(A_cl, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64).reshape(-1)

    rows = [C.copy()]
    rhs = [d.copy()]
    Ck = C.copy()
    for _ in range(max_iter):
        Ck = Ck @ A_cl  # C A_cl^{k+1}
        current = Polytope(np.vstack(rows), np.concatenate(rhs))
        # Is every new row already implied? max_{x in current} (Ck_i x) <= d_i
        redundant = True
        for i in range(Ck.shape[0]):
            if current.support(Ck[i]) > d[i] + tol:
                redundant = False
                break
        if redundant:
            poly = current.reduce()
            return poly
        rows.append(Ck.copy())
        rhs.append(d.copy())
    raise RuntimeError(
        f"mcais did not converge in {max_iter} iterations (A_cl stable?)"
    )
