"""Quadratic terminal cost + box terminal set (host numpy/scipy, per fault
class), counterpart of `ft_mpc_tpu/terminal/quadratic.py`.

  * Translational part: per-axis double integrator (position, velocity)
    discretized at `time_scaling * dt`, cost-to-go from the discrete
    algebraic Riccati equation.
  * Rotational part: discrete Lyapunov cost of the k_omega feedback,
        A_om = I - k_omega dt
        Q_om = Q[6:9] + 2 ||Qu_tilde|| k_omega^T k_omega
        P_om solves A_om P A_om^T - P + Q_om = 0.
  * The terminal set is the product of per-axis (pos, vel) boxes and an
    omega box.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as la

from ft_mpc_torch.geometry.polytope import Polytope


def _dare_double_integrator(h: float, q_pos: float, q_vel: float, r_in: float):
    """Cost-to-go of the ZOH-discretized double integrator."""
    Ad = np.array([[1.0, h], [0.0, 1.0]])
    Bd = np.array([[0.5 * h * h], [h]])
    Q = np.diag([q_pos, q_vel])
    R = np.array([[r_in]])
    P = la.solve_discrete_are(Ad, Bd, Q, R)
    return P


def quadratic_terminal_ingredients(
    Q: np.ndarray,
    R: np.ndarray,
    M: np.ndarray,
    k_omega: np.ndarray,
    dt: float,
    time_scaling: float = 5.0,
    pos_bound: float = 5.0,
    vel_bound: float = 1.5,
    omega_bound: float = 0.3,
):
    """Compute (P9, terminal_set) for the 9-d error [e_pos, e_vel, e_omega].

    Args:
        Q: (9,) or (9, 9) running state cost diagonal.
        R: (6,) or (6, 6) running input cost diagonal.
        M: (6, 6) wrench->acceleration map (SpiralParameters.M).
        k_omega: (3,) omega feedback gains of the terminal controller.
    Returns:
        (P9, p9, c, term_set): quadratic cost arrays and a `Polytope` over
        the 9-d error.
    """
    Q = np.diag(Q) if np.ndim(Q) == 1 else np.asarray(Q)
    R = np.diag(R) if np.ndim(R) == 1 else np.asarray(R)
    k_omega = np.asarray(k_omega, dtype=np.float64)

    Minv = np.linalg.inv(M)
    Qu_tilde = Minv.T @ R @ Minv

    # Input weight for the acceleration-level double integrator: the largest
    # eigenvalue of the translational block of Qu_tilde (upper bound over
    # directions), as in `terminal_ingredients.py:191-192`.
    r_in = float(np.max(np.linalg.eigvalsh(Qu_tilde[0:3, 0:3])))

    h = time_scaling * dt
    P2 = _dare_double_integrator(
        h, float(Q[0, 0]) * time_scaling, float(Q[3, 3]) * time_scaling,
        r_in * time_scaling,
    )

    A_om = np.eye(3) - np.diag(k_omega) * dt
    Q_om = Q[6:9, 6:9] + 2.0 * np.linalg.norm(Qu_tilde) * np.diag(k_omega) ** 2
    P_om = la.solve_discrete_lyapunov(A_om, Q_om)

    P9 = np.zeros((9, 9))
    for i in range(3):
        P9[i, i] = P2[0, 0]
        P9[i, 3 + i] = P9[3 + i, i] = P2[0, 1]
        P9[3 + i, 3 + i] = P2[1, 1]
    P9[6:9, 6:9] = P_om

    term_set = Polytope.from_box(
        [-pos_bound] * 3 + [-vel_bound] * 3 + [-omega_bound] * 3,
        [pos_bound] * 3 + [vel_bound] * 3 + [omega_bound] * 3,
    )
    return P9, np.zeros(9), 0.0, term_set
