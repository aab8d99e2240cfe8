"""Micro-orbit ("spiraling") parameters, counterpart of
`ft_mpc_tpu/controllers/spiral_params.py` (host numpy, float64).

The controller spins the craft at `omega_des` so a stuck-on thruster's
body-frame force averages out; a virtual centripetal force `f_virt` along
`r_dir` defines the orbit, of radius |f_virt| / (m |omega_des|^2); the
compensation input is [f_virt; 0] minus the fault wrench, and M maps a
generalized force to the 6-d acceleration of the orbit centre, with the
lever-arm coupling -[r]x J^-1 for any orbit direction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SpiralParameters:
    omega_des: np.ndarray
    r_dir: np.ndarray
    f_virt: np.ndarray  # (3,) virtual centripetal force
    compensation_force: np.ndarray  # (6,)
    r: np.ndarray  # (3,) orbit-center offset, body frame
    M: np.ndarray  # (6, 6) generalized force -> center acceleration
    beta: np.ndarray  # (4,) xyzw quaternion of the force-aligned frame

    @classmethod
    def compute(
        cls,
        mass: float,
        inertia: np.ndarray,
        faulty_force_generalized: np.ndarray,
        omega_des=(0.0, 0.0, 0.6),
        r_dir=(0.0, 1.0, 0.0),
        f_virt_mag: float = 3.5,
    ) -> "SpiralParameters":
        omega_des = np.asarray(omega_des, dtype=np.float64)
        r_dir = np.asarray(r_dir, dtype=np.float64)
        f_virt = f_virt_mag * r_dir
        compensation = (
            np.concatenate([f_virt, np.zeros(3)]) - np.asarray(faulty_force_generalized)
        )
        r = np.linalg.norm(f_virt) / (mass * np.linalg.norm(omega_des) ** 2) * r_dir
        inertia_inv = np.linalg.inv(inertia)
        rx, ry, rz = r
        skew_r = np.array(
            [
                [0.0, -rz, ry],
                [rz, 0.0, -rx],
                [-ry, rx, 0.0],
            ]
        )
        m_helper = -skew_r @ inertia_inv
        M = np.block(
            [
                [np.eye(3) / mass, m_helper],
                [np.zeros((3, 3)), inertia_inv],
            ]
        )
        return cls(
            omega_des=omega_des,
            r_dir=r_dir,
            f_virt=f_virt,
            compensation_force=compensation,
            r=r,
            M=M,
            beta=np.array([0.0, 0.0, 0.0, 1.0]),
        )
