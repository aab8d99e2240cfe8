"""Reference trajectory generation and preparation.

`generate_trajectory` mirrors the generator family of
`ft_mpc/util/get_trajectory.py:43-184` (sin / line / hover / circle, plus
YAML file loading), producing a 13xT array [pos, vel, quat(xyzw), omega].

`prepare_center_trajectory` mirrors `SpiralingController.assign_trajectory`
(`ft_mpc/controllers/spiraling_mpc.py:255-286`): prolong by the horizon,
replace the angular rows with the micro-orbit's constant omega_des, and
derive the nominal feedforward wrench from the second derivative of the
position reference (mass only -- omega_dot = 0 on the orbit).

All host-side numpy; the results are static arrays indexed on-device with
`lax.dynamic_slice` during rollouts.
"""

from __future__ import annotations

import numpy as np
import yaml
from scipy.spatial.transform import Rotation


def _euler_to_quat(euler_traj: np.ndarray) -> np.ndarray:
    """(3, T) xyz euler -> (4, T) xyzw quaternions."""
    return Rotation.from_euler("xyz", euler_traj.T).as_quat().T


def _quat_to_angular_vel(quat_traj: np.ndarray, dt: float) -> np.ndarray:
    """(4, T) quaternions -> (3, T) body angular velocity by finite differences."""
    rots = Rotation.from_quat(quat_traj.T)
    omega = np.zeros((3, quat_traj.shape[1]))
    for i in range(1, quat_traj.shape[1]):
        omega[:, i] = (rots[i - 1].inv() * rots[i]).as_rotvec() / dt
    return omega


def generate_trajectory(
    shape: str, dt: float, duration: float, file_path: str | None = None
) -> np.ndarray:
    """13xT reference trajectory [pos, vel, quat, omega] for a named shape.

    Accepts the reference's command strings: 'hover', 'hover_<x>_<y>_<z>',
    'generate_line', 'generate_sin', 'generate_circle',
    'circle_r_<radius>_sPerFullCircle_<sec>', 'generate_point_stabilizing',
    and 'load' with file_path.
    """
    t = np.arange(0.0, 10 * duration, dt).reshape(1, -1)
    zeros = np.zeros_like(t)
    ones = np.ones_like(t)
    ident_quat = _euler_to_quat(np.zeros((3, t.size)))

    if shape == "load":
        if file_path is None:
            raise ValueError("'load' requires file_path")
        with open(file_path) as f:
            data = yaml.safe_load(f)
        if abs(data["dt"] - dt) > 1e-12:
            raise ValueError(
                f"trajectory dt {data['dt']} != controller dt {dt}"
            )
        traj = np.array(data["x"]).T
        if traj.shape[1] < duration / dt:
            raise ValueError(
                f"trajectory too short: {traj.shape[1] * dt}s < {duration}s"
            )
        return traj

    if shape in ("hover", "generate_point_stabilizing") or shape.startswith("hover_"):
        if shape.startswith("hover_"):
            parts = shape.split("_")[1:]
            if len(parts) != 3:
                raise ValueError("use 'hover' or 'hover_<x>_<y>_<z>'")
            pos = [float(p) for p in parts]
        else:
            pos = [0.0, 0.0, 0.0]
        return np.concatenate(
            [pos[0] * ones, pos[1] * ones, pos[2] * ones, zeros, zeros, zeros,
             ident_quat, np.zeros((3, t.size))]
        )

    if shape == "generate_line":
        return np.concatenate(
            [t, zeros, zeros, ones, zeros, zeros, ident_quat, np.zeros((3, t.size))]
        )

    if shape == "generate_sin":
        quat = _euler_to_quat(
            np.vstack([np.pi / 2 * ones, zeros, zeros]).reshape(3, -1)
        )
        omega = _quat_to_angular_vel(quat, dt)
        gain = 0.1
        return np.concatenate(
            [gain * np.sin(t), t, zeros, gain * np.cos(t), ones, zeros, quat, omega]
        )

    if shape == "generate_circle" or shape.startswith("circle_"):
        radius, s_per_circle = 2.0, 30.0
        if shape.startswith("circle_"):
            parts = shape.split("_")
            if len(parts) != 5 or parts[1] != "r" or parts[3] != "sPerFullCircle":
                raise ValueError("use 'circle_r_<radius>_sPerFullCircle_<sec>'")
            radius, s_per_circle = float(parts[2]), float(parts[4])
        w = 2 * np.pi / s_per_circle
        traj = np.concatenate(
            [radius * np.cos(w * t), radius * np.sin(w * t), zeros,
             -radius * w * np.sin(w * t), radius * w * np.cos(w * t), zeros,
             ident_quat, np.zeros((3, t.size))]
        )
        traj += np.array([-radius] + [0.0] * 12).reshape(-1, 1)
        return traj

    raise ValueError(f"unknown trajectory shape '{shape}'")


def prepare_center_trajectory(
    traj13: np.ndarray,
    omega_des: np.ndarray,
    mass: float,
    dt: float,
    horizon: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Robot-frame 13xT trajectory -> center-state reference + nominal wrench.

    Returns:
        x_ref: (T + horizon, 9) rows [pos_c, vel_c, omega_des]
        u_ref: (T + horizon, 6) nominal generalized force (world-frame force
               part, uncorrected for orientation -- rotated per-stage by the
               predicted quaternion, as the reference does in-solver at
               `spiraling_mpc.py:156-166`).
    """
    traj = np.hstack([traj13, np.tile(traj13[:, -1:], (1, horizon))])
    T = traj.shape[1]
    omega = np.tile(np.asarray(omega_des).reshape(3, 1), (1, T))
    x_ref = np.concatenate([traj[0:6], omega])  # (9, T)

    pos = x_ref[0:3]
    acc = np.gradient(np.gradient(pos, axis=1), axis=1) / dt**2
    u_ref = np.vstack([acc * mass, np.zeros_like(acc)])  # (6, T)
    return x_ref.T.copy(), u_ref.T.copy()
