"""Rollout history post-processing: the reference's 67-column CSV schema,
counterpart of `ft_mpc_tpu/sim/history.py` (a copy of its numpy code).

`export_csv` writes the exact header and layout of the reference's
`ControllerDebug.export`, so runs compare directly with reference CSV dumps.
"""

from __future__ import annotations

import numpy as np
import torch

from ft_mpc_torch.sim.env import RolloutHistory

CSV_HEADER = [
    "time",
    "position_x", "position_y", "position_z",
    "velocity_x", "velocity_y", "velocity_z",
    "orientation_x", "orientation_y", "orientation_z", "orientation_w",
    "angular_velocity_x", "angular_velocity_y", "angular_velocity_z",
    *[f"input_{i}" for i in range(16)],
    "force_x", "force_y", "force_z",
    "torque_x", "torque_y", "torque_z",
    "circle_position_x", "circle_position_y", "circle_position_z",
    "circle_velocity_x", "circle_velocity_y", "circle_velocity_z",
    "circle_angular_velocity_x", "circle_angular_velocity_y", "circle_angular_velocity_z",
    "position_error_x", "position_error_y", "position_error_z",
    "velocity_error_x", "velocity_error_y", "velocity_error_z",
    "orientation_error_x", "orientation_error_y", "orientation_error_z", "orientation_error_w",
    "angular_velocity_error_x", "angular_velocity_error_y", "angular_velocity_error_z",
    "circle_position_error_x", "circle_position_error_y", "circle_position_error_z",
    "circle_velocity_error_x", "circle_velocity_error_y", "circle_velocity_error_z",
    "circle_angular_velocity_error_x", "circle_angular_velocity_error_y", "circle_angular_velocity_error_z",
]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def history_to_table(hist: RolloutHistory, D) -> np.ndarray:
    """(T, 67) table in the reference CSV layout from one rollout history."""
    t = _np(hist.time)[:, None]
    state = _np(hist.state)
    c0 = _np(hist.c0)
    u = _np(hist.u_phys)
    ref = _np(hist.x_ref0)  # (T, 9): desired pos, vel, omega

    gen_force = u @ _np(D).T  # (T, 6)
    pos, vel, quat, omega = state[:, 0:3], state[:, 3:6], state[:, 6:10], state[:, 10:13]
    cpos, cvel, comega = c0[:, 0:3], c0[:, 3:6], c0[:, 6:9]
    dpos, dvel, domega = ref[:, 0:3], ref[:, 3:6], ref[:, 6:9]
    dquat = np.zeros_like(quat)  # the reference uses zeros for its 9-d desired state

    return np.hstack(
        [
            t, pos, vel, quat, omega, u,
            gen_force[:, 0:3], gen_force[:, 3:6],
            cpos, cvel, comega,
            dpos - pos, dvel - vel, dquat - quat, domega - omega,
            dpos - cpos, dvel - cvel, domega - comega,
        ]
    )


def export_csv(hist: RolloutHistory, D, file_path: str) -> None:
    table = history_to_table(hist, D)
    np.savetxt(file_path, table, delimiter=";", header=";".join(CSV_HEADER))
