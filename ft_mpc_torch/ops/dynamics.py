"""Rigid-body and orbit-center dynamics, counterpart of
`ft_mpc_tpu/ops/dynamics.py`.

Every function is functional (no in-place writes, no `.item()`), so it runs
on any leading batch shape and under `torch.func.vmap` / `jacfwd`.  Plant
leaves may carry a leading row axis matching the state's (per-scenario
mass/inertia, see `ops.linearize.params_batch_axes`) or be shared:
mass and dt are broadcast with `[..., None]`, matrices with batched matmul.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ft_mpc_torch import resolve_device
from ft_mpc_torch.ops.quaternion import quat_kinematics, rot_matrix

N_STATE = 13
N_THRUSTERS = 16
N_GEN = 6  # generalized force dimension [f(3); tau(3)]


def build_thruster_matrix(
    d1: float = 0.12, d2: float = 0.09, d3: float = 0.05
) -> np.ndarray:
    """6x16 thruster allocation matrix D (body frame), host numpy."""
    D = np.zeros((N_GEN, N_THRUSTERS))
    D[0, 0:8] = [-1, -1, 1, 1, -1, -1, 1, 1]
    D[1, 8:12] = [-1, -1, 1, 1]
    D[2, 12:16] = [-1, 1, -1, 1]
    D[3, 12:16] = [-d1, d1, d1, -d1]
    D[4, 0:8] = [-d3, d3, d3, -d3, -d3, d3, d3, -d3]
    D[5, 0:8] = [d1, d1, -d1, -d1, -d1, -d1, d1, d1]
    D[5, 8:12] = [-d2, d2, d2, -d2]
    return D


class BodyParams(NamedTuple):
    """Plant constants as tensors (mass/inertia may carry a scenario axis)."""

    mass: torch.Tensor  # () or (B,)
    inertia: torch.Tensor  # (3, 3) or (B, 3, 3)
    inertia_inv: torch.Tensor  # (3, 3) or (B, 3, 3)
    max_thrust: torch.Tensor  # ()
    D: torch.Tensor  # (6, 16)
    dt: torch.Tensor  # () or (B,)

    @classmethod
    def default(
        cls, dt: float = 0.1, dtype: torch.dtype = torch.float32, device=None
    ) -> "BodyParams":
        dev = resolve_device(device)
        inertia = np.diag([0.2, 0.3, 0.25])
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        return cls(
            mass=as_t(16.8),
            inertia=as_t(inertia),
            inertia_inv=as_t(np.linalg.inv(inertia)),
            max_thrust=as_t(3.4),
            D=as_t(build_thruster_matrix()),
            dt=as_t(dt),
        )


def fault_arrays(faults) -> tuple[np.ndarray, np.ndarray]:
    """(broken, intensity), float64 (16,), of an iterable of
    `BrokenThruster`-like (index, intensity)."""
    broken = np.zeros(N_THRUSTERS)
    intensity = np.zeros(N_THRUSTERS)
    for f in faults:
        broken[f.index] = 1.0
        intensity[f.index] = f.intensity
    return broken, intensity


def host_array(x) -> np.ndarray:
    """A leaf as a host numpy array of its own dtype (tensor on any device,
    numpy array or Python number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FaultState(NamedTuple):
    """Thruster fault pattern as data: broken 0/1 mask, stuck-on intensity."""

    broken: torch.Tensor  # (16,)
    intensity: torch.Tensor  # (16,)

    @classmethod
    def healthy(cls, device=None, dtype: torch.dtype = torch.float32) -> "FaultState":
        """No thruster broken, on `device` (default cuda)."""
        return cls.from_faults((), device=device, dtype=dtype)

    @classmethod
    def from_faults(cls, faults, device=None,
                    dtype: torch.dtype = torch.float32) -> "FaultState":
        """From an iterable of `BrokenThruster`-like (index, intensity)."""
        broken, intensity = fault_arrays(faults)
        dev = resolve_device(device)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        return cls(broken=as_t(broken), intensity=as_t(intensity))

    def faulty_force(self, params: BodyParams) -> torch.Tensor:
        return self.broken * self.intensity * params.max_thrust

    def faulty_force_generalized(self, params: BodyParams) -> torch.Tensor:
        return _matvec(params.D, self.faulty_force(params))

    def u_upper_bound(self, params: BodyParams) -> torch.Tensor:
        return torch.where(
            self.broken > 0.5, torch.zeros_like(self.broken), params.max_thrust
        )


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., m, n) @ (..., n) with broadcasting over the leading dims."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def body_wrench(
    params: BodyParams, fault: FaultState, u_phys: torch.Tensor
) -> torch.Tensor:
    """Generalized body-frame force from physical thruster commands under fault."""
    u_eff = torch.where(
        fault.broken > 0.5, torch.zeros_like(u_phys), u_phys
    ) + fault.faulty_force(params)
    return _matvec(params.D, u_eff)


def robot_dx_dt(
    params: BodyParams, fault: FaultState, x: torch.Tensor, u_phys: torch.Tensor
) -> torch.Tensor:
    """Continuous dynamics of the robot state [pos, vel, quat, omega]."""
    vel = x[..., 3:6]
    q = x[..., 6:10]
    omega = x[..., 10:13]
    gf = body_wrench(params, fault, u_phys)
    force, torque = gf[..., 0:3], gf[..., 3:6]
    dvel = _matvec(rot_matrix(q).transpose(-1, -2), force) / params.mass[..., None]
    dq = quat_kinematics(q, omega)
    domega = _matvec(
        params.inertia_inv,
        torque - _cross(omega, _matvec(params.inertia, omega)),
    )
    return torch.cat([vel, dvel, dq, domega], dim=-1)


def center_dx_dt(
    params: BodyParams,
    fault_gen_force: torch.Tensor,
    r: torch.Tensor,
    c: torch.Tensor,
    u_gen: torch.Tensor,
) -> torch.Tensor:
    """Continuous dynamics of the orbit-center state [pos_c, vel_c, omega, quat]."""
    vel = c[..., 3:6]
    omega = c[..., 6:9]
    q = c[..., 9:13]
    gf = u_gen + fault_gen_force
    force, torque = gf[..., 0:3], gf[..., 3:6]
    domega = _matvec(
        params.inertia_inv,
        torque - _cross(omega, _matvec(params.inertia, omega)),
    )
    dvel = _matvec(
        rot_matrix(q).transpose(-1, -2),
        force / params.mass[..., None]
        + _cross(domega, r)
        + _cross(omega, _cross(omega, r)),
    )
    dq = quat_kinematics(q, omega)
    return torch.cat([vel, dvel, domega, dq], dim=-1)


def rk4(
    f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: torch.Tensor,
    x: torch.Tensor,
    u: torch.Tensor,
) -> torch.Tensor:
    """One RK4 step of x' = f(x, u) with zero-order-hold input.

    dt is () or a row axis matching x's leading dims.
    """
    dt = dt[..., None]
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def robot_step(
    params: BodyParams, fault: FaultState, x: torch.Tensor, u_phys: torch.Tensor
) -> torch.Tensor:
    """Discrete robot dynamics (RK4)."""
    return rk4(lambda s, uu: robot_dx_dt(params, fault, s, uu), params.dt, x, u_phys)


def center_step(
    params: BodyParams,
    fault_gen_force: torch.Tensor,
    r: torch.Tensor,
    c: torch.Tensor,
    u_gen: torch.Tensor,
) -> torch.Tensor:
    """Discrete orbit-center dynamics (RK4)."""
    return rk4(
        lambda s, uu: center_dx_dt(params, fault_gen_force, r, s, uu),
        params.dt,
        c,
        u_gen,
    )


def robot_to_center(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Robot state [pos,vel,quat,omega] -> center state [pos_c,vel_c,omega,quat]."""
    q = x[..., 6:10]
    omega = x[..., 10:13]
    R_inv = rot_matrix(q).transpose(-1, -2)
    pos = x[..., 0:3] + _matvec(R_inv, r)
    vel = x[..., 3:6] + _matvec(R_inv, _cross(omega, r))
    return torch.cat([pos, vel, omega, q], dim=-1)


def center_to_robot(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Center state -> robot state (inverse of `robot_to_center`)."""
    omega = c[..., 6:9]
    q = c[..., 9:13]
    R_inv = rot_matrix(q).transpose(-1, -2)
    pos = c[..., 0:3] - _matvec(R_inv, r)
    vel = c[..., 3:6] - _matvec(R_inv, _cross(omega, r))
    return torch.cat([pos, vel, q, omega], dim=-1)
