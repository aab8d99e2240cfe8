"""The traffic generator: the craft the controller flies, and its inputs.

Frozen copies, so that no change to the program can make the yardstick
cheaper or different:
  * `robot_step`: RK4 of the free-flyer's rigid-body dynamics with each
    row's stuck-on fault force (from `ft_mpc_torch/ops/dynamics.py`);
  * `state_noise`: the reference simulator's additive noise, uniform[0, 1)
    times a scale per state block, drawn from a `torch.Generator`
    (from `ft_mpc_torch/sim/env.py`);
  * `tumbling_x0` and `at_rest_x0`: `bench.py:113-120`'s and
    `benchmarks/long_horizon.py:97-100`'s draws, from the run's seed
    (from `ft_mpc_torch/benchmarks/common.py`); `near_orbit_x0`: the
    sanitizer's draw (`ft_mpc_torch/benchmarks/sanitizer.py:x0_states`),
    from the run's seed and with its ranges as parameters;
  * `hover_refs`: the hover reference about the orbit rate, rows
    [pos, vel, omega_des] and a zero nominal wrench (what
    `generate_trajectory("hover")` and `prepare_center_trajectory` give).

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

N_X = 13
N_THRUSTERS = 16


def thruster_matrix(d1: float, d2: float, d3: float) -> np.ndarray:
    """The 6x16 body-frame thruster matrix of the 16-thruster free-flyer."""
    D = np.zeros((6, N_THRUSTERS))
    D[0, 0:8] = [-1, -1, 1, 1, -1, -1, 1, 1]
    D[1, 8:12] = [-1, -1, 1, 1]
    D[2, 12:16] = [-1, 1, -1, 1]
    D[3, 12:16] = [-d1, d1, d1, -d1]
    D[4, 0:8] = [-d3, d3, d3, -d3, -d3, d3, d3, -d3]
    D[5, 0:8] = [d1, d1, -d1, -d1, -d1, -d1, d1, d1]
    D[5, 8:12] = [-d2, d2, d2, -d2]
    return D


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def rot_matrix(q):
    """World-to-body rotation of an xyzw quaternion, (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([x * x - y * y - z * z + w * w, 2 * (x * y + z * w), 2 * (x * z - y * w)], -1),
        torch.stack([2 * (x * y - z * w), -x * x + y * y - z * z + w * w, 2 * (y * z + x * w)], -1),
        torch.stack([2 * (x * z + y * w), 2 * (y * z - x * w), -x * x - y * y + z * z + w * w], -1),
    ], dim=-2)


def quat_rate(q, w):
    """dq/dt = 0.5 Omega(w) q for an xyzw quaternion."""
    x, y, z, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return 0.5 * torch.stack([wz * y - wy * z + wx * qw, -wz * x + wx * z + wy * qw,
                              wy * x - wx * y + wz * qw, -wx * x - wy * y - wz * z], dim=-1)


def robot_dx_dt(plant: dict, broken, fault_force, x, u):
    """[pos, vel, quat, omega] rates under thruster commands u (B, 16): a
    broken thruster gives its stuck-on force whatever it is commanded."""
    u_eff = torch.where(broken > 0.5, torch.zeros_like(u), u) + fault_force
    gf = _mv(plant["D"], u_eff)
    q, om = x[..., 6:10], x[..., 10:13]
    dvel = _mv(rot_matrix(q).transpose(-1, -2), gf[..., :3]) / plant["mass"]
    J, Jinv = plant["inertia"], plant["inertia_inv"]
    dom = _mv(Jinv, gf[..., 3:] - _cross(om, _mv(J, om)))
    return torch.cat([x[..., 3:6], dvel, quat_rate(q, om), dom], dim=-1)


def robot_step(plant: dict, broken, fault_force, x, u):
    """One RK4 step of the robot dynamics over plant["dt"], input held."""
    f = lambda s: robot_dx_dt(plant, broken, fault_force, s, u)
    dt = plant["dt"]
    k1 = f(x)
    k2 = f(x + dt / 2 * k1)
    k3 = f(x + dt / 2 * k2)
    k4 = f(x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def state_noise(generator: torch.Generator, like: torch.Tensor, scales) -> torch.Tensor:
    """The reference's additive noise: uniform[0, 1) times the scale of each
    block (position, velocity, quaternion, angular velocity)."""
    kw = dict(dtype=like.dtype, device=like.device)
    sizes = (3, 3, 4, 3)
    s = torch.cat([torch.full((n,), float(v), **kw) for n, v in zip(sizes, scales)])
    return torch.rand(like.shape, generator=generator, **kw) * s


def advance(plant: dict, broken, fault_force, x, u, generator, scales):
    """One control period of the craft: RK4, noise, the quaternion renormalized."""
    x = robot_step(plant, broken, fault_force, x, u)
    x = x + state_noise(generator, x, scales)
    q = x[:, 6:10]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([x[:, :6], q, x[:, 10:]], dim=1)


def tumbling_x0(B: int, seed: int, pos: float, vel: float, omega: float) -> np.ndarray:
    """bench.py's tumbling states from `seed`: uniform positions, velocities
    and rates, uniformly random attitudes; float32 (B, 13)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, N_X), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-pos, pos, (B, 3))
    x0[:, 3:6] = rng.uniform(-vel, vel, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-omega, omega, (B, 3))
    return x0


def at_rest_x0(B: int, seed: int, pos: float) -> np.ndarray:
    """long_horizon.py's states from `seed`: uniform positions, identity
    attitude, at rest; float32 (B, 13)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, N_X), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-pos, pos, (B, 3))
    x0[:, 9] = 1.0
    return x0


def near_orbit_x0(B: int, seed: int, pos: float, vel: float, omega: float) -> np.ndarray:
    """The sanitizer's states from `seed`: uniform positions, velocities and
    rates, identity attitude; float32 (B, 13)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, N_X), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-pos, pos, (B, 3))
    x0[:, 3:6] = rng.uniform(-vel, vel, (B, 3))
    x0[:, 6:10] = [0, 0, 0, 1]
    x0[:, 10:13] = rng.uniform(-omega, omega, (B, 3))
    return x0


INITIAL_STATES = {"tumbling": tumbling_x0, "at_rest": at_rest_x0, "near_orbit": near_orbit_x0}


def initial_states(spec: dict, B: int, seed: int) -> np.ndarray:
    """The traffic file's initial-state draw: {"kind": ..., its ranges}."""
    kw = {k: v for k, v in spec.items() if k != "kind"}
    return INITIAL_STATES[spec["kind"]](B, seed, **kw)


def hover_refs(length: int, position, omega_des) -> tuple[np.ndarray, np.ndarray]:
    """(x_ref (length, 9), u_ref (length, 6)): hover at `position` about the
    orbit rate `omega_des`; the nominal wrench of a constant position is 0."""
    x_ref = np.zeros((length, 9))
    x_ref[:, 0:3] = position
    x_ref[:, 6:9] = omega_des
    return x_ref, np.zeros((length, 6))
