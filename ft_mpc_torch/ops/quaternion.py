"""Quaternion and rotation helpers (xyzw), counterpart of
`ft_mpc_tpu/ops/quaternion.py`.

Functional torch: no in-place writes, tensors built with `torch.stack`, so
every function works on any leading batch shape and under
`torch.func.vmap` / `torch.func.jacfwd`.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Return q / ||q||, safe at very small norms."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=1e-12)


def rot_matrix(q: torch.Tensor) -> torch.Tensor:
    """World->body rotation matrix from an xyzw quaternion. Shape (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # s + s, not 2.0 * s: under torch.func.jacfwd a Python float times a
    # 0-dim tensor gives a float64 tangent; doubling is exact either way.
    twice = lambda s: s + s
    r00 = x * x - y * y - z * z + w * w
    r01 = twice(x * y + z * w)
    r02 = twice(x * z - y * w)
    r10 = twice(x * y - z * w)
    r11 = -x * x + y * y - z * z + w * w
    r12 = twice(y * z + x * w)
    r20 = twice(x * z + y * w)
    r21 = twice(y * z - x * w)
    r22 = -x * x - y * y + z * z + w * w
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_matrix_inv(q: torch.Tensor) -> torch.Tensor:
    """Body->world rotation matrix (transpose of `rot_matrix`)."""
    return rot_matrix(q).transpose(-1, -2)


def rot_full(q: torch.Tensor) -> torch.Tensor:
    """6x6 block rotation acting on a generalized force [f; tau]."""
    R = rot_matrix(q)
    Z = torch.zeros_like(R)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    top = torch.cat([R, Z], dim=-1)
    bot = torch.cat([Z, eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rot_full_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of `rot_full` (transpose)."""
    return rot_full(q).transpose(-1, -2)


def omega_operator(w: torch.Tensor) -> torch.Tensor:
    """4x4 matrix Omega(w) such that q_dot = 0.5 * Omega(w) @ q (xyzw)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, wz, -wy, wx], dim=-1),
            torch.stack([-wz, zero, wx, wy], dim=-1),
            torch.stack([wy, -wx, zero, wz], dim=-1),
            torch.stack([-wx, -wy, -wz, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_kinematics(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q_dot = 0.5 * Omega(w) @ q without materializing the 4x4 matrix."""
    x, y, z, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return 0.5 * torch.stack(
        [
            wz * y - wy * z + wx * qw,
            -wz * x + wx * z + wy * qw,
            wy * x - wx * y + wz * qw,
            -wx * x - wy * y - wz * z,
        ],
        dim=-1,
    )
