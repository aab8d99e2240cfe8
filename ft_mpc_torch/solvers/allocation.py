"""Thruster allocation result container (`ft_mpc_tpu/solvers/allocation.py:35`).

The batched allocation itself is `solvers.lanes_alloc.allocate_thrusters_lanes`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AllocationResult(NamedTuple):
    u_phys: torch.Tensor  # (B, 16) thruster commands
    wrench_clipped: torch.Tensor  # (B, 6) wrench actually allocated
    was_clipped: torch.Tensor  # (B,) bool
    r_prim: torch.Tensor  # (B,) allocation equality residual
    used_fallback: torch.Tensor  # (B,) bool: FISTA feasible point used
