"""Constant-input test controller, counterpart of
`ft_mpc_tpu/controllers/dummy.py`: the MPC's duck-typed `get_control(state,
t)` interface returning a fixed thruster pattern (thruster 12 on), to drive
the plant without a solver in the loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ft_mpc_torch.ops.dynamics import N_THRUSTERS, BodyParams


def dummy_control(
    params: BodyParams, x: torch.Tensor, t: torch.Tensor, thruster: int = 12,
    magnitude: float = 1.0,
) -> torch.Tensor:
    """(16,) constant test input in x's dtype and device."""
    u = torch.zeros(N_THRUSTERS, dtype=x.dtype, device=x.device)
    u[thruster] = magnitude
    return u


class DummyController:
    """Stateful wrapper with the reference `Controller` interface."""

    def __init__(self, params: BodyParams, thruster: int = 12, magnitude: float = 1.0):
        self.params = params
        self.thruster = thruster
        self.magnitude = magnitude
        self.history = []

    def get_control(self, state, t) -> np.ndarray:
        u = np.zeros(N_THRUSTERS)
        u[self.thruster] = self.magnitude
        self.history.append((t, np.asarray(state).copy(), u))
        return u

    def set_fault(self, fault) -> None:  # interface parity; nothing to reshape
        pass
