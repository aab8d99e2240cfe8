"""Thruster fault descriptors, counterpart of `ft_mpc_tpu/utils/faults.py`.

`BrokenThruster` is the human-facing value object: a thruster stuck at
`intensity * max_thrust` (intensity 0 = dead) that no longer responds to
commands.  On the device a pattern is `ops.dynamics.FaultState` (tensors);
banks of patterns live in `geometry.scenario.ScenarioBank`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BrokenThruster:
    index: int
    intensity: float  # in [0, 1] of max thrust, stuck-on
    start_time: float = 0.0

    def __post_init__(self):
        if not 0 <= self.index < 16:
            raise ValueError(f"thruster index {self.index} out of range [0, 16)")
        if not 0.0 <= self.intensity <= 1.0:
            raise ValueError(f"intensity {self.intensity} outside [0, 1]")
