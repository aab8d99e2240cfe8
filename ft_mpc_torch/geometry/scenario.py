"""Fault scenarios as batched tensors: the `Scenario` container of
`ft_mpc_tpu/geometry/scenario.py:40-68`, a loader for a committed bank
snapshot, and row tiling/gathering.

The port cannot build banks yet (that needs the host-side geometry and
terminal tooling); two snapshots are committed as data (float64 leaves, flat
field-path keys, see `ft_mpc_torch.convert`):
  * `data/bench_bank32.npz`: the bench's 32-pattern bank;
  * `data/demo_bank.npz`: the demo's double fault (thrusters 10 and 11), one
    row per terminal mode of `DEMO_TERMINAL_MODES`, built with the tuning
    of the demo (`examples/sim.py`).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ft_mpc_torch.ops.dynamics import FaultState
from ft_mpc_torch.terminal.poly import TerminalPoly

BENCH_BANK = Path(__file__).resolve().parent.parent / "data" / "bench_bank32.npz"
DEMO_BANK = BENCH_BANK.with_name("demo_bank.npz")
DEMO_TERMINAL_MODES = ("empc", "quadratic")  # the rows of DEMO_BANK


class Scenario(NamedTuple):
    """All per-fault-pattern data consumed by the controller, as tensors.

    Batched banks carry a leading scenario axis on every leaf.
    """

    fault: FaultState
    faulty_force: torch.Tensor  # (16,)
    faulty_force_gen: torch.Tensor  # (6,)
    u_ub: torch.Tensor  # (16,)
    hull_A: torch.Tensor  # (F, 6)
    hull_b: torch.Tensor  # (F,)
    hull_mask: torch.Tensor  # (F,)
    omega_des: torch.Tensor  # (3,)
    r: torch.Tensor  # (3,)
    u_comp: torch.Tensor  # (6,)
    beta: torch.Tensor  # (4,)
    M: torch.Tensor  # (6, 6)
    gen_G: torch.Tensor  # (6, 16)
    gen_c: torch.Tensor  # (6,)
    gen_L: torch.Tensor  # ()
    term: TerminalPoly
    term_A: torch.Tensor  # (T, 9)
    term_b: torch.Tensor  # (T,)
    term_mask: torch.Tensor  # (T,)


def load_bank_snapshot(
    path: str | Path = BENCH_BANK, device=None, dtype: torch.dtype = torch.float32
) -> Scenario:
    """Load a bank snapshot (flat npz) onto `device` (default cuda)."""
    from ft_mpc_torch.convert import scenario_from_numpy

    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return scenario_from_numpy(flat, device=device, dtype=dtype)


def load_demo_scenario(terminal_mode: str = "empc", device=None,
                       dtype: torch.dtype = torch.float32) -> Scenario:
    """The demo's double-fault scenario (one scenario, no batch axis) in
    `terminal_mode` ('empc', the certified default, or 'quadratic')."""
    if terminal_mode not in DEMO_TERMINAL_MODES:
        raise ValueError(f"terminal_mode {terminal_mode!r}: the demo snapshot holds "
                         f"{DEMO_TERMINAL_MODES}")
    row = DEMO_TERMINAL_MODES.index(terminal_mode)
    return tree_map(lambda x: x[row], load_bank_snapshot(DEMO_BANK, device, dtype))


def tile_bank(bank: Scenario, reps: int) -> Scenario:
    """Repeat the whole bank `reps` times along the scenario axis (np.tile)."""
    return tree_map(lambda x: x.repeat((reps,) + (1,) * (x.dim() - 1)), bank)


def take_rows(bank: Scenario, idx) -> Scenario:
    """Rows `idx` of a batched bank."""
    return tree_map(lambda x: x[idx], bank)
