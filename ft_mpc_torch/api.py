"""User-facing API, counterpart of `ft_mpc_tpu/api.py`: the default tuning
and the scenario build with terminal ingredients.

`build_scenario_with_terminal` compiles a fault pattern and a tuning into a
`Scenario` on the device.  Terminal modes:
  'quadratic'   -- DARE / Lyapunov ingredients, computed here (milliseconds).
  'empc'        -- the certified ingredients of the offline pipeline, read
                   from the terminal cache (the JAX package's
                   `ft_mpc_tpu/config/terminal_cache/`, or `cache_dir`),
                   with the orbit (omega_des, r_dir, |f_virt|) the entry
                   was certified at.  The cache is only read: a pattern,
                   tuning or plant it lacks raises (the offline pipeline
                   that would compute it is ROADMAP A12b).
  '<path>.yaml' -- a reference-format terminal.yaml, parsed as data.
The `SpiralingMPC` and `SimulationEnvironment` classes are not ported yet
(ROADMAP A9).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ft_mpc_torch.controllers.spiral_params import SpiralParameters
from ft_mpc_torch.geometry.scenario import Scenario, build_scenario
from ft_mpc_torch.ops.dynamics import BodyParams, fault_arrays, host_array
from ft_mpc_torch.terminal.poly import quadratic_terminal
from ft_mpc_torch.terminal.quadratic import quadratic_terminal_ingredients
from ft_mpc_torch.utils.faults import BrokenThruster

TERMINAL_CACHE = (
    Path(__file__).resolve().parent.parent / "ft_mpc_tpu" / "config" / "terminal_cache"
)

DEFAULT_TUNING = {
    "horizon": 15,
    "Q": [1, 1, 1, 1, 1, 1, 2, 2, 2],
    "R": [0.1, 0.1, 0.1, 0.01, 0.01, 0.01],
    "k_omega": [1.0, 1.0, 1.0],
    "time_scaling": 5,
    "sqp_iters": 3,
}


def terminal_cache_path(params: BodyParams, faults: Sequence[BrokenThruster],
                        tuning: dict, cache_dir: str | Path | None = None) -> Path:
    """The cache entry that holds (faults, tuning, plant)'s ingredients."""
    from ft_mpc_torch.terminal.pipeline import cache_key, plant_fingerprint

    cdir = Path(cache_dir) if cache_dir else TERMINAL_CACHE
    return cdir / f"{cache_key(faults, tuning, plant_fingerprint(params))}.npz"


def build_scenario_with_terminal(
    params: BodyParams,
    faults: Sequence[BrokenThruster],
    tuning: dict,
    terminal_mode: str = "empc",
    cache_dir: str | Path | None = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Scenario:
    """A fault pattern + tuning as a `Scenario` with terminal ingredients, on
    `device` (default cuda), float leaves of `dtype` (see the module
    docstring for the modes).  The plant's leaves are read in their own
    dtype: the cache is keyed on them, and the JAX package's entries were
    made for its float32 plant (`BodyParams.default(dt, torch.float32)`)."""
    build = lambda **kw: build_scenario(params, faults, device=device, dtype=dtype, **kw)

    if terminal_mode == "quadratic":
        ff = fault_arrays(faults)[1] * float(host_array(params.max_thrust))
        sp = SpiralParameters.compute(float(host_array(params.mass)),
                                      host_array(params.inertia), host_array(params.D) @ ff)
        P9, p9, c, tset = quadratic_terminal_ingredients(
            np.asarray(tuning["Q"], dtype=np.float64),
            np.asarray(tuning["R"], dtype=np.float64),
            sp.M,
            tuning.get("k_omega", [1.0, 1.0, 1.0]),
            float(host_array(params.dt)),
            time_scaling=float(tuning.get("time_scaling", 5)),
        )
        return build(terminal=quadratic_terminal(P9, p9, c), terminal_set=tset)
    if str(terminal_mode).endswith((".yaml", ".yml")):
        from ft_mpc_torch.terminal.reference_io import load_reference_terminal_yaml

        term, tset = load_reference_terminal_yaml(terminal_mode)
        return build(terminal=term, terminal_set=tset)
    if terminal_mode == "empc":
        from ft_mpc_torch.terminal.pipeline import load_terminal_ingredients

        cpath = terminal_cache_path(params, faults, tuning, cache_dir)
        if not cpath.exists():
            raise FileNotFoundError(
                f"no cached terminal ingredients for faults "
                f"{[(f.index, f.intensity) for f in faults]} with this tuning and "
                f"plant ({cpath}); computing them needs the offline terminal "
                "pipeline, which the port does not have yet (ROADMAP A12b)"
            )
        ti = load_terminal_ingredients(cpath)
        orbit = ti.meta.get("orbit")
        if orbit is None:
            return build(terminal=ti.term, terminal_set=ti.term_set)
        return build(
            terminal=ti.term, terminal_set=ti.term_set,
            omega_des=tuple(orbit["omega_des"]),
            r_dir=tuple(orbit["r_dir"]),
            f_virt_mag=float(orbit["f_virt_mag"]),
        )
    raise ValueError(f"unknown terminal_mode {terminal_mode}")
