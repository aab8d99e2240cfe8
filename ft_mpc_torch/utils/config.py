"""Run configuration: the reactive.yaml schema as a dataclass, counterpart of
`ft_mpc_tpu/utils/config.py`.

The schema is the reference's (`mode`, `time_step`, `traj_shape`,
`traj_duration`, `actuator_failures`, and a tuning tree
`tuning.spiraling.<param_set>` with Q/R/k_omega/max_acceleration/
time_scaling/empc_horizon), plus the framework extras under `tpu:` (batch,
noise mode, seed, debug_nans).  The default file is the JAX package's
`ft_mpc_tpu/config/reactive.yaml`, read as data.  `yaml` is imported inside
`load_config`, so importing this module needs no pyyaml.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ft_mpc_torch.utils.faults import BrokenThruster

DEFAULT_CONFIG_PATH = (
    Path(__file__).resolve().parents[2] / "ft_mpc_tpu" / "config" / "reactive.yaml"
)


@dataclass
class RunConfig:
    time_step: float = 0.1
    traj_shape: str = "hover"
    traj_duration: float = 30.0
    mode: str = "reactive"
    faults: list = field(default_factory=list)  # BrokenThruster entries
    tuning: dict = field(default_factory=dict)  # active param set (spiraling)
    # framework extras (the `tpu:` block of the file)
    batch: int = 1
    noise_mode: str = "reference"
    seed: int = 0
    debug_nans: bool = False

    @property
    def steps(self) -> int:
        return int(self.traj_duration / self.time_step)

    def apply_debug_flags(self) -> None:
        """With `debug_nans`, turn on torch's anomaly mode with NaN checks:
        a backward pass (the terminal cost's `torch.func.grad` / `hessian`)
        that produces a NaN raises at the op that made it.  The forward
        path has no such hook; its outputs are checked for finiteness by
        the callers."""
        if self.debug_nans:
            import torch

            torch.autograd.set_detect_anomaly(True, check_nan=True)


def load_config(path: str | Path | None = None) -> RunConfig:
    """Parse a reactive.yaml-style file into a RunConfig."""
    import yaml

    path = DEFAULT_CONFIG_PATH if path is None else Path(path)
    with open(path) as f:
        raw = yaml.safe_load(f)

    faults = [
        BrokenThruster(
            index=int(f["act_id"]),
            intensity=float(f["intensity"]),
            start_time=float(f.get("start_time", 0.0)),
        )
        for f in raw.get("actuator_failures", [])
    ]

    tuning = {}
    spir = raw.get("tuning", {}).get("spiraling", {})
    if spir:
        pset = spir.get(spir.get("param_set", "P1"), {})
        tuning = {
            "horizon": spir.get("horizon", 15),
            "Q": pset.get("Q", [1, 1, 1, 1, 1, 1, 2, 2, 2]),
            "R": pset.get("R", [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]),
            "k_omega": pset.get("k_omega", [1.0, 1.0, 1.0]),
            "max_acceleration": pset.get("max_acceleration", 0.0),
            "time_scaling": pset.get("time_scaling", 5),
            "empc_horizon": pset.get("empc_horizon", 3),
        }
        # Optional stage constraints: xlb/xub, the reference's per-stage
        # state box (13-vectors); du_max, a wrench rate bound per step.
        for key in ("xlb", "xub", "du_max"):
            if pset.get(key) is not None:
                tuning[key] = pset[key]

    extras = raw.get("tpu", {})
    return RunConfig(
        time_step=float(raw.get("time_step", 0.1)),
        traj_shape=raw.get("traj_shape", "hover"),
        traj_duration=float(raw.get("traj_duration", 30)),
        mode=raw.get("mode", "reactive"),
        faults=faults,
        tuning=tuning,
        batch=int(extras.get("batch", 1)),
        noise_mode=extras.get("noise_mode", "reference"),
        seed=int(extras.get("seed", 0)),
        debug_nans=bool(extras.get("debug_nans", False)),
    )
