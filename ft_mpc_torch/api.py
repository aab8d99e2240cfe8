"""User-facing API, counterpart of `ft_mpc_tpu/api.py`: the default tuning,
the scenario build with terminal ingredients, and the stateful wrappers
`SpiralingMPC` and `SimulationEnvironment` over the per-scenario controller.

`build_scenario_with_terminal` compiles a fault pattern and a tuning into a
`Scenario` on the device.  Terminal modes:
  'quadratic'   -- DARE / Lyapunov ingredients, computed here (milliseconds).
  'empc'        -- the certified ingredients of the offline pipeline
                   (`ft_mpc_torch.terminal.pipeline`), with the orbit
                   (omega_des, r_dir, |f_virt|) they were certified at.
                   Read from the terminal cache: `cache_dir` when given,
                   else the JAX package's committed cache
                   (`ft_mpc_tpu/config/terminal_cache/`, read only) and then
                   the port's own (`build/terminal_cache/`).  A miss runs the
                   orbit search and the pipeline (seconds; its value-function
                   QPs on the plant's device, in the plant's dtype) and
                   writes the entry to `cache_dir` or the port's cache.  A
                   pattern no orbit certifies gets the quadratic ingredients,
                   recorded as a fallback in the entry's meta.
  '<path>.yaml' -- a reference-format terminal.yaml, parsed as data.

`SpiralingMPC` and `SimulationEnvironment` keep the reference's imperative
workflow (construct, load a trajectory, step or run); every step runs the
per-scenario controller (`controllers.spiraling.get_control`) and the RK4
plant on the plant's device.  `SimulationEnvironment.set_fault` reshapes
plant and controller mid-run.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ft_mpc_torch import resolve_device
from ft_mpc_torch.controllers.spiral_params import SpiralParameters
from ft_mpc_torch.geometry.scenario import Scenario, build_scenario
from ft_mpc_torch.ops.dynamics import (
    BodyParams,
    fault_arrays,
    host_array,
    robot_step,
    robot_to_center,
)
from ft_mpc_torch.terminal.pipeline import PORT_TERMINAL_CACHE
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


def _cache_name(params: BodyParams, faults, tuning: dict) -> str:
    from ft_mpc_torch.terminal.pipeline import cache_key, plant_fingerprint

    return f"{cache_key(faults, tuning, plant_fingerprint(params))}.npz"


def terminal_cache_path(params: BodyParams, faults: Sequence[BrokenThruster],
                        tuning: dict, cache_dir: str | Path | None = None) -> Path:
    """The entry of (faults, tuning, plant) in `cache_dir`, default the JAX
    package's committed cache."""
    cdir = Path(cache_dir) if cache_dir else TERMINAL_CACHE
    return cdir / _cache_name(params, faults, tuning)


def cached_terminal_path(params: BodyParams, faults: Sequence[BrokenThruster],
                         tuning: dict, cache_dir: str | Path | None = None) -> Path | None:
    """Where 'empc' mode finds (faults, tuning, plant)'s entry, or None on a
    miss: `cache_dir` alone when given, else the committed cache, then the
    port's own."""
    dirs = (Path(cache_dir),) if cache_dir else (TERMINAL_CACHE, PORT_TERMINAL_CACHE)
    name = _cache_name(params, faults, tuning)
    return next((d / name for d in dirs if (d / name).exists()), None)


def _plant_device_dtype(params: BodyParams) -> tuple[torch.device, torch.dtype]:
    """The device and dtype of the plant's leaves (cuda for numpy leaves)."""
    dtype = torch.from_numpy(np.zeros(1, host_array(params.mass).dtype)).dtype
    if isinstance(params.mass, torch.Tensor):
        return params.mass.device, dtype
    return resolve_device(None), dtype


def compute_empc_ingredients(params: BodyParams, faults: Sequence[BrokenThruster],
                             tuning: dict):
    """A cache miss: the fault-aware orbit and the certified ingredients at
    it, or the quadratic fallback where no orbit certifies (or the pipeline
    finds no feasible box at the chosen one).  The JAX package's arithmetic
    on the plant's leaves in their own dtype; the value-function QPs run on
    the plant's device in its dtype."""
    from ft_mpc_torch.controllers.orbit_search import select_orbit
    from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope
    from ft_mpc_torch.terminal.pipeline import (
        TerminalIngredients,
        compute_terminal_ingredients,
    )

    device, dtype = _plant_device_dtype(params)
    D = host_array(params.D)
    max_thrust = float(host_array(params.max_thrust))
    mass = float(host_array(params.mass))
    inertia = host_array(params.inertia)
    dt = float(host_array(params.dt))
    ff = np.zeros(16)
    for f in faults:
        ff[f.index] = f.intensity * max_thrust
    sp = SpiralParameters.compute(mass, inertia, D @ ff)
    broken = (ff > 0).astype(float)
    hull = attainable_wrench_polytope(D, max_thrust, broken, ff / max_thrust)
    Q = np.asarray(tuning["Q"], dtype=np.float64)
    R = np.asarray(tuning["R"], dtype=np.float64)
    k_omega = tuning.get("k_omega", [1.0, 1.0, 1.0])
    max_acc = float(tuning.get("max_acceleration", 0.0))
    time_scaling = float(tuning.get("time_scaling", 5))

    choice = select_orbit(hull, mass, inertia, D @ ff, k_omega, max_acc)
    orbit_meta = {
        "omega_des": list(choice.omega_des),
        "r_dir": list(choice.r_dir),
        "f_virt_mag": choice.f_virt_mag,
        "is_default": choice.is_default,
    }
    if choice.certifiable:
        sp_c = SpiralParameters.compute(mass, inertia, D @ ff, choice.omega_des,
                                        choice.r_dir, choice.f_virt_mag)
        try:
            ti = compute_terminal_ingredients(
                hull=hull, M=sp_c.M, f_virt6=np.concatenate([sp_c.f_virt, np.zeros(3)]),
                omega_des=sp_c.omega_des, r=sp_c.r, mass=mass, inertia=inertia, dt=dt,
                Q=Q, R=R, k_omega=k_omega, max_acceleration=max_acc,
                time_scaling=time_scaling,
                empc_horizon=int(tuning.get("empc_horizon", 3)),
                device=device, dtype=dtype,
            )
            ti.meta["orbit"] = orbit_meta
            return ti
        except RuntimeError:
            # the orbit screen and the full pipeline can disagree at the edge
            # of feasibility: fall back as for an uncertifiable pattern
            pass
    P9, p9, c, tset = quadratic_terminal_ingredients(Q, R, sp.M, k_omega, dt,
                                                     time_scaling=time_scaling)
    return TerminalIngredients(
        P9=P9, p9=p9, c=c, term=quadratic_terminal(P9, p9, c), term_set=tset,
        emax=np.zeros(3), r_empc=0.0,
        meta={
            "fallback": "quadratic",
            "reason": "uncertifiable at every candidate orbit",
            "orbit": orbit_meta,
        },
    )


def empc_terminal_ingredients(params: BodyParams, faults: Sequence[BrokenThruster],
                              tuning: dict, cache_dir: str | Path | None = None):
    """'empc' mode's ingredients: the cached entry, or a miss computed by
    `compute_empc_ingredients` and written to `cache_dir` (default the
    port's own cache)."""
    from ft_mpc_torch.terminal.pipeline import (
        load_terminal_ingredients,
        save_terminal_ingredients,
    )

    hit = cached_terminal_path(params, faults, tuning, cache_dir)
    if hit is not None:
        return load_terminal_ingredients(hit)
    ti = compute_empc_ingredients(params, faults, tuning)
    out = Path(cache_dir) if cache_dir else PORT_TERMINAL_CACHE
    out.mkdir(parents=True, exist_ok=True)
    save_terminal_ingredients(ti, out / _cache_name(params, faults, tuning))
    return ti


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
    dtype: the cache is keyed on them, and the committed entries were made
    for the float32 plant (`BodyParams.default(dt, torch.float32)`)."""
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
        ti = empc_terminal_ingredients(params, faults, tuning, cache_dir)
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


class SpiralingMPC:
    """Counterpart of the reference's `SpiralingController`: one fault
    pattern, one trajectory, one control step per call, on the plant's
    device and dtype."""

    def __init__(
        self,
        params: BodyParams,
        faults: Sequence[BrokenThruster] = (),
        tuning: dict | None = None,
        terminal_mode: str = "empc",
        cache_dir: str | Path | None = None,
    ):
        from ft_mpc_torch.controllers.spiraling import MPCConfig, MPCWeights
        from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

        self.params = params
        self.device, self.dtype = _plant_device_dtype(params)
        self.tuning = {**DEFAULT_TUNING, **(tuning or {})}
        self.faults = list(faults)
        self.terminal_mode = terminal_mode
        self.cache_dir = cache_dir
        self.scenario = self._build()
        self.weights = MPCWeights.from_diagonals(
            self.tuning["Q"], self.tuning["R"],
            x_lb=self.tuning.get("xlb"), x_ub=self.tuning.get("xub"),
            du_max=self.tuning.get("du_max"), dtype=self.dtype, device=self.device,
        )
        self.cfg = MPCConfig(
            horizon=int(self.tuning["horizon"]),
            sqp_iters=int(self.tuning.get("sqp_iters", 3)),
            admm=StructuredADMMConfig(iters=30, phases=1, rho=50.0),
        )
        self.dt = float(host_array(params.dt))
        self.trajectory = None  # (T, 9) center reference
        self.nominal_input = None  # (T, 6)
        self._warm = None

    def _build(self) -> Scenario:
        return build_scenario_with_terminal(
            self.params, self.faults, self.tuning, terminal_mode=self.terminal_mode,
            cache_dir=self.cache_dir, device=self.device, dtype=self.dtype,
        )

    def set_fault(self, fault: BrokenThruster) -> None:
        """Add a fault and rebuild the scenario (host side): milliseconds for
        a cached pattern, seconds for a miss (orbit search + pipeline, then
        cached).  A deployment that needs a bounded fault-reaction time
        fills the cache for its fault census beforehand."""
        self.faults.append(fault)
        self.scenario = self._build()
        # the carried warm start describes the pre-fault problem: start over
        # from the next measured state
        self._warm = None
        if self.trajectory is not None:
            # omega_des may move with the new orbit
            self.assign_trajectory(self._raw_traj)

    def load_trajectory(self, cmd: str, duration: float, fpath: str | None = None):
        from ft_mpc_torch.utils.trajectory import generate_trajectory

        self.assign_trajectory(generate_trajectory(cmd, self.dt, duration, fpath))

    def assign_trajectory(self, traj13: np.ndarray):
        from ft_mpc_torch.utils.trajectory import prepare_center_trajectory

        self._raw_traj = traj13
        x_ref, u_ref = prepare_center_trajectory(
            traj13, host_array(self.scenario.omega_des),
            float(host_array(self.params.mass)), self.dt, self.cfg.horizon + 1,
        )
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self.trajectory = t(x_ref)
        self.nominal_input = t(u_ref)

    def get_control(self, x0, t: float) -> np.ndarray:
        """16-d thruster commands (host numpy) for robot state x0 at time t."""
        from ft_mpc_torch.controllers.spiraling import (
            get_control,
            init_warmstart,
            shift_warmstart,
        )

        if self.trajectory is None:
            raise RuntimeError("call load_trajectory first")
        i = int(round(t / self.dt))
        Nt = self.cfg.horizon
        if i < 0 or i + Nt + 1 > self.trajectory.shape[0]:
            raise ValueError(
                f"t={t} maps to step {i}, but the loaded trajectory only "
                f"covers steps 0..{self.trajectory.shape[0] - Nt - 2} at "
                f"horizon {Nt} (dt={self.dt}); load a longer "
                "trajectory or reduce the simulated duration"
            )
        x_ref = self.trajectory[i : i + Nt + 1]
        u_ref = self.nominal_input[i : i + Nt + 1]
        self._last_ref_index = i
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)

        c0 = robot_to_center(self.scenario.r, x0)
        if self._warm is None:
            self._warm = init_warmstart(self.params, self.scenario, self.cfg, c0,
                                        weights=self.weights)
        else:
            self._warm = shift_warmstart(self._warm, c0)

        out = get_control(self.params, self.scenario, self.weights, self.cfg,
                          x0, x_ref, u_ref, self._warm)
        self._warm = out.warm
        self.last_output = out
        return out.u_phys.cpu().numpy()


class SimulationEnvironment:
    """Counterpart of the reference's `SimulationEnvironment`: the full
    16-thruster robot model with the controller in the loop, one step per
    call.  Controller and RK4 plant run on the plant's device; the
    measurement noise is a host `np.random.default_rng(seed)`, drawn in the
    JAX package's order.  For batched use prefer `ft_mpc_torch.sim.env`'s
    rollouts."""

    def __init__(self, params: BodyParams, controller: SpiralingMPC, seed: int = 0):
        self.params = params
        self.controller = controller
        self.dt = float(host_array(params.dt))
        self.state = np.zeros(13)
        self.state[9] = 1.0  # identity quaternion (w last)
        self.cur_time = 0.0
        self.noise = {
            "position": 1e-3,
            "velocity": 1e-3,
            "orientation": 1e-3,
            "angular_velocity": 1e-3,
        }
        self._rng = np.random.default_rng(seed)
        self.history = []  # (t, state, u) tuples, reference-style
        self._records = []  # RolloutHistory fields, one dict a step

    def set_initial_state(
        self, position=None, velocity=None, orientation=None, angular_velocity=None
    ):
        if position is not None:
            self.state[0:3] = position
        if velocity is not None:
            self.state[3:6] = velocity
        if orientation is not None:
            self.state[6:10] = orientation
        if angular_velocity is not None:
            self.state[10:13] = angular_velocity

    def set_fault(self, fault: BrokenThruster):
        """Inject a fault mid-run: plant and controller both reshape."""
        self.controller.set_fault(fault)

    def step(self):
        ctl = self.controller
        u = ctl.get_control(self.state, self.cur_time)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=ctl.dtype, device=ctl.device)
        x_new = robot_step(self.params, ctl.scenario.fault, t(self.state), t(u)).cpu().numpy()
        x_new[0:3] += self._rng.uniform(0, self.noise["position"], 3)
        x_new[3:6] += self._rng.uniform(0, self.noise["velocity"], 3)
        x_new[6:10] += self._rng.uniform(0, self.noise["orientation"], 4)
        x_new[10:13] += self._rng.uniform(0, self.noise["angular_velocity"], 3)
        x_new[6:10] /= np.linalg.norm(x_new[6:10])
        self.history.append((self.cur_time, self.state.copy(), u))
        out = ctl.last_output
        host = lambda a: a.detach().cpu().numpy()
        self._records.append(
            dict(
                time=self.cur_time,
                state=self.state.copy(),
                c0=host(out.c0),
                u_phys=np.asarray(u),
                wrench=host(out.wrench),
                x_ref0=host(ctl.trajectory[getattr(ctl, "_last_ref_index", 0)]),
                cost=float(out.info.cost),
                r_prim=float(out.info.r_prim),
                r_dual=float(out.info.r_dual),
                defect=float(out.info.defect),
                term_gap=float(out.info.term_gap),
                was_clipped=bool(out.alloc.was_clipped),
            )
        )
        self.state = x_new
        self.cur_time += self.dt

    def run_simulation(self, duration: float):
        for _ in range(int(duration / self.dt)):
            self.step()

    def to_history(self):
        """The stepped run as a `RolloutHistory` of host tensors (time axis
        first), the input of `sim.history.export_csv`."""
        from ft_mpc_torch.sim.env import RolloutHistory

        if not self._records:
            raise RuntimeError("no steps recorded yet")
        return RolloutHistory(**{
            k: torch.as_tensor(np.asarray([r[k] for r in self._records]))
            for k in self._records[0]
        })

    def export_csv(self, file_path: str) -> None:
        """67-column reference-schema CSV of the stepped run."""
        from ft_mpc_torch.sim.history import export_csv

        export_csv(self.to_history(), host_array(self.params.D), file_path)
