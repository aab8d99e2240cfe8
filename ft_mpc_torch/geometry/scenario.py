"""Fault scenarios as batched tensors, counterpart of
`ft_mpc_tpu/geometry/scenario.py`: the `Scenario` container, the host-side
functions that build banks, loaders for the committed bank snapshots, and
row tiling/gathering.

A fault pattern compiles once, on the host, into a `Scenario`: fault
wrench, padded attainable-wrench polytope, micro-orbit parameters,
generator view of the zonotope and terminal ingredients.  The build
functions do the JAX package's numpy arithmetic on the plant's leaves in
their own dtype (so a float32 plant gives the same float32-rounded values),
cast the leaves to the numpy type of `dtype`, and hand the scenario to the
device at the end (`ft_mpc_torch.convert.scenario_from_numpy`).  A `ScenarioBank`
stacks scenarios along a leading axis.

Two snapshots are committed as data (float64 leaves, flat field-path keys,
see `ft_mpc_torch.convert`); the build functions reproduce both:
  * `data/bench_bank32.npz`: the bench's 32-pattern bank;
  * `data/demo_bank.npz`: the demo's double fault (thrusters 10 and 11), one
    row per terminal mode of `DEMO_TERMINAL_MODES`, built with the tuning
    of the demo (`examples/sim.py`).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ft_mpc_torch.controllers.spiral_params import SpiralParameters
from ft_mpc_torch.geometry.polytope import Polytope
from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope
from ft_mpc_torch.ops.dynamics import (
    N_THRUSTERS,
    BodyParams,
    FaultState,
    fault_arrays,
    host_array,
)
from ft_mpc_torch.terminal.poly import TerminalPoly, quadratic_terminal
from ft_mpc_torch.utils.faults import BrokenThruster

# Padding of the scenario tensors: 32 facets cover every single and double
# fault of the reference plant (a pattern with more raises; pass a larger
# value), 64 terminal rows every cached terminal set.
MAX_HULL_FACETS = 32
MAX_TERM_FACETS = 64

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


class ScenarioBank(NamedTuple):
    """A batch of scenarios: `Scenario` leaves with a leading axis."""

    scenarios: Scenario
    size: int

    def __getitem__(self, i: int) -> Scenario:
        return tree_map(lambda x: x[i], self.scenarios)


def _np_float(dtype: torch.dtype):
    if dtype == torch.float64:
        return np.float64
    if dtype == torch.float32:
        return np.float32
    raise ValueError(f"scenario dtype {dtype}: float32 or float64")


def _host_params(params: BodyParams) -> BodyParams:
    """The plant with numpy leaves of their own dtype (one copy each)."""
    return BodyParams(*(host_array(x) for x in params))


def _scenario_host(
    params: BodyParams,
    faults: Sequence[BrokenThruster],
    terminal: TerminalPoly | None,
    terminal_set: Polytope | None,
    max_hull_facets: int,
    max_term_facets: int,
    omega_des,
    r_dir,
    f_virt_mag: float,
    precomputed_hull: tuple | None,
    f_dtype,
) -> Scenario:
    """One fault pattern as a `Scenario` of numpy leaves (float leaves of
    `f_dtype`; the fault mask float64, the power tables int32): the JAX
    package's `build_scenario` step for step."""
    D = host_array(params.D)
    max_thrust = float(host_array(params.max_thrust))
    mass = float(host_array(params.mass))
    inertia = host_array(params.inertia)

    broken, intensity = fault_arrays(faults)
    faulty_force = broken * intensity * max_thrust
    faulty_force_gen = D @ faulty_force
    u_ub = np.where(broken > 0.5, 0.0, max_thrust)

    if precomputed_hull is not None:
        hull_A, hull_b, hull_mask = precomputed_hull
    else:
        hull = attainable_wrench_polytope(D, max_thrust, broken, intensity)
        hull_A, hull_b, hull_mask = hull.as_padded(max_hull_facets)

    sp = SpiralParameters.compute(
        mass, inertia, faulty_force_gen, omega_des, r_dir, f_virt_mag
    )

    gen_G = D * max_thrust * (broken < 0.5)[None, :]
    gen_L = max(float(np.linalg.norm(gen_G, 2) ** 2), 1e-9)

    if terminal is None:
        # placeholder P = 0; callers normally pass cached or quadratic ingredients
        terminal = quadratic_terminal(np.zeros((9, 9)), np.zeros(9), 0.0)
    if terminal_set is None:
        term_A = np.zeros((max_term_facets, 9))
        term_b = np.ones(max_term_facets)
        term_mask = np.zeros(max_term_facets)
    else:
        term_A, term_b, term_mask = terminal_set.as_padded(max_term_facets)

    as_f = lambda x: np.asarray(x, dtype=f_dtype)
    terminal = terminal._replace(
        P=as_f(terminal.P),
        p=as_f(terminal.p),
        c=as_f(terminal.c),
        poly_c=as_f(terminal.poly_c),
        poly_pow=np.asarray(terminal.poly_pow, dtype=np.int32),
        sqrt_c=as_f(terminal.sqrt_c),
        sqrt_pow=np.asarray(terminal.sqrt_pow, dtype=np.int32),
        app=as_f(terminal.app),
    )
    return Scenario(
        fault=FaultState(broken=broken, intensity=intensity),
        faulty_force=as_f(faulty_force),
        faulty_force_gen=as_f(faulty_force_gen),
        u_ub=as_f(u_ub),
        hull_A=as_f(hull_A),
        hull_b=as_f(hull_b),
        hull_mask=as_f(hull_mask),
        omega_des=as_f(sp.omega_des),
        r=as_f(sp.r),
        u_comp=as_f(sp.compensation_force),
        beta=as_f(sp.beta),
        M=as_f(sp.M),
        gen_G=as_f(gen_G),
        gen_c=as_f(faulty_force_gen),
        gen_L=as_f(gen_L),
        term=terminal,
        term_A=as_f(term_A),
        term_b=as_f(term_b),
        term_mask=as_f(term_mask),
    )


def build_scenario(
    params: BodyParams,
    faults: Sequence[BrokenThruster] = (),
    terminal: TerminalPoly | None = None,
    terminal_set: Polytope | None = None,
    max_hull_facets: int = MAX_HULL_FACETS,
    max_term_facets: int = MAX_TERM_FACETS,
    omega_des=(0.0, 0.0, 0.6),
    r_dir=(0.0, 1.0, 0.0),
    f_virt_mag: float = 3.5,
    precomputed_hull: tuple | None = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Scenario:
    """Compile one fault pattern into a `Scenario` on `device` (default
    cuda), float leaves of `dtype`.  The host math follows the plant's own
    dtype; `dtype` plays the part of the JAX package's x64 switch (float32
    = x64 off).  The hull comes from the numpy zonotope path unless
    `precomputed_hull` (A, b, mask) is given."""
    from ft_mpc_torch.convert import flatten_namedtuple, scenario_from_numpy

    sc = _scenario_host(params, faults, terminal, terminal_set, max_hull_facets,
                        max_term_facets, omega_des, r_dir, f_virt_mag,
                        precomputed_hull, _np_float(dtype))
    return scenario_from_numpy(flatten_namedtuple(sc), device=device, dtype=dtype)


def stack_scenarios(scenarios: Sequence[Scenario], device=None,
                    dtype: torch.dtype = torch.float32) -> ScenarioBank:
    """Stack scenarios (tensor or numpy leaves) into a bank on `device`
    (default cuda), float leaves of `dtype`."""
    from ft_mpc_torch.convert import flatten_namedtuple, scenario_from_numpy

    flats = [flatten_namedtuple(sc) for sc in scenarios]
    stacked = {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    return ScenarioBank(scenarios=scenario_from_numpy(stacked, device=device, dtype=dtype),
                        size=len(scenarios))


def _pattern_arrays(patterns) -> tuple[np.ndarray, np.ndarray]:
    """(broken, intensity) (P, 16) of a list of fault patterns."""
    rows = [fault_arrays(faults) for faults in patterns]
    return (np.array([r[0] for r in rows]).reshape(-1, N_THRUSTERS),
            np.array([r[1] for r in rows]).reshape(-1, N_THRUSTERS))


def default_fault_pool() -> list[list[BrokenThruster]]:
    """Healthy, all 16 single and all 120 double faults (137 patterns)."""
    pool = [[]]
    pool += [[BrokenThruster(i, 1.0)] for i in range(N_THRUSTERS)]
    pool += [
        [BrokenThruster(i, 1.0), BrokenThruster(j, 1.0)]
        for i in range(N_THRUSTERS)
        for j in range(i + 1, N_THRUSTERS)
    ]
    return pool


def build_scenario_bank(
    params: BodyParams,
    fault_patterns: Sequence[Sequence[BrokenThruster]],
    max_hull_facets: int = MAX_HULL_FACETS,
    device=None,
    dtype: torch.dtype = torch.float32,
    engine: str = "native",
    **kwargs,
) -> ScenarioBank:
    """A bank from a list of fault patterns: the wrench hulls in one threaded
    call of the C++ engine (`runtime.native.batched_wrench_hulls`; `engine=
    "numpy"` for the numpy path), the rest per pattern as `build_scenario`
    (its keyword arguments pass through)."""
    from ft_mpc_torch.runtime.native import batched_wrench_hulls

    hp = _host_params(params)
    broken, intensity = _pattern_arrays(fault_patterns)
    A, b, mask = batched_wrench_hulls(
        hp.D, float(hp.max_thrust), broken, intensity,
        max_facets=max_hull_facets, engine=engine,
    )
    opts = dict(terminal=None, terminal_set=None, max_term_facets=MAX_TERM_FACETS,
                omega_des=(0.0, 0.0, 0.6), r_dir=(0.0, 1.0, 0.0), f_virt_mag=3.5)
    opts.update(kwargs)
    f_dtype = _np_float(dtype)
    return stack_scenarios(
        [
            _scenario_host(hp, faults, max_hull_facets=max_hull_facets,
                           precomputed_hull=(A[s], b[s], mask[s]), f_dtype=f_dtype,
                           **opts)
            for s, faults in enumerate(fault_patterns)
        ],
        device=device, dtype=dtype,
    )


def build_randomized_bank(
    params0: BodyParams,
    n: int,
    seed: int = 0,
    fault_pool: Sequence[Sequence[BrokenThruster]] | None = None,
    mass_range: tuple = (0.85, 1.15),
    inertia_range: tuple = (0.8, 1.2),
    tuning: dict | None = None,
    max_hull_facets: int = MAX_HULL_FACETS,
    device=None,
    dtype: torch.dtype = torch.float32,
    engine: str = "native",
):
    """Randomized (fault pattern x initial state x inertia) bank, the JAX
    package's `build_randomized_bank` draw for draw.

    Each of the n rows draws a pattern from the pool (healthy + all singles
    + all doubles by default), a mass and inertia perturbation of the plant,
    and a random initial robot state, all from one
    `np.random.default_rng(seed)` in the JAX package's order.  Each row's
    spiral parameters, compensation wrench and quadratic terminal
    ingredients come from that row's plant.

    Returns (bank, params, x0) on `device`, float leaves of `dtype`:
      bank    ScenarioBank of n rows;
      params  BodyParams whose mass (n,), inertia and inertia_inv (n, 3, 3)
              carry the rows' plants; D, max_thrust, dt stay shared;
      x0      (n, 13) random robot states.
    """
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.runtime.native import batched_wrench_hulls
    from ft_mpc_torch.terminal.quadratic import quadratic_terminal_ingredients

    dev = resolve_device(device)
    f_dtype = _np_float(dtype)
    hp = _host_params(params0)
    rng = np.random.default_rng(seed)
    tuning = dict(tuning or {})
    Q = np.asarray(tuning.get("Q", [1, 1, 1, 1, 1, 1, 2, 2, 2]), np.float64)
    R = np.asarray(tuning.get("R", [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]), np.float64)
    k_omega = tuning.get("k_omega", [1.0, 1.0, 1.0])
    time_scaling = float(tuning.get("time_scaling", 5))

    if fault_pool is None:
        fault_pool = default_fault_pool()

    # hulls depend only on (D, max_thrust, fault): one engine call for the pool
    P = len(fault_pool)
    broken, intensity = _pattern_arrays(fault_pool)
    hA, hb, hm = batched_wrench_hulls(
        hp.D, float(hp.max_thrust), broken, intensity,
        max_facets=max_hull_facets, engine=engine,
    )

    m0 = float(hp.mass)
    J0 = np.diag(hp.inertia)
    pattern_idx = rng.integers(0, P, size=n)
    masses = m0 * rng.uniform(*mass_range, size=n)
    J_diags = J0[None, :] * rng.uniform(*inertia_range, size=(n, 3))

    scenarios = []
    for row in range(n):
        k = int(pattern_idx[row])
        inertia = np.diag(J_diags[row])
        params_i = hp._replace(
            mass=np.asarray(masses[row], dtype=hp.mass.dtype),
            inertia=inertia.astype(hp.inertia.dtype),
            inertia_inv=np.linalg.inv(inertia).astype(hp.inertia.dtype),
        )
        ff = broken[k] * intensity[k] * float(hp.max_thrust)
        sp = SpiralParameters.compute(masses[row], inertia, hp.D @ ff)
        P9, p9, c, tset = quadratic_terminal_ingredients(
            Q, R, sp.M, k_omega, float(hp.dt), time_scaling=time_scaling
        )
        scenarios.append(
            _scenario_host(
                params_i, fault_pool[k], quadratic_terminal(P9, p9, c), tset,
                max_hull_facets, MAX_TERM_FACETS, (0.0, 0.0, 0.6), (0.0, 1.0, 0.0),
                3.5, (hA[k], hb[k], hm[k]), f_dtype,
            )
        )
    bank = stack_scenarios(scenarios, device=dev, dtype=dtype)

    inertias = np.stack([np.diag(J_diags[r]) for r in range(n)])
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=f_dtype), dtype=dtype, device=dev)
    params = BodyParams(
        mass=as_t(masses),
        inertia=as_t(inertias),
        inertia_inv=as_t(np.linalg.inv(inertias)),
        max_thrust=as_t(hp.max_thrust),
        D=as_t(hp.D),
        dt=as_t(hp.dt),
    )

    x0 = np.zeros((n, 13), dtype=f_dtype)
    x0[:, 0:3] = rng.uniform(-1, 1, (n, 3))
    x0[:, 3:6] = rng.uniform(-0.3, 0.3, (n, 3))
    q = rng.standard_normal((n, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-0.3, 0.3, (n, 3))
    return bank, params, as_t(x0)


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
