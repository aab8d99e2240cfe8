"""Fault-aware micro-orbit selection (host numpy, per fault pattern),
counterpart of `ft_mpc_tpu/controllers/orbit_search.py`.

The reference's orbit is fixed: omega_des = [0, 0, 0.6], r_dir = [0, 1, 0],
|f_virt| = 3.5 N.  Under many double faults that orbit leaves the terminal
certificate infeasible (the attainable acceleration polytope cannot hold
the nominal + eMPC box + fb-lin residual budget).  `select_orbit` keeps the
default orbit where it certifies and otherwise maximizes the certificate's
log-volume objective (`terminal.pipeline.input_bound_box`) over a grid:

  * r_dir: +-e_x, +-e_y, +-e_z and the fault force direction;
  * omega_des: coordinate axes projected perpendicular to r_dir,
    magnitudes {0.4, 0.6, 0.9};
  * |f_virt|: {1.0, 1.75, 2.5, 3.5} N.

Candidates are screened on a coarse emax grid and the winners re-scored on
the full one.  A flat attainable set (no 6-d ball fits, e.g. thrusters
12 + 13) is reported uncertifiable without a search.  The same arithmetic
on the same arrays as the JAX package, so the choice is identical.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ft_mpc_torch.controllers.spiral_params import SpiralParameters
from ft_mpc_torch.geometry.polytope import Polytope

DEFAULT_OMEGA = (0.0, 0.0, 0.6)
DEFAULT_R_DIR = (0.0, 1.0, 0.0)
DEFAULT_F_VIRT = 3.5

_OMEGA_MAGS = (0.4, 0.6, 0.9)
_F_VIRT_MAGS = (1.0, 1.75, 2.5, 3.5)
_COARSE_EMAX = np.linspace(0.02, 1.2, 15)


@dataclass
class OrbitChoice:
    omega_des: tuple
    r_dir: tuple
    f_virt_mag: float
    certifiable: bool
    is_default: bool
    r_empc: float  # certified eMPC input-ball radius (0 if uncertifiable)
    objective: float  # certificate log-volume objective (-inf if uncertifiable)


def _score(
    hull: Polytope,
    mass: float,
    inertia: np.ndarray,
    faulty_force_gen: np.ndarray,
    k_omega: np.ndarray,
    omega_des,
    r_dir,
    f_virt_mag: float,
    max_acceleration: float,
    emax_grid=None,
):
    """Certificate objective of one orbit candidate, or None if infeasible."""
    from ft_mpc_torch.terminal.pipeline import input_bound_box

    sp = SpiralParameters.compute(
        mass, inertia, faulty_force_gen, omega_des, r_dir, f_virt_mag
    )
    try:
        emax, r_empc = input_bound_box(
            hull, sp.M, np.concatenate([sp.f_virt, np.zeros(3)]),
            k_omega, sp.omega_des, sp.r, inertia, max_acceleration,
            emax_grid=emax_grid,
        )
    except RuntimeError:
        return None
    obj = 15.0 * np.log(r_empc) + float(np.sum(np.log(2.0 * k_omega * emax)))
    return obj, float(r_empc)


def _full_dimensional(hull: Polytope) -> bool:
    """Does any 6-d ball fit inside the hull?  A flat attainable set (a
    Chebyshev radius of about 0) certifies at no orbit."""
    try:
        _, radius = hull.chebyshev_center()
        return float(radius) > 1e-9
    except Exception:
        return False


def candidate_orbits(faulty_force_gen: np.ndarray):
    """The (omega_des, r_dir, f_virt_mag) grid searched for faulted patterns.

    Every omega_des is exactly perpendicular to its r_dir (the centripetal
    force cancels w x (w x r) only when w . r = 0): the coordinate axes are
    projected onto the plane perpendicular to r_dir and renormalized,
    duplicates and axes nearly parallel to r_dir dropped.
    """
    eyes = np.eye(3)
    r_dirs = [s * eyes[i] for i in range(3) for s in (1.0, -1.0)]
    f_lin = np.asarray(faulty_force_gen)[:3]
    if np.linalg.norm(f_lin) > 1e-9:
        r_dirs.append(f_lin / np.linalg.norm(f_lin))
    for rd in r_dirs:
        perp = []
        for e in eyes:
            w = e - float(e @ rd) * rd
            n = float(np.linalg.norm(w))
            if n < 0.35:
                continue
            w = w / n
            if any(abs(float(w @ p)) > 1.0 - 1e-9 for p in perp):
                continue
            perp.append(w)
        for ax in perp[:2]:
            for mag in _OMEGA_MAGS:
                for fmag in _F_VIRT_MAGS:
                    yield tuple(mag * ax), tuple(rd), fmag


def select_orbit(
    hull: Polytope,
    mass: float,
    inertia: np.ndarray,
    faulty_force_gen: np.ndarray,
    k_omega=(1.0, 1.0, 1.0),
    max_acceleration: float = 0.0,
) -> OrbitChoice:
    """The micro-orbit for one fault pattern: the default where it certifies,
    else the best candidate that certifies on the full emax grid, else the
    default with `certifiable=False` (callers fall back to the quadratic
    terminal)."""
    k_omega = np.asarray(k_omega, dtype=np.float64)
    inertia = np.asarray(inertia, dtype=np.float64)
    faulty_force_gen = np.asarray(faulty_force_gen, dtype=np.float64)
    uncertifiable = OrbitChoice(
        omega_des=DEFAULT_OMEGA, r_dir=DEFAULT_R_DIR,
        f_virt_mag=DEFAULT_F_VIRT, certifiable=False, is_default=True,
        r_empc=0.0, objective=-np.inf,
    )

    default = _score(
        hull, mass, inertia, faulty_force_gen, k_omega,
        DEFAULT_OMEGA, DEFAULT_R_DIR, DEFAULT_F_VIRT, max_acceleration,
    )
    if default is not None:
        return OrbitChoice(
            omega_des=DEFAULT_OMEGA, r_dir=DEFAULT_R_DIR,
            f_virt_mag=DEFAULT_F_VIRT, certifiable=True, is_default=True,
            r_empc=default[1], objective=default[0],
        )
    if not _full_dimensional(hull):
        return uncertifiable

    passing = []
    for omega_des, r_dir, fmag in candidate_orbits(faulty_force_gen):
        res = _score(
            hull, mass, inertia, faulty_force_gen, k_omega,
            omega_des, r_dir, fmag, max_acceleration,
            emax_grid=_COARSE_EMAX,
        )
        if res is not None:
            passing.append((res[0], omega_des, r_dir, fmag))

    # Coarse winners re-scored on the full grid, best first: a candidate that
    # passes only the coarse screen is never reported certifiable.
    for _, omega_des, r_dir, fmag in sorted(passing, key=lambda t: -t[0]):
        refined = _score(
            hull, mass, inertia, faulty_force_gen, k_omega,
            omega_des, r_dir, fmag, max_acceleration,
        )
        if refined is None:
            continue
        obj, r_empc = refined
        return OrbitChoice(
            omega_des=tuple(float(v) for v in omega_des),
            r_dir=tuple(float(v) for v in r_dir),
            f_virt_mag=float(fmag),
            certifiable=True, is_default=False,
            r_empc=r_empc, objective=obj,
        )
    return uncertifiable
