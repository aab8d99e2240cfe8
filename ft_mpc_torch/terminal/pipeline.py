"""Terminal ingredients per fault class: the container, its data-only npz
serialization and the cache key, counterpart of the cache half of
`ft_mpc_tpu/terminal/pipeline.py` (host numpy).

The port reads the JAX package's terminal cache
(`ft_mpc_tpu/config/terminal_cache/`, one npz per (fault pattern, tuning,
plant)); `cache_key` and `plant_fingerprint` reproduce its keys byte for
byte.  Computing ingredients for a pattern the cache lacks (the offline
pipeline: input-bound box, eMPC value function, MCAIS) is not ported yet
(ROADMAP A12b); `save_terminal_ingredients` writes the same format for it.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ft_mpc_torch.geometry.polytope import Polytope
from ft_mpc_torch.terminal.poly import TerminalPoly, quadratic_terminal


@dataclass
class TerminalIngredients:
    P9: np.ndarray  # (9, 9) quadratic part (cost_empc + cost_omega)
    p9: np.ndarray  # (9,)
    c: float
    term: TerminalPoly  # full certified cost incl. cross_1/cross_2 tables
    term_set: Polytope  # over the 9-d error
    emax: np.ndarray  # (3,)
    r_empc: float
    meta: dict


def save_terminal_ingredients(ti: TerminalIngredients, path: str | Path) -> None:
    np.savez(
        path,
        P9=ti.P9,
        p9=ti.p9,
        c=ti.c,
        poly_P=np.asarray(ti.term.P),
        poly_p=np.asarray(ti.term.p),
        poly_const=np.asarray(ti.term.c),
        poly_c=np.asarray(ti.term.poly_c),
        poly_pow=np.asarray(ti.term.poly_pow),
        sqrt_c=np.asarray(ti.term.sqrt_c),
        sqrt_pow=np.asarray(ti.term.sqrt_pow),
        app=np.asarray(ti.term.app),
        term_A=ti.term_set.A,
        term_b=ti.term_set.b,
        emax=ti.emax,
        r_empc=ti.r_empc,
        meta=json.dumps(ti.meta),
    )


def load_terminal_ingredients(path: str | Path) -> TerminalIngredients:
    z = np.load(path, allow_pickle=False)
    if "poly_P" in z:
        term = TerminalPoly(
            P=z["poly_P"], p=z["poly_p"], c=z["poly_const"],
            poly_c=z["poly_c"], poly_pow=z["poly_pow"],
            sqrt_c=z["sqrt_c"], sqrt_pow=z["sqrt_pow"], app=z["app"],
        )
    else:  # a first-format entry (quadratic only)
        term = quadratic_terminal(z["P9"], z["p9"], float(z["c"]))
    return TerminalIngredients(
        P9=z["P9"],
        p9=z["p9"],
        c=float(z["c"]),
        term=term,
        term_set=Polytope(z["term_A"], z["term_b"]),
        emax=z["emax"],
        r_empc=float(z["r_empc"]),
        meta=json.loads(str(z["meta"])),
    )


def cache_key(fault_pattern, tuning: dict, plant: dict | None = None) -> str:
    """Stable key for the per-fault-class cache.

    `plant` carries the physical identity (mass, inertia, dt, D, ...) so
    different vehicles with the same tuning never collide.  The JSON payload
    is the JAX package's exactly: sorted keys, `default=float`, `sqp_iters`
    left out, and tuning values as given (5 and 5.0 give different keys).
    """
    payload = json.dumps(
        {
            # cache format version (v3: fault-aware orbit selection)
            "v": 3,
            "faults": sorted((int(f.index), float(f.intensity)) for f in fault_pattern),
            "tuning": {k: tuning[k] for k in sorted(tuning) if k != "sqp_iters"},
            "plant": plant or {},
        },
        sort_keys=True,
        default=float,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def plant_fingerprint(params) -> dict:
    """Cache-key identity of a plant, from its leaves in their own dtype.

    `params` is a `BodyParams` of tensors (any device) or of numpy arrays.
    Each leaf is read back as a numpy array of its own dtype, so a float32
    plant fingerprints as the JAX package's float32 plant does (mass
    16.799999237060547, and `round(12)` done in float32).
    """
    from ft_mpc_torch.ops.dynamics import host_array

    return {
        "mass": float(host_array(params.mass)),
        "inertia": host_array(params.inertia).round(12).tolist(),
        "dt": float(host_array(params.dt)),
        "max_thrust": float(host_array(params.max_thrust)),
        "D": host_array(params.D).round(12).tolist(),
    }
