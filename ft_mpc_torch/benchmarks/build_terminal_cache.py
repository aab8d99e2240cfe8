"""Build the terminal cache of the whole fault census with the port's own
pipeline, counterpart of `benchmarks/build_terminal_cache.py`, and hold
every entry against the committed one.

For healthy, the 16 single and the 120 double faults at DEFAULT_TUNING on
the float32 plant (`BodyParams.default(0.1, torch.float32)`, whose entries
the committed cache holds) this runs the port's miss path,
`api.compute_empc_ingredients`: the fault-aware orbit search, then the
terminal pipeline with the value-function grid's QPs on the device.  Each
entry is written under the name the cache reads (`<key>.npz`,
`api._cache_name`) to the port's own cache (`build/terminal_cache/`) or
to `--out-dir`.  The committed cache (`ft_mpc_tpu/config/terminal_cache/`)
is read only, to compare; nothing is written or pruned there, and
`--prune-stale` deletes only entries of the directory this run wrote.

Each row holds the JAX script's fields (pattern, certified, r_empc,
orbit_default, omega_des, r_dir rounded to 4 places, f_virt_mag, secs) and
the comparison with the committed entry (ROADMAP C3's terms):
  * the orbit, emax, r_empc, uimax, the terminal set and the omega block of
    P9 equal, or the row fails;
  * a quadratic fallback's P9, p9 and c equal;
  * a certified entry's grid, as the run solved it on the device: its
    feasible points (r_prim < 1e-4) against those of the JAX package's float32 run
    (`ft_mpc_torch/data/terminal_grid_masks.npz`, see `load_grid_masks`),
    each point decided otherwise with its r_prim on both sides (the JAX
    side's where it lies within THRESHOLD_BAND of the threshold, else
    None); a point decided otherwise off that band fails the row;
  * the max difference of P9, p9 and c from the committed entry over
    max|P9|, for the port's own fit and for a fit of the port's values on
    the JAX run's points; the latter within FIT_TOL (rtol and atol FIT_TOL
    max|P9|, as tests/test_torch_pipeline.py holds it), or the row fails.
The summary counts the patterns certified at the default orbit, at a
searched orbit and uncertifiable, and the host seconds.

    python -m ft_mpc_torch.benchmarks.build_terminal_cache [--out-dir DIR]
        [--prune-stale] [--device cuda|cpu] [--out FILE]
    ft-mpc-torch-census-cache ...              # the same entry point

Prints a line a pattern and the summary without its rows as one JSON line,
last; --out writes the whole record.  Exits 1 when a row fails.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ft_mpc_torch.benchmarks import common

GRID_MASKS = Path(__file__).resolve().parents[1] / "data" / "terminal_grid_masks.npz"
THRESHOLD_BAND = 20.0  # a point decided otherwise has r_prim within 20x of 1e-4
FIT_TOL = 1e-3


def pattern_name(pattern) -> str:
    """'healthy', '3', '8_9': a pattern's thruster indices (ints or
    BrokenThruster) joined."""
    idx = [getattr(f, "index", f) for f in pattern]
    return "_".join(str(int(i)) for i in idx) if idx else "healthy"


class GridMask(NamedTuple):
    """The JAX package's float32 grid of one committed entry."""

    feasible: np.ndarray  # (M,) bool, r_prim < 1e-4
    band: dict  # point index -> r_prim, the points within THRESHOLD_BAND of 1e-4


def load_grid_masks(path=GRID_MASKS) -> dict[str, GridMask]:
    """{pattern name: GridMask} of the stored JAX runs.  The file holds
    `names`, `n_points`, `feasible` (a row of packed bits a name),
    `band_counts` (points a name) and, concatenated in that order,
    `band_idx` (uint16) and `band_r_prim` (float32)."""
    with np.load(path) as z:
        n = int(z["n_points"])
        feasible = np.unpackbits(z["feasible"], axis=1)[:, :n].astype(bool)
        ends = np.cumsum(z["band_counts"])
        idx = np.split(z["band_idx"].astype(np.int64), ends[:-1])
        r_prim = np.split(z["band_r_prim"].astype(np.float64), ends[:-1])
        return {str(k): GridMask(feasible=f, band=dict(zip(i.tolist(), r.tolist())))
                for k, f, i, r in zip(z["names"], feasible, idx, r_prim)}


def on_threshold(r_prim) -> bool:
    """Within THRESHOLD_BAND of the grid's feasibility threshold."""
    from ft_mpc_torch.terminal.pipeline import FEASIBLE_R_PRIM

    return r_prim is not None and abs(np.log(r_prim / FEASIBLE_R_PRIM)) <= np.log(THRESHOLD_BAND)


def fit_diff(P9, p9, c, ref) -> float:
    """max |difference| of P9, p9 and c from `ref`'s, over max|ref.P9|."""
    d = max(np.abs(P9 - ref.P9).max(), np.abs(p9 - ref.p9).max(), abs(c - ref.c))
    return float(d / np.abs(ref.P9).max())


def fit_close(P9, p9, c, ref, tol: float = FIT_TOL) -> bool:
    """P9, p9 and c within rtol `tol`, atol `tol` max|ref.P9| of `ref`'s."""
    atol = tol * float(np.abs(ref.P9).max())
    return bool(np.allclose(P9, ref.P9, rtol=tol, atol=atol)
                and np.allclose(p9, ref.p9, rtol=tol, atol=atol) and abs(c - ref.c) <= atol)


def census_row(pattern, ti, secs: float) -> dict:
    """The JAX script's row (`build_terminal_cache.py:65-77`)."""
    orbit = ti.meta.get("orbit", {})
    return {
        "pattern": [int(getattr(f, "index", f)) for f in pattern],
        "certified": "fallback" not in ti.meta,
        "r_empc": float(ti.r_empc),
        "orbit_default": bool(orbit.get("is_default", True)),
        "omega_des": orbit.get("omega_des"),
        "r_dir": [round(float(v), 4) for v in orbit.get("r_dir", [])],
        "f_virt_mag": orbit.get("f_virt_mag"),
        "secs": secs,
    }


def compare_entry(ti, ref, pattern, grid, masks: dict) -> dict:
    """`ti` (the port's entry of `pattern`, read back from its file) against
    `ref` (the committed one); `grid` is the value-function grid the run
    solved (`TerminalIngredients.grid`, None for a fallback); `ok` is False
    where the row fails (module docstring)."""
    from ft_mpc_torch.terminal import pipeline as tpl

    exact = bool(ti.meta.get("orbit") == ref.meta.get("orbit")
                 and ti.meta.get("fallback") == ref.meta.get("fallback")
                 and np.array_equal(ti.emax, ref.emax) and ti.r_empc == ref.r_empc
                 and ti.meta.get("uimax") == ref.meta.get("uimax")
                 and np.array_equal(ti.term_set.A, ref.term_set.A)
                 and np.array_equal(ti.term_set.b, ref.term_set.b)
                 and np.array_equal(ti.P9[6:, 6:], ref.P9[6:, 6:]))
    res = {"exact_parts_equal": exact, "n_grid": ti.meta.get("n_grid"),
           "n_grid_committed": ref.meta.get("n_grid"), "own_fit_rel_diff": fit_diff(
               ti.P9, ti.p9, ti.c, ref)}
    if "fallback" in ref.meta:
        res["fallback_equal"] = bool(np.array_equal(ti.P9, ref.P9)
                                     and np.array_equal(ti.p9, ref.p9) and ti.c == ref.c)
        res["ok"] = exact and res["fallback_equal"]
        return res
    res["ok"] = exact and grid is not None
    mask = masks.get(pattern_name(pattern))
    if mask is None or grid is None:  # no stored JAX run of this pattern, or no grid
        res["jax_points"] = False
        return res
    pts, V, r_prim = grid.points, grid.values, grid.r_prim
    mine = r_prim < tpl.FEASIBLE_R_PRIM
    differ = np.flatnonzero(mine != mask.feasible)
    res["jax_points"] = True
    res["n_grid_jax"] = int(mask.feasible.sum())
    res["grid_points_decided_otherwise"] = [
        {"point": pts[i].round(6).tolist(), "r_prim": float(r_prim[i]),
         "r_prim_jax": mask.band.get(int(i))} for i in differ]
    res["differ_on_threshold"] = all(on_threshold(p["r_prim"]) and on_threshold(p["r_prim_jax"])
                                     for p in res["grid_points_decided_otherwise"])
    P9, p9, c = tpl.quadratic_bound_blocks(
        *tpl.fit_quadratic_upper_bound(pts[mask.feasible], V[mask.feasible]), ref.P9[6:, 6:])
    res["fit_on_jax_points_rel_diff"] = fit_diff(P9, p9, c, ref)
    res["fit_on_jax_points_close"] = fit_close(P9, p9, c, ref)
    # with the same points the port's own fit is the committed one
    own_close = len(differ) > 0 or fit_close(ti.P9, ti.p9, ti.c, ref)
    res["ok"] = (res["ok"] and res["differ_on_threshold"] and res["fit_on_jax_points_close"]
                 and own_close)
    return res


def summary(rows: list[dict]) -> dict:
    """The JAX script's counts (`build_terminal_cache.py:96-106`) without its
    elapsed time."""
    return {
        "patterns": len(rows),
        "certified_default_orbit": sum(r["certified"] and r["orbit_default"] for r in rows),
        "certified_searched_orbit": sum(r["certified"] and not r["orbit_default"]
                                        for r in rows),
        "uncertifiable": sum(not r["certified"] for r in rows),
        "uncertifiable_patterns": [r["pattern"] for r in rows if not r["certified"]],
    }


def main(out_dir=None, device=None, out=None, patterns=None, prune_stale: bool = False) -> dict:
    """Build the entries of `patterns` (default the 137-pattern census) into
    `out_dir` (default `PORT_TERMINAL_CACHE`), each compared with the
    committed entry; returns the record (and writes it to `out`)."""
    from ft_mpc_torch import resolve_device
    from ft_mpc_torch.api import (
        DEFAULT_TUNING,
        TERMINAL_CACHE,
        _cache_name,
        compute_empc_ingredients,
    )
    from ft_mpc_torch.geometry.scenario import default_fault_pool
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.terminal.pipeline import (
        PORT_TERMINAL_CACHE,
        load_terminal_ingredients,
        save_terminal_ingredients,
    )

    dev = resolve_device(device)
    out_dir = Path(out_dir) if out_dir is not None else PORT_TERMINAL_CACHE
    if out_dir.resolve() == TERMINAL_CACHE.resolve():
        raise ValueError(f"{out_dir} is the committed cache, which this script never writes")
    ident = common.card_identity(dev)
    plant = BodyParams.default(common.DT, dtype=torch.float32, device=dev)
    masks = load_grid_masks()
    patterns = default_fault_pool() if patterns is None else patterns
    out_dir.mkdir(parents=True, exist_ok=True)

    rows, produced = [], set()
    t0 = time.perf_counter()
    for pattern in patterns:
        name = _cache_name(plant, pattern, DEFAULT_TUNING)
        t1 = time.perf_counter()
        built = compute_empc_ingredients(plant, pattern, DEFAULT_TUNING)
        save_terminal_ingredients(built, out_dir / name)
        common.sync(dev)
        ti = load_terminal_ingredients(out_dir / name)
        row = census_row(pattern, ti, time.perf_counter() - t1)
        produced.add(name)
        ref = load_terminal_ingredients(TERMINAL_CACHE / name)
        row["vs_committed"] = compare_entry(ti, ref, pattern, built.grid, masks)
        rows.append(row)
        cmp = row["vs_committed"]
        print(f"{row['pattern']}: certified={row['certified']} default_orbit="
              f"{row['orbit_default']} r_empc={row['r_empc']:.6f} ({row['secs']:.3f} s); "
              f"committed: {'ok' if cmp['ok'] else 'DIFFERS'}, decided otherwise "
              f"{len(cmp.get('grid_points_decided_otherwise', []))}, own fit "
              f"{cmp['own_fit_rel_diff']:.3e}", flush=True)
    host_s = time.perf_counter() - t0

    pruned = []
    if prune_stale:
        for f in sorted(out_dir.glob("*.npz")):
            if f.name not in produced:
                f.unlink()
                pruned.append(f.name)
    cmps = [r["vs_committed"] for r in rows]
    diff_fits = [c["fit_on_jax_points_rel_diff"] for c in cmps if c.get("jax_points")]
    record = {
        **summary(rows),
        "elapsed_s": host_s,
        "host_s_per_pattern_min_med_max": [float(f(np.array([r["secs"] for r in rows])))
                                           for f in (np.min, np.median, np.max)],
        "out_dir": str(out_dir),
        "pruned": pruned,
        "n_compared_with_jax_points": len(diff_fits),
        "points_decided_otherwise": sum(len(c.get("grid_points_decided_otherwise", []))
                                        for c in cmps),
        "patterns_with_points_decided_otherwise": [
            r["pattern"] for r in rows if r["vs_committed"].get("grid_points_decided_otherwise")],
        "max_own_fit_rel_diff": max(c["own_fit_rel_diff"] for c in cmps) if cmps else None,
        "max_fit_on_jax_points_rel_diff": max(diff_fits) if diff_fits else None,
        "patterns_without_jax_points": [r["pattern"] for r in rows if r["certified"]
                                        and not r["vs_committed"]["jax_points"]],
        "failed_rows": [r["pattern"] for r in rows if not r["vs_committed"]["ok"]],
        "rows": rows,
        **ident,
    }
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=None,
                    help="where the entries go (default build/terminal_cache/)")
    ap.add_argument("--prune-stale", action="store_true",
                    help="delete the entries of --out-dir that this run did not produce")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    record = main(out_dir=a.out_dir, device=a.device, out=a.out, prune_stale=a.prune_stale)
    print(json.dumps({k: v for k, v in record.items() if k != "rows"}))
    return 1 if record["failed_rows"] else 0


if __name__ == "__main__":
    raise SystemExit(cli())
