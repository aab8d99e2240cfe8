"""The port's offline tooling vs the JAX package: the orbit search, the
terminal pipeline and the 'empc' cache miss of `build_scenario_with_terminal`.

The same numpy inputs go through `ft_mpc_tpu` (x64, as its tests run) and
`ft_mpc_torch` on the CPU:
  * `select_orbit` field for field on healthy, (3), (8, 9), (12, 13) and
    (12, 15) with the float32 plant's constants (the committed cache's);
  * `input_bound_box` and `empc_ingredients` at atol 1e-10;
  * `sample_value_function` in float64 at grid step 0.5: V at atol 1e-8,
    the feasible mask equal;
  * `compute_terminal_ingredients` for tests/test_terminal.py's double
    fault at grid step 0.25 in float64, and an npz round trip;
  * a cache miss through `build_scenario_with_terminal` (a certified
    pattern and the quadratic fallback) into a temporary cache, never the
    JAX package's;
  * the committed float32 entries of healthy and (8, 9), reproduced by the
    port's float32 pipeline on the CPU: orbit, emax, r_empc, uimax and the
    terminal set exactly.  P9, p9 and c pass through the grid's float32 QPs:
    the points whose feasibility (r_prim < 1e-4) the two runs decide
    differently sit on that threshold and are named here; fitted on the
    committed run's feasible points, the port's values give P9, p9 and c
    within rtol 1e-3 (atol 1e-3 max|P9|, as p9 and c are about 0).
    `ft_mpc_torch/data/terminal_grid_masks.npz` holds the JAX package's
    float32 runs of every certified committed entry of the census: the
    feasible points and the r_prim of the points near the threshold
    (`write_grid_masks`, also `python tests/test_torch_pipeline.py`,
    regenerates it); a few of them are held against a fresh run here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
from ft_mpc_torch.benchmarks import build_terminal_cache as census
from ft_mpc_torch.controllers import orbit_search as torb
from ft_mpc_torch.controllers.spiral_params import SpiralParameters as TSpiral
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope as t_hull
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import host_array
from ft_mpc_torch.terminal import pipeline as tpl
from ft_mpc_torch.utils.faults import BrokenThruster as TBroken
from ft_mpc_tpu.controllers import orbit_search as jorb
from ft_mpc_tpu.geometry.polytope import Polytope as JPolytope
from ft_mpc_tpu.terminal import pipeline as jpl

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TERMINAL_CACHE = REPO / "ft_mpc_tpu" / "config" / "terminal_cache"
GRID_MASKS = REPO / "ft_mpc_torch" / "data" / "terminal_grid_masks.npz"
PATTERNS = {"healthy": [], "3": [3], "8_9": [8, 9], "12_13": [12, 13], "12_15": [12, 15]}
CACHED = ("healthy", "8_9")  # committed float32 entries reproduced below
# stored JAX grids held against a fresh run: the certified patterns that
# chip_smoke.py's census build (section 12b) compares, and one more searched orbit
MASKS_CHECKED = ("healthy", "0", "8_9", "5_10")
# grid points (x, v) whose feasibility the port's float32 run on this CPU
# decides otherwise than the committed run: r_prim within THRESHOLD_BAND of
# 1e-4 in both (here 7.8e-5..1.1e-4 against 8.9e-6..4.7e-4)
THRESHOLD_POINTS = {"healthy": [(-2.7, 0.3), (-2.1, 0.6), (2.1, -0.6), (2.7, -0.3)],
                    "8_9": []}
THRESHOLD_BAND = 20.0


def plant32():
    """(D, max_thrust, mass, inertia, dt) of the float32 plant, as the host
    arrays both packages build the committed cache from."""
    p = TBodyParams.default(0.1, torch.float32, "cpu")
    return (host_array(p.D), float(host_array(p.max_thrust)), float(host_array(p.mass)),
            host_array(p.inertia), float(host_array(p.dt)))


def pattern_hull(pat):
    """(hull, ff) of a fault pattern on the float32 plant (`api`'s miss path)."""
    D, mt, _, _, _ = plant32()
    ff = np.zeros(16)
    ff[pat] = mt
    return t_hull(D, mt, (ff > 0).astype(float), ff / mt), ff


@pytest.fixture(scope="module")
def port_orbits():
    D, _, mass, inertia, _ = plant32()
    out = {}
    for name, pat in PATTERNS.items():
        hull, ff = pattern_hull(pat)
        out[name] = (hull, ff, torb.select_orbit(hull, mass, inertia, D @ ff))
    return out


@pytest.mark.parametrize("name", list(PATTERNS))
def test_select_orbit_matches_jax(port_orbits, name):
    D, _, mass, inertia, _ = plant32()
    hull, ff, choice = port_orbits[name]
    ref = jorb.select_orbit(JPolytope(hull.A, hull.b), mass, inertia, D @ ff)
    assert dataclasses.asdict(choice) == dataclasses.asdict(ref)
    expect_default = name in ("healthy", "3", "12_13", "12_15")
    assert choice.is_default == expect_default
    assert choice.certifiable == (name not in ("12_13", "12_15"))


def _double_fault():
    """tests/test_terminal.py:25-32 (float64)."""
    p = TBodyParams.default(0.1, torch.float64, "cpu")
    D, inertia = host_array(p.D), host_array(p.inertia)
    ff = np.zeros(16)
    ff[10] = ff[11] = 3.4
    sp = TSpiral.compute(16.8, inertia, D @ ff)
    hull = t_hull(D, 3.4, (ff > 0).astype(float), ff / 3.4)
    return inertia, sp, hull


def test_input_bound_box_and_empc_match_jax():
    inertia, sp, hull = _double_fault()
    args = (sp.M, np.concatenate([sp.f_virt, np.zeros(3)]), np.ones(3), sp.omega_des,
            sp.r, inertia)
    emax, r_empc = tpl.input_bound_box(hull, *args, max_acceleration=0.05)
    jemax, jr_empc = jpl.input_bound_box(JPolytope(hull.A, hull.b), *args,
                                         max_acceleration=0.05)
    np.testing.assert_allclose(emax, jemax, rtol=0, atol=1e-10)
    assert abs(r_empc - jr_empc) <= 1e-10 and r_empc > 0
    e = tpl.empc_ingredients(1.0, 1.0, 0.7, 0.1, 5.0, r_empc / np.sqrt(3.0))
    je = jpl.empc_ingredients(1.0, 1.0, 0.7, 0.1, 5.0, jr_empc / np.sqrt(3.0))
    for f in ("Ad", "Bd", "Q", "R", "P", "K"):
        np.testing.assert_allclose(getattr(e, f), getattr(je, f), rtol=0, atol=1e-10,
                                   err_msg=f)
    assert e.domain.A.shape == je.domain.A.shape
    np.testing.assert_allclose(e.domain.A, je.domain.A, rtol=0, atol=1e-10)
    np.testing.assert_allclose(e.domain.b, je.domain.b, rtol=0, atol=1e-10)


def test_sample_value_function_matches_jax():
    """tests/test_terminal.py:151's grid, float64 on both sides."""
    e = tpl.empc_ingredients(1.0, 1.0, 0.5, 0.1, 5.0, uimax=0.3)
    je = jpl.empc_ingredients(1.0, 1.0, 0.5, 0.1, 5.0, uimax=0.3)
    pts, V, feas = tpl.sample_value_function(e, horizon=3, grid_step=0.5, device="cpu",
                                             dtype=torch.float64)
    jpts, jV, jfeas = jpl.sample_value_function(je, horizon=3, grid_step=0.5)
    print(f"n_grid: port {int(feas.sum())}, JAX {int(jfeas.sum())} of {len(pts)}")
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(feas, jfeas)
    assert feas.sum() >= 10
    np.testing.assert_allclose(V, jV, rtol=0, atol=1e-8)


def test_compute_terminal_ingredients_matches_jax(tmp_path):
    """tests/test_terminal.py:198-212 at grid step 0.25, float64; then the
    npz round trip, each package reading the other's file."""
    inertia, sp, hull = _double_fault()
    kw = dict(M=sp.M, f_virt6=np.concatenate([sp.f_virt, np.zeros(3)]),
              omega_des=sp.omega_des, r=sp.r, mass=16.8, inertia=inertia, dt=0.1,
              Q=np.array(DEFAULT_TUNING["Q"], dtype=np.float64),
              R=np.array(DEFAULT_TUNING["R"], dtype=np.float64), k_omega=np.ones(3),
              grid_step=0.25)
    ti = tpl.compute_terminal_ingredients(hull=hull, device="cpu", dtype=torch.float64,
                                          **kw)
    ref = jpl.compute_terminal_ingredients(hull=JPolytope(hull.A, hull.b), **kw)
    print(f"n_grid: port {ti.meta['n_grid']}, JAX {ref.meta['n_grid']}")
    assert ti.meta == ref.meta
    np.testing.assert_array_equal(ti.emax, ref.emax)
    assert ti.r_empc == ref.r_empc
    np.testing.assert_array_equal(ti.term_set.A, ref.term_set.A)
    np.testing.assert_array_equal(ti.term_set.b, ref.term_set.b)
    scale = np.abs(ref.P9).max()
    for got, want, name in ((ti.P9, ref.P9, "P9"), (ti.p9, ref.p9, "p9"),
                            (ti.c, ref.c, "c")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * scale, err_msg=name)
    for f in ti.term._fields:
        np.testing.assert_allclose(np.asarray(getattr(ti.term, f)),
                                   np.asarray(getattr(ref.term, f)), rtol=0,
                                   atol=1e-8 * scale, err_msg=f)

    tpl.save_terminal_ingredients(ti, tmp_path / "port.npz")
    jpl.save_terminal_ingredients(ref, tmp_path / "jax.npz")
    for back, orig in ((tpl.load_terminal_ingredients(tmp_path / "port.npz"), ti),
                       (jpl.load_terminal_ingredients(tmp_path / "port.npz"), ti),
                       (tpl.load_terminal_ingredients(tmp_path / "jax.npz"), ref)):
        assert back.meta == orig.meta and back.c == orig.c and back.r_empc == orig.r_empc
        for f in ("P9", "p9", "emax"):
            np.testing.assert_array_equal(getattr(back, f), getattr(orig, f))
        np.testing.assert_array_equal(back.term_set.A, orig.term_set.A)
        for f in ti.term._fields:
            np.testing.assert_array_equal(np.asarray(getattr(back.term, f)),
                                          np.asarray(getattr(orig.term, f)))


@pytest.mark.parametrize("pat", [[11], [12, 13]], ids=["11", "12_13"])
def test_cache_miss_matches_jax(tmp_path, monkeypatch, pat):
    """A float64 plant misses the committed cache on these patterns: the port
    computes (11) at the default orbit and falls back to the quadratic
    ingredients on (12, 13), writes one entry to its cache (here a temporary
    one; the committed cache is untouched), reads it back on the next build,
    and equals the JAX package's build (into its own temporary cache)."""
    from ft_mpc_torch import api
    from ft_mpc_tpu.api import _build_scenario_with_terminal
    from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
    from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken

    monkeypatch.setattr(api, "PORT_TERMINAL_CACHE", tmp_path / "port")
    committed = sorted(p.name for p in TERMINAL_CACHE.iterdir())
    tp = TBodyParams.default(0.1, torch.float64, "cpu")
    faults = [TBroken(i, 1.0) for i in pat]
    assert api.cached_terminal_path(tp, faults, DEFAULT_TUNING) is None
    sc = build_scenario_with_terminal(tp, faults, DEFAULT_TUNING, device="cpu",
                                      dtype=torch.float64)
    written = sorted((tmp_path / "port").iterdir())
    assert len(written) == 1
    assert api.cached_terminal_path(tp, faults, DEFAULT_TUNING) == written[0]
    again = build_scenario_with_terminal(tp, faults, DEFAULT_TUNING, device="cpu",
                                         dtype=torch.float64)
    assert sorted((tmp_path / "port").iterdir()) == written
    assert sorted(p.name for p in TERMINAL_CACHE.iterdir()) == committed

    meta = tpl.load_terminal_ingredients(written[0]).meta
    assert ("fallback" in meta) == (pat == [12, 13])
    ref = _build_scenario_with_terminal(JBodyParams.default(0.1), [JBroken(i, 1.0) for i in pat],
                                        DEFAULT_TUNING, cache_dir=str(tmp_path / "jax"))
    flat, jflat, flat2 = (flatten_namedtuple(s) for s in (sc, ref, again))
    assert sorted(flat) == sorted(jflat)
    scale = float(np.abs(jflat["term.P"]).max())
    for k in jflat:
        np.testing.assert_allclose(flat[k], np.asarray(jflat[k], dtype=flat[k].dtype),
                                   rtol=0, atol=1e-8 * scale, err_msg=k)
        np.testing.assert_array_equal(flat2[k], flat[k], err_msg=k)


def _jax_empc(hull, ff, orbit, plant):
    """The JAX package's eMPC of `compute_terminal_ingredients` at `orbit`
    (its steps before the grid)."""
    from ft_mpc_tpu.controllers.spiral_params import SpiralParameters as JSpiral

    D, _, mass, inertia, dt = plant
    sp = JSpiral.compute(mass, inertia, D @ ff, orbit["omega_des"], orbit["r_dir"],
                         orbit["f_virt_mag"])
    R = np.diag(np.asarray(DEFAULT_TUNING["R"], dtype=np.float64))
    _, r_empc = jpl.input_bound_box(
        hull, sp.M, np.concatenate([sp.f_virt, np.zeros(3)]), np.ones(3), sp.omega_des,
        sp.r, inertia)
    Minv = np.linalg.inv(sp.M)
    r_in = float(np.max(np.linalg.eigvalsh((Minv.T @ R @ Minv)[0:3, 0:3])))
    return jpl.empc_ingredients(1.0, 1.0, r_in, dt, 5.0, r_empc / np.sqrt(3.0))


def _pattern(name) -> list[int]:
    return [] if name == "healthy" else [int(i) for i in name.split("_")]


def _committed(name):
    from ft_mpc_torch.api import terminal_cache_path

    tp = TBodyParams.default(0.1, torch.float32, "cpu")
    path = terminal_cache_path(tp, [TBroken(i, 1.0) for i in _pattern(name)], DEFAULT_TUNING)
    return tpl.load_terminal_ingredients(path)


def certified_census() -> list[str]:
    """The names of the census patterns whose committed entry is certified."""
    from ft_mpc_torch.geometry.scenario import default_fault_pool

    names = [census.pattern_name(f) for f in default_fault_pool()]
    return [n for n in names if "fallback" not in _committed(n).meta]


def _fit_blocks(fit, pts, V, mask, P_om):
    """(P9, p9, c) of a package's quadratic fit over the points of `mask`."""
    return tpl.quadratic_bound_blocks(*fit(pts[mask], V[mask]), P_om)


def _jax_grid(empc):
    """`jpl.sample_value_function(empc, 3)`: points, values, the feasible
    mask, and each point's r_prim, the output of its batched solve caught as
    the vmapped solve returns it (the function keeps only the mask)."""
    caught = {}
    vmap = jax.vmap

    def catching(fn, *args, **kw):
        solve = vmap(fn, *args, **kw)

        def run(*a):
            caught["sol"] = out = solve(*a)
            return out
        return run

    jax.vmap = catching
    try:
        pts, V, feas = jpl.sample_value_function(empc, 3)
    finally:
        jax.vmap = vmap
    r_prim = np.asarray(caught["sol"].r_prim)
    np.testing.assert_array_equal(feas, r_prim < tpl.FEASIBLE_R_PRIM)
    return pts, V, feas, r_prim


def jax_grid_masks(names=CACHED) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """{name: (feasible, r_prim)} of the committed float32 entries of
    `names`, by the JAX package in float32 (64-bit mode off, as the cache
    was built), with each entry's fit reproduced from them."""
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        masks = {}
        for name in names:
            hull, ff = pattern_hull(_pattern(name))
            ref = _committed(name)
            empc = _jax_empc(JPolytope(hull.A, hull.b), ff, ref.meta["orbit"], plant32())
            pts, V, feas, r_prim = _jax_grid(empc)
            P, p, c = _fit_blocks(jpl.fit_quadratic_upper_bound, pts, V, feas, ref.P9[6:, 6:])
            assert int(feas.sum()) == ref.meta["n_grid"], name
            np.testing.assert_allclose(P, ref.P9, rtol=1e-12, atol=0, err_msg=name)
            masks[name] = (feas, r_prim.astype(np.float32))
        return masks
    finally:
        jax.config.update("jax_enable_x64", x64)


def band(r_prim: np.ndarray) -> np.ndarray:
    """The points whose r_prim lies within THRESHOLD_BAND of the threshold."""
    with np.errstate(divide="ignore"):
        return np.flatnonzero(np.abs(np.log(r_prim / tpl.FEASIBLE_R_PRIM))
                              <= np.log(census.THRESHOLD_BAND))


def write_grid_masks(path=GRID_MASKS, names=None) -> None:
    """The JAX runs of `names` (default every certified census pattern) in
    `census.load_grid_masks`'s format."""
    masks = jax_grid_masks(certified_census() if names is None else names)
    bands = [band(r_prim) for _, r_prim in masks.values()]
    np.savez_compressed(
        path, names=np.array(list(masks)),
        n_points=np.int64(len(next(iter(masks.values()))[0])),
        feasible=np.stack([np.packbits(feas) for feas, _ in masks.values()]),
        band_counts=np.array([len(i) for i in bands], np.int64),
        band_idx=np.concatenate(bands).astype(np.uint16),
        band_r_prim=np.concatenate([r[i] for (_, r), i in zip(masks.values(), bands)]))


def load_grid_masks() -> dict[str, np.ndarray]:
    stored = census.load_grid_masks()
    return {k: stored[k].feasible for k in CACHED}


def test_grid_masks_match_jax():
    stored = census.load_grid_masks()
    assert sorted(stored) == sorted(certified_census())
    fresh = jax_grid_masks(MASKS_CHECKED)
    for name in MASKS_CHECKED:
        feas, r_prim = fresh[name]
        np.testing.assert_array_equal(stored[name].feasible, feas, err_msg=name)
        idx = band(r_prim)
        assert sorted(stored[name].band) == idx.tolist(), name
        np.testing.assert_allclose([stored[name].band[i] for i in idx], r_prim[idx],
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", CACHED)
def test_committed_cache_float32(port_orbits, name):
    hull, ff, choice = port_orbits[name]
    ref = _committed(name)
    orbit = ref.meta["orbit"]
    assert (list(choice.omega_des), list(choice.r_dir), choice.f_virt_mag,
            choice.is_default) == (orbit["omega_des"], orbit["r_dir"],
                                   orbit["f_virt_mag"], orbit["is_default"])
    D, _, mass, inertia, dt = plant32()
    sp = TSpiral.compute(mass, inertia, D @ ff, choice.omega_des, choice.r_dir,
                         choice.f_virt_mag)
    ti = tpl.compute_terminal_ingredients(
        hull=hull, M=sp.M, f_virt6=np.concatenate([sp.f_virt, np.zeros(3)]),
        omega_des=sp.omega_des, r=sp.r, mass=mass, inertia=inertia, dt=dt,
        Q=np.asarray(DEFAULT_TUNING["Q"], dtype=np.float64),
        R=np.asarray(DEFAULT_TUNING["R"], dtype=np.float64), k_omega=[1.0, 1.0, 1.0],
        device="cpu", dtype=torch.float32,
    )
    # the host-numpy parts: exact
    np.testing.assert_array_equal(ti.emax, ref.emax)
    assert ti.r_empc == ref.r_empc and ti.meta["uimax"] == ref.meta["uimax"]
    np.testing.assert_array_equal(ti.term_set.A, ref.term_set.A)
    np.testing.assert_array_equal(ti.term_set.b, ref.term_set.b)
    np.testing.assert_array_equal(ti.P9[6:, 6:], ref.P9[6:, 6:])

    # the grid: points decided otherwise sit on the threshold, and are named
    empc = tpl.axis_empc(hull, sp.M, np.concatenate([sp.f_virt, np.zeros(3)]), sp.omega_des,
                         sp.r, inertia, dt, DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                         np.ones(3))[2]
    pts, V, r_prim = tpl.value_function_grid(empc, 3, device="cpu", dtype=torch.float32)
    mine = r_prim < tpl.FEASIBLE_R_PRIM
    theirs = load_grid_masks()[name]
    differ = np.flatnonzero(mine != theirs)
    print(f"{name}: n_grid port {int(mine.sum())}, committed {ref.meta['n_grid']}; "
          f"decided otherwise: {pts[differ].round(6).tolist()} at r_prim "
          f"{r_prim[differ].tolist()}")
    assert int(mine.sum()) == ti.meta["n_grid"]
    assert sorted(map(tuple, pts[differ].round(6))) == sorted(THRESHOLD_POINTS[name])
    assert np.all(np.abs(np.log(r_prim[differ] / tpl.FEASIBLE_R_PRIM))
                  <= np.log(THRESHOLD_BAND))

    P, p, c = _fit_blocks(tpl.fit_quadratic_upper_bound, pts, V, theirs, ref.P9[6:, 6:])
    tol = 1e-3 * np.abs(ref.P9).max()
    np.testing.assert_allclose(P, ref.P9, rtol=1e-3, atol=tol)
    np.testing.assert_allclose(p, ref.p9, rtol=1e-3, atol=tol)
    assert abs(c - ref.c) <= tol
    if not len(differ):  # same points: the port's own entry is the committed one
        np.testing.assert_allclose(ti.P9, ref.P9, rtol=1e-3, atol=tol)
        np.testing.assert_allclose(ti.p9, ref.p9, rtol=1e-3, atol=tol)
        assert abs(ti.c - ref.c) <= tol


if __name__ == "__main__":
    write_grid_masks()
