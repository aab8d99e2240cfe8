"""The port's census cache build (`ft_mpc_torch.benchmarks.build_terminal_cache`)
against the JAX package's (`benchmarks/build_terminal_cache.py`) and the
committed cache, on the CPU.

  * The rows of healthy, (8, 9) (a searched orbit) and (12, 13) (the
    quadratic fallback) equal ORBITS_r04.json's rows exactly, but for
    `secs`; each entry equals the committed one in its orbit, emax, r_empc
    and terminal set, and its grid, fitted on the JAX run's points, within
    1e-3; the points decided otherwise are those of
    tests/test_torch_pipeline.py (on the threshold), read from the grid the
    entry was fitted on;
  * nothing is written under `ft_mpc_tpu/config/terminal_cache/` (its
    listing and mtimes unchanged), the entries go where the cache reads
    them, `--prune-stale` deletes only stale entries of its own directory,
    and the committed cache is refused as an output;
  * the summary's counts, and without a card `main` refuses to run unless
    the CPU is asked for.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_mpc_torch.api import DEFAULT_TUNING, TERMINAL_CACHE, cached_terminal_path
from ft_mpc_torch.benchmarks import build_terminal_cache as census
from ft_mpc_torch.ops.dynamics import BodyParams
from ft_mpc_torch.utils.faults import BrokenThruster
from test_torch_pipeline import THRESHOLD_POINTS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PATTERNS = ([], [8, 9], [12, 13])


def faults(pattern):
    return [BrokenThruster(i, 1.0) for i in pattern]


def listing(d: Path) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in sorted(d.iterdir())}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("census")
    other = tmp_path_factory.mktemp("other")
    (out_dir / "stale.npz").write_bytes(b"old")
    (other / "keep.npz").write_bytes(b"old")
    before = listing(TERMINAL_CACHE)
    rec = census.main(out_dir=out_dir, device="cpu", patterns=[faults(p) for p in PATTERNS],
                      prune_stale=True, out=out_dir / "census.json")
    return rec, out_dir, other, before


def test_rows_equal_the_committed_census(built):
    rec = built[0]
    committed = {tuple(r["pattern"]): r for r in json.loads(
        (REPO / "ORBITS_r04.json").read_text())["rows"]}
    assert [r["pattern"] for r in rec["rows"]] == [list(p) for p in PATTERNS]
    for row in rec["rows"]:
        want = {k: v for k, v in committed[tuple(row["pattern"])].items() if k != "secs"}
        got = {k: v for k, v in row.items() if k not in ("secs", "vs_committed")}
        assert got == want, row["pattern"]
        assert row["secs"] > 0


def test_entries_equal_the_committed_ones(built):
    rec = built[0]
    by = {tuple(r["pattern"]): r["vs_committed"] for r in rec["rows"]}
    assert all(c["ok"] and c["exact_parts_equal"] for c in by.values())
    assert by[(12, 13)]["fallback_equal"]
    for pat, name in (((), "healthy"), ((8, 9), "8_9")):
        c = by[pat]
        assert c["jax_points"] and c["differ_on_threshold"]
        assert c["fit_on_jax_points_close"] and c["fit_on_jax_points_rel_diff"] <= 1e-3
        # the grid compared is the one the entry was fitted on: its feasible
        # count is the JAX run's moved by the points decided otherwise
        moved = sum(1 if p["r_prim"] < 1e-4 else -1 for p in c["grid_points_decided_otherwise"])
        assert c["n_grid"] == c["n_grid_jax"] + moved
        points = sorted(tuple(p["point"]) for p in c["grid_points_decided_otherwise"])
        assert points == sorted(THRESHOLD_POINTS[name])
        for p in c["grid_points_decided_otherwise"]:  # each side's r_prim on the threshold
            assert census.on_threshold(p["r_prim"]) and census.on_threshold(p["r_prim_jax"])
    assert rec["failed_rows"] == [] and rec["patterns_without_jax_points"] == []
    assert rec["n_compared_with_jax_points"] == 2
    assert rec["max_fit_on_jax_points_rel_diff"] <= 1e-3


def test_a_certified_entry_needs_its_grid():
    """An entry read from a file keeps no grid, and a certified entry
    compared without the grid its run solved fails its row."""
    plant = BodyParams.default(0.1, torch.float32, "cpu")
    from ft_mpc_torch.terminal.pipeline import load_terminal_ingredients

    ref = load_terminal_ingredients(cached_terminal_path(plant, [], DEFAULT_TUNING))
    assert ref.grid is None
    c = census.compare_entry(ref, ref, [], None, census.load_grid_masks())
    assert c["exact_parts_equal"] and not c["ok"] and not c["jax_points"]


def test_summary_counts(built):
    rec = built[0]
    assert (rec["patterns"], rec["certified_default_orbit"], rec["certified_searched_orbit"],
            rec["uncertifiable"]) == (3, 1, 1, 1)
    assert rec["uncertifiable_patterns"] == [[12, 13]]
    assert rec["elapsed_s"] >= sum(r["secs"] for r in rec["rows"])
    assert rec["device"] == "cpu" and rec["card"] is None
    assert census.summary([]) == {"patterns": 0, "certified_default_orbit": 0,
                                  "certified_searched_orbit": 0, "uncertifiable": 0,
                                  "uncertifiable_patterns": []}


def test_writes_only_its_own_directory(built):
    rec, out_dir, other, before = built
    assert listing(TERMINAL_CACHE) == before
    plant = BodyParams.default(0.1, torch.float32, "cpu")
    names = sorted(cached_terminal_path(plant, faults(p), DEFAULT_TUNING, out_dir).name
                   for p in PATTERNS)
    assert sorted(p.name for p in out_dir.glob("*.npz")) == names
    assert rec["pruned"] == ["stale.npz"]
    assert (other / "keep.npz").read_bytes() == b"old"
    assert json.loads((out_dir / "census.json").read_text())["rows"] == rec["rows"]
    # the port's cache reads the entries back, equal to the committed ones
    from ft_mpc_torch.terminal.pipeline import load_terminal_ingredients

    for p in PATTERNS:
        mine = load_terminal_ingredients(cached_terminal_path(plant, faults(p), DEFAULT_TUNING,
                                                              out_dir))
        ref = load_terminal_ingredients(cached_terminal_path(plant, faults(p), DEFAULT_TUNING))
        assert ref.meta["orbit"] == mine.meta["orbit"]
        np.testing.assert_array_equal(mine.term_set.A, ref.term_set.A)


def test_refuses_the_committed_cache():
    before = listing(TERMINAL_CACHE)
    for out_dir in (TERMINAL_CACHE, REPO / "ft_mpc_tpu" / "config" / ".." / "config" /
                    "terminal_cache"):
        with pytest.raises(ValueError, match="committed cache"):
            census.main(out_dir=out_dir, device="cpu", patterns=[[]], prune_stale=True)
    assert listing(TERMINAL_CACHE) == before


def test_cli_exit_code(monkeypatch, tmp_path, capsys):
    """The CLI over a census cut to one pattern (monkeypatched), its summary
    printed last; a failing row exits 1."""
    import ft_mpc_torch.geometry.scenario as scenario

    monkeypatch.setattr(scenario, "default_fault_pool", lambda: [faults([12, 13])])
    assert census.cli(["--out-dir", str(tmp_path), "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["patterns"] == 1 and "rows" not in last and last["failed_rows"] == []
    real = census.compare_entry
    monkeypatch.setattr(census, "compare_entry", lambda *a, **k: {**real(*a, **k), "ok": False})
    assert census.cli(["--out-dir", str(tmp_path), "--device", "cpu"]) == 1


def test_grid_mask_file_covers_the_certified_census():
    masks = census.load_grid_masks()
    assert len(masks) == 133
    assert {"healthy", "0", "8_9"} <= set(masks) and "12_13" not in masks
    for m in masks.values():
        assert m.feasible.shape == (3131,)
        assert all(census.on_threshold(r) for r in m.band.values())
        # the stored band agrees with the mask: r_prim < 1e-4 exactly where feasible
        assert all(m.feasible[i] == (r < 1e-4) for i, r in m.band.items())


def test_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        census.main()
