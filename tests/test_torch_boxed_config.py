"""The benchmark's boxed configuration and its two newer cells.

  * both cells load from the committed `BENCHMARK.json` by name:
    `boxed_h15` adds 532 dense rows after the 64 terminal ones (T = 596),
    the census traffic is `sanitizer.census()` in order at B=137 with a
    cleanup of K=17, and `boxed_h15` is a configuration of its own (its
    source and reduced keys are no other configuration's);
  * a tiny traced run of the committed `boxed_h15` (four craft, two
    periods) is correct, carries the duals of 596 dense rows, opens
    `ft_mpc.ext_rows` in every period, and reports `ext_rows_self_ms` as
    the recorder's mean over the untraced window;
  * a tiny traced run of `condensed_h15` opens no `ft_mpc.ext_rows`, and the
    reader reads nothing there;
  * a tiny cell of four census patterns, a double fault among them, from
    the sanitizer's near-orbit starts is correct;
  * on the card (marked `cuda`, skipped elsewhere): at each fleet cell's own
    limits, named by file, the program passes and the TF32 control fails.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from ft_mpc_torch.utils import logging as L

ROOT = Path(__file__).resolve().parent.parent
SPAN = "ft_mpc.ext_rows"
BOXED, CENSUS = "boxed_h15.fleet2048_closed", "condensed_h15.census137_closed"
NEAR_ORBIT = {"kind": "near_orbit", "pos": 0.5, "vel": 0.2, "omega": 0.3}
CENSUS4 = [[], [7], [2, 13], [10, 11]]  # census patterns: healthy, a single, two doubles


def _harness_tests():
    """The benchmark's own CPU test module (for its tiny cells)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_harness_tests", ROOT / "perfbench" / "tests" / "test_perfbench_harness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _tiny(tmp: Path, config: str, **kw):
    """A tiny traced run of `config`: (result, info, the recorder's periods,
    the `ext_rows_self_ms` reader's reading), read before anything else runs."""
    from perfbench import run as bench_run
    from perfbench.metrics import ext_rows_self_ms

    L.RECORDER.reset()
    L.enable(True)
    name, bench, data = _harness_tests().tiny_cell(tmp, config=config, **kw)
    traffic = json.loads((data / "traffic" / "tiny4.json").read_text())
    result, lines, info = bench_run.run(name, 2**33 + 7, 1e9, True, torch.device("cpu"), bench,
                                        data, max_periods=2, keep=True)
    run = SimpleNamespace(window_periods=info["periods"], periods=traffic["traced_periods"])
    return SimpleNamespace(result=result, lines=lines, info=info, traffic=traffic,
                           periods=L.RECORDER.periods(), read=ext_rows_self_ms.read(run))


@pytest.fixture(scope="module")
def boxed(tmp_path_factory):
    return _tiny(tmp_path_factory.mktemp("boxed"), "boxed_h15")


@pytest.fixture(scope="module")
def census4(tmp_path_factory):
    return _tiny(tmp_path_factory.mktemp("census4"), "condensed_h15", initial=NEAR_ORBIT,
                 patterns=CENSUS4)


# ---------------------------------------------------------------------------
# the committed cells
# ---------------------------------------------------------------------------


def test_the_boxed_cell_loads_with_its_bound_rows():
    from perfbench import cell as cells

    c = cells.load(BOXED)
    assert c.entry["config"] == "boxed_h15" and c.entry["chips"] == 1
    assert cells.extra_rows(c.config) == 532
    assert c.config["padding"]["terminal_rows"] + cells.extra_rows(c.config) == 596
    bounds = cells.weight_bounds(c.config)
    assert bounds["x_lb"] is None and bounds["du_max"] == [2, 2, 2, 1, 1, 1]
    assert bounds["x_ub"] == [1e8] * 3 + [0.5] * 3 + [1e8] * 7
    # the traffic is the unboxed cell's, so the two differ by the bounds alone
    unboxed = cells.load("condensed_h15.fleet2048_closed")
    assert c.traffic == unboxed.traffic
    differ = {k for k in set(c.config) | set(unboxed.config)
              if c.config.get(k) != unboxed.config.get(k)}
    assert differ <= {"name", "source", "source_parts", "deployment", "guarantees", "weights",
                      "assumed"}
    assert {k: v for k, v in c.config["weights"].items() if k in ("Q", "R")} == \
        unboxed.config["weights"]
    assert {m["name"] for m in c.per_layer} >= {"ext_rows_self_ms", "admm_roofline",
                                                "sync_wait_ms", "device_idle_share",
                                                "kinv_rescues_per_step"}


def test_the_census_cell_flies_the_whole_census_in_order():
    from ft_mpc_torch.benchmarks import sanitizer
    from perfbench import cell as cells, plant

    c = cells.load(CENSUS)
    census = [[f.index for f in p] for p in sanitizer.census()]
    assert c.traffic["patterns"] == census and len(census) == 137
    assert c.traffic["batch"] == 137 and cells.bank_rows(c.traffic) == list(range(137))
    assert cells.cleanup_k(c.config, c.traffic["batch"]) == 17
    assert c.traffic["initial_state"] == NEAR_ORBIT
    assert plant.initial_states(c.traffic["initial_state"], 137, sanitizer.SEED).tobytes() == \
        sanitizer.x0_states(137).tobytes()
    assert cells.extra_rows(c.config) == 0
    assert "ext_rows_self_ms" not in {m["name"] for m in c.per_layer}
    assert "kinv_rescues_per_step" in {m["name"] for m in c.per_layer}


def test_the_boxed_configuration_is_a_configuration_of_its_own():
    bench = _bench()
    (boxed,) = [c for c in bench["configs"] if c["name"] == "boxed_h15"]
    pair = lambda c: (c["source"], tuple(c["reduced"]))
    assert all(pair(c) != pair(boxed) for c in bench["configs"] if c is not boxed)
    assert "spiraling_mpc.py" in boxed["source"] and boxed["reduced"] == []
    data = json.loads((ROOT / boxed["file"]).read_text())
    assert data["source"] == boxed["source"] and data["reduced"] == []


def test_the_new_cells_are_read_where_the_fleet_cell_is():
    bench = _bench()
    assert {CENSUS, BOXED} <= {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        listed = set(m.get("workloads", []))
        if "condensed_h15.fleet2048_closed" in listed:
            assert {CENSUS, BOXED} <= listed, m["name"]
    (ext,) = [m for m in bench["per_layer"] if m["name"] == "ext_rows_self_ms"]
    assert ext["workloads"] == [BOXED]
    # the tiny cells take whichever condensed check file they find first
    keys = {p.name: list(json.loads(p.read_text()))
            for p in (ROOT / "perfbench" / "checks").glob("*.json")}
    assert len({tuple(v) for v in keys.values()}) == 1, keys


# ---------------------------------------------------------------------------
# tiny runs: the span and its reader
# ---------------------------------------------------------------------------


def test_a_tiny_boxed_run_is_correct_with_its_596_rows(boxed):
    assert boxed.result["correct"], boxed.lines
    later = [k for k in boxed.info["kept"] if k.warm_in is not None]
    assert later and all(k.warm_in.y_term.shape == (4, 596) for k in later)


def test_a_tiny_boxed_run_opens_ext_rows_every_period(boxed):
    t = boxed.traffic
    assert len(boxed.periods) == t["warmup_periods"] + boxed.info["periods"] + t["traced_periods"]
    # the main SQP's and the cleanup's assembly and line search
    assert all(p.count(SPAN) == 6 for p in boxed.periods), [p.count(SPAN) for p in boxed.periods]
    assert all(0 < p.self_ns(SPAN) <= p.host_ns(SPAN) for p in boxed.periods)


def test_ext_rows_self_ms_reads_the_untraced_window(boxed):
    warm, window = boxed.traffic["warmup_periods"], boxed.info["periods"]
    untraced = boxed.periods[warm:warm + window]
    want = sum(1e-6 * p.self_ns(SPAN) for p in untraced) / window
    assert want > 0
    assert boxed.read == pytest.approx(want, rel=1e-12)
    assert boxed.result["metrics"]["ext_rows_self_ms"] == {"value": pytest.approx(want, rel=1e-12),
                                                          "unit": "ms"}


def test_the_unboxed_path_opens_no_ext_rows(census4):
    assert not any(p.count(SPAN) for p in census4.periods)
    assert census4.read is None
    assert "ext_rows_self_ms" not in census4.result["metrics"]
    assert census4.result["metrics"]["host_syncs_per_step"]["value"] > 0
    later = [k for k in census4.info["kept"] if k.warm_in is not None]
    assert later and all(k.warm_in.y_term.shape == (4, 64) for k in later)


def test_a_tiny_near_orbit_census_cell_is_correct(census4):
    from perfbench import plant

    assert census4.traffic["patterns"] == CENSUS4
    assert census4.result["correct"], census4.lines
    x0 = census4.info["kept"][0].x
    assert torch.equal(x0.cpu(), torch.as_tensor(plant.near_orbit_x0(4, 2**33 + 7, 0.5, 0.2, 0.3)))


# ---------------------------------------------------------------------------
# row_check.py: the rows behind the gaps, and the bound rows that bind
# ---------------------------------------------------------------------------


def _row_check(tmp: Path, config: str, **kw) -> list[dict]:
    import row_check

    name, bench, data = _harness_tests().tiny_cell(tmp, config=config, **kw)
    got = row_check.check_seed(name, 2**33 + 7, 3, 1, torch.device("cpu"), bench, data)
    assert got["B"] == 4 and [c["p"] for c in got["compared"]] == [0, 1, 2]
    return got["compared"]


def test_row_check_sees_the_box_bind_as_the_reference_does(tmp_path):
    compared = _row_check(tmp_path, "boxed_h15")
    for c in compared:
        why = c["program"]
        assert why["rows_over"] == why["split"] + why["cleanup"] + why["alloc"] + why["rest"]
        assert len(c["top"]) == 4 and c["top"][0]["du"] == c["du_max"]
        ref, prog = c["bounds_f64"], c["bounds_program"]
        assert prog["box_active"] == ref["box_active"], c
        assert prog["rate_active"] == ref["rate_active"], c
    # the tiny cell's tumbling starts drive a craft onto the 0.5 m/s box
    assert any(c["bounds_f64"]["box_active"] > 0 for c in compared)
    assert any(c["bounds_f64"]["v_within_1mm_s_of_box"] > 0 for c in compared)
    assert max(c["bounds_f64"]["v_max"] for c in compared) == pytest.approx(0.5, abs=1e-2)


def test_row_check_on_an_unboxed_cell_counts_no_bound_rows(tmp_path):
    compared = _row_check(tmp_path, "condensed_h15", initial=NEAR_ORBIT, patterns=CENSUS4)
    for c in compared:
        assert "bounds_f64" not in c and "bounds_program" not in c
        assert c["program"]["rows_over"] == 0 and c["du_max"] < 0.1, c
        assert not any(t["cleanup_differs"] for t in c["top"]), c
        assert all(t["pattern"] == CENSUS4[t["row"]] for t in c["top"])
        # full-rank patterns: the reference's hull has the program's facets
        assert all(t["hull_facets"] == t["hull_facets_f64"] > 0 for t in c["top"])


# ---------------------------------------------------------------------------
# on the card: each fleet cell's own limits, named by file
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["condensed_h15", "boxed_h15"])
def test_the_tf32_control_fails_where_the_program_passes_at_the_fleet_limits(tmp_path, config):
    """The harness's card test of the control, with the limits of the
    cell `<config>.fleet2048_closed` read from that cell's own check file
    (the harness's test takes the first `checks/<config>.*.json` in the
    directory's order, which the census cell's file also matches): the
    fleet's 32 patterns, eight craft a pattern; the program passes every
    limit, the reference in float32 with every product in TF32 fails one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from perfbench import cell as cells, control, run as bench_run

    card = torch.device("cuda:0")
    name, bench, data = _harness_tests().tiny_cell(tmp_path, config=config)
    limits = (ROOT / "perfbench" / "checks" / f"{config}.fleet2048_closed.json").read_text()
    (data / "checks" / f"{name}.json").write_text(limits)
    traffic = json.loads((data / "traffic" / "tiny4.json").read_text())
    patterns = cells.load(f"{config}.fleet2048_closed").traffic["patterns"]
    traffic.update(batch=8 * len(patterns), check_periods=2, patterns=patterns)
    (data / "traffic" / "tiny4.json").write_text(json.dumps(traffic))
    result, lines, info = bench_run.run(name, 2**33 + 11, 5.0, False, card, bench, data, keep=True)
    assert result["correct"], lines
    c = cells.load(name, bench, data)
    assert c.limits == json.loads(limits)
    got = control.precision_readings(info["kept"], c.config, c.traffic, card)["tf32"]
    assert any(got[k] > v["limit"] for k, v in c.limits.items() if k in got), got
