"""The port's measuring scripts on the CPU (`ft_mpc_torch.benchmarks`:
long_horizon, envelope, randomized, profile_step), at small sizes.

On the CPU they show only that the control flow runs and what each record
holds; their times are the CPU's and no kernel launches.  The envelope's
byte count is checked against the Riccati kernel's layout (the 588-float
stage record of `csrc/riccati.cu`) on a small shape, and its summary on
synthetic rows.  Every new `main` refuses to run on the CPU unless asked.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ft_mpc_torch.benchmarks import bench, envelope, long_horizon, profile_step, randomized

torch.set_num_threads(1)

SMALL = SimpleNamespace(sqp_iters=2, iters=10, cleanup=20, reps=1)


@pytest.mark.parametrize("backend", long_horizon.BACKENDS)
def test_long_horizon_run_on_cpu(backend):
    r = long_horizon.run(15, backend, 4, SMALL, "cpu")
    assert r["counted_steps"] == 2
    assert np.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0
    assert r["solves_per_s"] == pytest.approx(4e3 / r["ms_per_step"])
    assert np.isfinite(r["max_r_prim"]) and 0 <= r["max_term_gap"] <= 0.4
    assert all(v == 0 for v in r["launches_per_step"].values())  # plain versions


def test_long_horizon_skip_rule():
    assert long_horizon.backends_at(15, 120) == list(long_horizon.BACKENDS)
    assert long_horizon.backends_at(60, 120) == ["stagewise", "stagewise-lanes"]
    with pytest.raises(ValueError, match="backend"):
        long_horizon.run(15, "lanes", 4, SMALL, "cpu")


def test_envelope_bytes_follow_the_kernel_layout():
    """A re-solve: each stage's 588-float record, q (13) and r (6) read, qN
    and x0 read once, X (Nt+1, 13) and U (Nt, 6) written; a preparation:
    F, B, K, Quu_inv, PC, c read and the records written; float32."""
    from ft_mpc_torch.solvers.lanes_riccati import REC

    assert REC == 588
    nt, b = 3, 2
    assert envelope.resolve_bytes(nt, b) == 4 * b * (nt * (588 + 13 + 6) + 13 + 13
                                                     + (nt + 1) * 13 + nt * 6)
    assert envelope.prepare_bytes(nt, b) == 4 * b * nt * (169 + 78 + 78 + 36 + 13 + 13 + 588)
    args = SimpleNamespace(sqp_iters=2, iters=60, cleanup=300)
    assert envelope.eff_iters(args, 64) == 2 * 60 + 300 * 2 * 8 / 64
    # the cleanup's re-solves and preparations run on K = B/8 rows
    want = (envelope.resolve_bytes(240, 64) * (120 + 600 * 8 / 64)
            + envelope.prepare_bytes(240, 64) * (2 + 2 * 8 / 64))
    assert envelope.stream_bytes(240, 64, args) == pytest.approx(want, rel=1e-12)


def test_envelope_summary():
    row = lambda nt, b, ms: {"Nt": nt, "B": b, "ms_per_step": ms, "meets_100ms": ms <= 100}
    env = envelope.envelope_summary([row(15, 512, 80.0), row(15, 2048, 120.0),
                                     row(240, 64, 900.0), row(60, 256, 99.0),
                                     row(60, 512, 100.0)])
    assert env["15"] == {"max_B_under_100ms": 512, "ms_per_step": 80.0}
    assert env["60"] == {"max_B_under_100ms": 512, "ms_per_step": 100.0}
    assert env["240"]["max_B_under_100ms"] == 0 and "note" in env["240"]
    assert list(env) == ["15", "60", "240"]


def test_envelope_main_on_cpu(tmp_path):
    out = tmp_path / "env.json"
    rec = envelope.main(points=((15, "stagewise-lanes", 2), (15, "condensed", 2)),
                        sqp_iters=1, iters=10, cleanup=20, reps=1, device="cpu", out=out)
    lanes, cond = rec["points"]
    assert lanes["est_stream_GB_per_step"] > 0 and "h100_hbm_peak_fraction" in lanes
    assert "h100_hbm_peak_fraction" not in cond and "hbm_peak_fraction" not in cond
    assert rec["card"] is None and "roofline_note" not in rec  # no card: no device figure
    assert out.exists() and set(rec["envelope_100ms"]) == {"15"}


def test_randomized_on_cpu(monkeypatch):
    monkeypatch.setattr(randomized, "WINDOWS", 1)
    monkeypatch.setattr(randomized, "STEPS_PER_WINDOW", 1)
    rec = randomized.main(n=4, device="cpu")
    assert rec["n_scenarios"] == 4 and rec["cleanup_k"] == 4
    assert rec["latency_windows"] == 1 and len(rec["latency_samples_ms"]) == 1
    assert rec["device"] == "cpu" and rec["card"] is None
    assert 0.85 * 16.8 <= rec["mass_range_kg"][0] <= rec["mass_range_kg"][1] <= 1.15 * 16.8


def test_profile_step_on_cpu(monkeypatch):
    """Control flow only: every component runs in each of the two rounds
    and is timed by the host clock, then once under the profiler (asked for
    the port's ranges on the full steps); events and device time are not
    measured without a card."""
    monkeypatch.setenv("FT_MPC_BENCH_ITERS", "10")
    monkeypatch.setenv("FT_MPC_BENCH_CLEANUP", "20")
    monkeypatch.setattr(profile_step, "WARMUP_STEPS", 1)
    asked = {}
    real = profile_step.profiled

    def profiled(fn, device, ranges):  # the CPU profiler would take most of the time
        name = next(k for k, f in calls.items() if f is fn)
        asked[name] = ranges
        return real(lambda: None, device, False)

    real_components = profile_step.components
    calls = {}

    def components(s, out):
        calls.update(real_components(s, out))
        return calls

    monkeypatch.setattr(profile_step, "profiled", profiled)
    monkeypatch.setattr(profile_step, "components", components)
    rec = profile_step.main(B=8, reps=2, sweep=(16,), device="cpu")
    comps = rec["components"]
    assert {k[:4] for k in comps} == {"(a) ", "(b) ", "(b0)", "(c) ", "(d) ", "(e) ", "(f) ",
                                      "(g) ", "(h) ", "(i) ", "clea"}
    assert "(h) full step B=16" in comps and rec["card"] is None
    assert rec["warmup_steps"] == 1 and isinstance(rec["unresolved"], list)
    assert len(rec["containment"]) == len(profile_step.CONTAINS)
    for name, v in comps.items():
        if name != profile_step.CLEANUP:
            assert v["host_ms"] == np.median(v["host_ms_rounds"]) > 0, name
            assert v["host_ms_se"] >= 0, name
            assert len(v["host_ms_rounds"]) == 2 and v["newton_rescues"] >= 0, name
        assert v["event_ms"] is None and v["device_busy_ms"] is None, name
    b, b0 = comps["(b) sqp_solve_batch"], comps["(b0) sqp_solve_batch without cleanup"]
    assert comps[profile_step.CLEANUP]["host_ms"] == pytest.approx(b["host_ms"] - b0["host_ms"])
    # one profiled call a component; the port's ranges for the full steps
    assert asked == {name: name.startswith(("(a)", "(h)")) for name in comps
                     if name != profile_step.CLEANUP}


def test_profile_step_ranges():
    """The port's ranges in one profiled call, nested as the code nests
    them, each within the call's host time; no device time on the CPU."""
    from torch.profiler import record_function

    def fn():
        with record_function("ft_mpc.outer"):
            for _ in range(2):
                with record_function("ft_mpc.inner"):
                    torch.ones(64).sum()
        with record_function("other"):
            pass

    r = profile_step.profiled(fn, torch.device("cpu"), ranges=True)
    assert r["device_busy_ms"] is None and set(r["ranges"]) == {"ft_mpc.outer", "ft_mpc.inner"}
    outer, inner = r["ranges"]["ft_mpc.outer"], r["ranges"]["ft_mpc.inner"]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert 0 < inner["host_ms"] <= outer["host_ms"] <= r["profiled_host_ms"]
    assert profile_step.profiled(fn, torch.device("cpu"), ranges=False) == {
        "device_busy_ms": None}


def test_profile_step_in_turns():
    """Each call once untimed, then the rounds in order, reversed by turns;
    the median of each call's rounds."""
    order = []
    calls = {k: (lambda k=k: order.append(k)) for k in "xyz"}
    res = profile_step.in_turns(calls, 3, torch.device("cpu"))
    assert "".join(order) == "xyz" + "xyz" + "zyx" + "xyz"
    for v in res.values():
        assert len(v["host_ms_rounds"]) == 3
        assert v["host_ms"] == np.median(v["host_ms_rounds"]) and v["event_ms"] is None


@pytest.mark.parametrize("times,bad", [
    ({}, []),
    ({"(b) sqp_solve_batch": (436.1, 10.0)}, ["(b) sqp_solve_batch"]),
    ({"(b) sqp_solve_batch": (330.0, 10.0)}, []),  # above (a) within twice the error
    ({"(d) _linearize": (90.0, 1.0)}, ["(d) _linearize"]),
    ({"(b0) sqp_solve_batch without cleanup": (150.0, 2.0), profile_step.CLEANUP: (160.0, 2.0)},
     [profile_step.CLEANUP]),
    ({"(i) _merit_alpha": (250.0, 2.0)}, ["(i) _merit_alpha"]),
])
def test_profile_step_unresolved(times, bad):
    """A part that reads above what contains it by more than twice the
    standard error of the difference is named."""
    ms = {"(a) full step": (310.4, 10.0), "(b) sqp_solve_batch": (300.0, 10.0),
          "(b0) sqp_solve_batch without cleanup": (200.0, 5.0),
          "(c) allocate_thrusters_lanes": (0.3, 0.01), "(d) _linearize": (55.0, 2.0),
          "(e) _assemble_condensed_batch": (77.0, 2.0), "(f) solve_mpc_qp_lanes": (3.9, 0.1),
          profile_step.CLEANUP: (100.0, 5.0), "(i) _merit_alpha": (15.0, 1.0)}
    ms.update(times)
    pairs = profile_step.containment({k: {"host_ms": v, "host_ms_se": e}
                                      for k, (v, e) in ms.items()})
    assert [(c["part"], c["whole"]) for c in pairs] == list(profile_step.CONTAINS)
    ab = pairs[0]
    assert ab["diff_ms"] == ms["(b) sqp_solve_batch"][0] - 310.4
    assert ab["se_ms"] == pytest.approx(np.hypot(ms["(b) sqp_solve_batch"][1], 10.0))
    got = profile_step.unresolved(pairs)
    assert [g.split(" above ")[0] for g in got] == bad


def test_mains_default_to_cuda(monkeypatch):
    """Without a card, no measuring path runs unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, randomized.main, long_horizon.main, envelope.main,
                 profile_step.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        long_horizon.run(15, "condensed", 4, SMALL, None)
