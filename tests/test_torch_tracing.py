"""The port's spans and its span recorder (`ft_mpc_torch/utils/logging.py`),
on the CPU.

  * on a tiny closed loop (four craft of the snapshot bank, horizon 8;
    `get_control_batch` then `shift_warmstart`, three periods, both QP
    backends): one `ft_mpc.step` a period, consecutive step ids, each
    span in its period, and self times that add up to the root spans'
    host time;
  * on the condensed loop, one `ft_mpc.sync` a K^-1 refresh and one a line
    search, and nothing else that synchronizes;
  * under `torch.profiler`, the recorder's span starts, in the profiler's
    timebase, within 1 ms of the profiler's ranges of the same names;
  * `enable(False)` records nothing while the profiler still sees the ranges;
  * on a tiny traced run of the benchmark (`perfbench.run.run`), each reader
    of the recorder reads exactly the untraced window's periods, and the
    device-trace reader of `ft_mpc.kinv_exact` finds nothing to read.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as sp
from ft_mpc_torch.convert import scenario_from_numpy
from ft_mpc_torch.geometry.scenario import BENCH_BANK
from ft_mpc_torch.ops.dynamics import BodyParams, robot_to_center
from ft_mpc_torch.solvers import lanes_qp
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig
from ft_mpc_torch.utils import logging as L
from ft_mpc_torch.utils import trajectory as traj

ROOT = Path(__file__).resolve().parent.parent
ROWS = [0, 3, 17, 30]
NT = 8
STEP, SHIFT = "ft_mpc.step", "ft_mpc.shift"


@pytest.fixture
def recorder():
    """The program's recorder, emptied and on; left on."""
    L.RECORDER.reset()
    L.enable(True)
    yield L.RECORDER
    L.enable(True)


def _loop(backend: str):
    """A closed loop of four craft: step(x) runs one period (the control
    step, the craft advanced by the commanded model, the warm start shifted)."""
    with np.load(BENCH_BANK) as z:
        flat = {k: z[k][ROWS] for k in z.files}
    bank = scenario_from_numpy(flat, device="cpu", dtype=torch.float32)
    params = BodyParams.default(0.1, dtype=torch.float32, device="cpu")
    weights = sp.MPCWeights.from_diagonals([1, 1, 1, 1, 1, 1, 2, 2, 2],
                                           [0.1, 0.1, 0.1, 0.01, 0.01, 0.01], device="cpu")
    cfg = sp.MPCConfig(horizon=NT, sqp_iters=2, qp_backend=backend, newton_iters=3,
                       admm=StructuredADMMConfig(iters=20, phases=1, rho=50.0),
                       stagewise=StagewiseConfig(iters=20, phases=1, mode="lanes"),
                       cleanup_iters=30, cleanup_k=2, cleanup_phases=2)
    t = traj.generate_trajectory("hover", 0.1, 5)
    xr, ur = traj.prepare_center_trajectory(t, np.array([0.0, 0.0, 0.6]), 16.8, 0.1, NT + 1)
    x_ref = torch.as_tensor(xr[: NT + 1], dtype=torch.float32)
    u_ref = torch.as_tensor(ur[: NT + 1], dtype=torch.float32)
    rng = np.random.default_rng(3)
    x = np.zeros((len(ROWS), 13))
    x[:, 0:3] = rng.uniform(-0.3, 0.3, (len(ROWS), 3))
    x[:, 6] = 1.0
    state = {"x": torch.as_tensor(x, dtype=torch.float32)}
    state["warm"] = sp.init_warmstart_batch(params, bank, weights, cfg,
                                            robot_to_center(bank.r, state["x"]), x_ref, u_ref)

    def step():
        out = sp.get_control_batch(params, bank, weights, cfg, state["x"], x_ref, u_ref,
                                   state["warm"])
        state["warm"] = sp.shift_warmstart(out.warm, out.c0)
        return out

    return step


@pytest.mark.parametrize("backend", ["condensed", "stagewise"])
def test_spans_nest_into_one_period_a_step(recorder, backend):
    step = _loop(backend)
    setup = dict(recorder.setup.spans)
    for _ in range(3):
        step()
    periods = recorder.periods()
    assert [p.step for p in periods] == [0, 1, 2]
    assert recorder.setup.spans == setup  # the cold start stays in the set-up record
    if backend == "condensed":
        assert "ft_mpc.kinv_exact" in setup and STEP not in setup
    for p in periods:
        assert p.count(STEP) == 1 and p.count(SHIFT) == 1 and p.count("ft_mpc.wrench") == 1
        # every line search in its span: sqp_iters (2) + cleanup_rounds (1)
        assert p.count("ft_mpc.line_search") == 2 + 1
        roots = p.host_ns(STEP) + p.host_ns(SHIFT)
        assert sum(s[2] for s in p.spans.values()) == roots
        assert all(0 <= p.self_ns(n) <= p.host_ns(n) for n in p.spans)
        # a child's time is taken from its parent's self time, not twice
        assert p.self_ns("ft_mpc.cleanup") < p.host_ns("ft_mpc.cleanup")
        assert p.host_ns("ft_mpc.cleanup") <= p.host_ns(STEP)
    for a, b in zip(periods, periods[1:]):
        assert a.first_start_ns(STEP) + a.host_ns(STEP) <= a.first_start_ns(SHIFT)
        assert a.first_start_ns(SHIFT) < b.first_start_ns(STEP)


def test_sync_spans_count_the_kinv_refreshes_and_line_searches(recorder, monkeypatch):
    step = _loop("condensed")
    calls = {"refresh": 0, "line_search": 0}

    def counted(key, fn):
        @functools.wraps(fn)  # newton_kinv's counters ride on the wrapper meanwhile
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(lanes_qp, "newton_kinv", counted("refresh", lanes_qp.newton_kinv))
    monkeypatch.setattr(sp, "_merit_alpha", counted("line_search", sp._merit_alpha))
    for _ in range(3):
        step()
    syncs = sum(p.count("ft_mpc.sync") for p in recorder.periods())
    assert calls["refresh"] == 3 * 2  # sqp_iters refreshes a period
    assert calls["line_search"] == 3 * 3  # sqp_iters + the cleanup's
    assert syncs == calls["refresh"] + calls["line_search"]
    exact = sum(p.count("ft_mpc.kinv_exact") for p in recorder.periods())
    assert exact >= 3 * 3  # the cleanup's exact metric: once and once a phase


def test_newton_kinv_reads_its_two_flags_in_one_sync(recorder):
    rng = np.random.default_rng(1)
    n, B = 12, 3
    Ls = torch.as_tensor(rng.standard_normal((B, n, n)), dtype=torch.float32) * 0.3
    K = Ls @ Ls.transpose(1, 2) + 3 * torch.eye(n)
    kinv = lanes_qp.exact_kinv(K)
    r0, nf0 = lanes_qp.newton_kinv.rescues, lanes_qp.newton_kinv.rescues_nonfinite
    with L.span(STEP):
        lanes_qp.newton_kinv(K * 1.1, kinv, 3)  # contracts: no rescue
        lanes_qp.newton_kinv(K, kinv * torch.nan, 3)  # non-finite: rescued
    p = recorder.periods()[-1]
    assert p.count("ft_mpc.sync") == 2 and p.count("ft_mpc.kinv_exact") == 1
    assert lanes_qp.newton_kinv.rescues == r0 + 1
    assert lanes_qp.newton_kinv.rescues_nonfinite == nf0 + 1


def test_recorder_starts_lie_on_the_profilers_ranges(recorder, tmp_path):
    step = _loop("condensed")
    step()  # the first call of each op and range warms up outside the trace
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    period = recorder.periods()[-1]
    first = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            t = e["ts"] * 1e3 + base
            first[e["name"]] = min(first.get(e["name"], t), t)
    assert set(period.spans) <= set(first)
    for name in period.spans:
        offset = recorder.to_profiler_ns(period.first_start_ns(name)) - first[name]
        assert abs(offset) < 1e6, (name, offset)


def test_a_disabled_recorder_records_nothing_and_the_profiler_still_sees(recorder):
    L.enable(False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with L.span(STEP):
            with L.span("ft_mpc.inner"):
                torch.ones(2) + 1
    assert recorder.periods() == [] and recorder.setup.spans == {}
    assert {STEP, "ft_mpc.inner"} <= {e.key for e in prof.key_averages()}
    L.enable(True)
    with L.span(STEP):
        with L.span("ft_mpc.inner"):
            pass
    (p,) = recorder.periods()
    assert p.count("ft_mpc.inner") == 1 and p.self_ns(STEP) == p.host_ns(STEP) - p.host_ns("ft_mpc.inner")


def test_the_ring_keeps_the_newest_periods():
    rec = L.Recorder(capacity=4)
    for _ in range(6):
        rec.close(rec.open(STEP))
    assert [p.step for p in rec.periods()] == [2, 3, 4, 5]
    frame = rec.open("ft_mpc.late")  # a span after the last step lands in it
    rec.close(frame)
    assert rec.periods()[-1].count("ft_mpc.late") == 1


def _harness_tests():
    """The benchmark's own CPU test module (for its tiny cells)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_harness_tests", ROOT / "perfbench" / "tests" / "test_perfbench_harness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RECORDER_READERS = {
    "step_host_ms": lambda p: 1e-6 * p.host_ns(STEP),
    "sync_wait_ms": lambda p: 1e-6 * p.host_ns("ft_mpc.sync"),
    "host_syncs_per_step": lambda p: p.count("ft_mpc.sync"),
    "linearize_self_ms": lambda p: 1e-6 * p.self_ns("ft_mpc.linearize"),
    "cleanup_self_ms": lambda p: 1e-6 * p.self_ns("ft_mpc.cleanup"),
    "stagewise_admm_self_ms": lambda p: 1e-6 * p.self_ns("ft_mpc.stagewise_admm"),
    "lqr_factor_self_ms": lambda p: 1e-6 * p.self_ns("ft_mpc.lqr_factor"),
    "terminal_self_ms": lambda p: 1e-6 * p.self_ns("ft_mpc.terminal"),
}


@pytest.mark.parametrize("config", ["condensed_h15", "stagewise_h240"])
def test_the_readers_read_the_untraced_window(recorder, config):
    from perfbench import run as bench_run

    h = _harness_tests()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        name, bench, data = h.tiny_cell(Path(tmp), config=config, **h.CELLS[config])
        traffic = json.loads((data / "traffic" / "tiny4.json").read_text())
        result, _, info = bench_run.run(name, 2**33 + 7, 1e9, True, torch.device("cpu"), bench,
                                        data, max_periods=2)
    warm, window, traced = traffic["warmup_periods"], info["periods"], traffic["traced_periods"]
    periods = recorder.periods()
    assert [p.step for p in periods] == list(range(warm + window + traced))
    untraced = periods[warm:warm + window]
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for metric, of in RECORDER_READERS.items():
        reads = importlib.import_module(f"perfbench.metrics.{metric}").read
        run = type("Run", (), dict(window_periods=window, periods=traced))
        want = sum(of(p) for p in untraced) / window
        assert reads(run) == pytest.approx(want, rel=1e-12), metric
        if any(w.startswith(config) for w in entries[metric]["workloads"]):
            assert result["metrics"][metric]["value"] == pytest.approx(want, rel=1e-12), metric
        # a count that does not match what the recorder kept reads nothing
        assert reads(type("Run", (), dict(window_periods=window + traced + warm + 1,
                                          periods=traced))) is None
    assert result["metrics"]["host_syncs_per_step"]["value"] > 0
    assert "kinv_exact_device_ms" not in result["metrics"]  # no device activity on the CPU
    kinv = importlib.import_module("perfbench.metrics.kinv_exact_device_ms").read
    device = [type("D", (), dict(start=0.0, end=5.0, spans=("ft_mpc.kinv_exact",)))]
    for spans, want in (({}, None), ({STEP: []}, 5e-3 / traced)):
        run = type("Run", (), dict(trace=type("T", (), dict(device=device, spans=spans)),
                                   periods=traced, config={"mpc": {"qp_backend": "condensed"}}))
        assert kinv(run) == want  # a program without the span reads nothing
