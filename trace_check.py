#!/usr/bin/env python3
"""Check the program's span recorder (`ft_mpc_torch/utils/logging.py`) on
one NVIDIA GPU, in a cell of the benchmark.

    python3 trace_check.py --workload condensed_h15.fleet2048_closed --seed 11

From the root of a checkout.  The cell is built as `perfbench/run.py` builds
it (the program's bank, the harness's plant, states and noise from the
seed, the first warm start, the warm-up periods), then:

1. Sync census: one period under `torch.cuda.set_sync_debug_mode("warn")`.
   Each synchronizing call that torch reports is listed with its innermost
   frame in `ft_mpc_torch/` (or the harness's, outside the program) and the
   program's spans open at that moment.  Synchronizations inside a
   library's own code (cuSOLVER, MAGMA) do not pass torch's sync points and
   are not seen.
2. Alignment: one period under `torch.profiler` (CPU and CUDA activity).
   For each span name, the recorder's first start in that period, turned
   into the profiler's timebase, against the start of the profiler's first
   range of that name in the same period; the largest offset.
3. Cost: `--blocks` blocks of `--periods` closed-loop periods, the recorder
   on and off in turn (on, off, off, on, ...), each block's time a period
   to a device synchronize (as `step_ms`); then us a span of an empty span
   with the recorder on, off, and of a bare profiler range.
4. The recorder's readings over the "on" blocks' periods: per span name a
   period, the count, host ms and self ms; `ft_mpc.step`'s host ms
   (`step_host_ms`) beside the blocks' time a period, the share of
   `ft_mpc.step` that no nested span covers, and the largest gap, in one
   period, between the sum of its self times and the host time of its root
   spans (`ft_mpc.step` and `ft_mpc.shift`).
5. The linearization's and the terminal terms' launches and plain calls
   (`ops.linearize.linearize_lanes`, `ops.terminal.terminal_lanes`), and
   the ADMM kernel's launches by design
   (`solvers.lanes_qp.admm_lanes.launches_by_design`), a period over all
   the blocks.
6. Where the configuration has bounds (a state box, a wrench-rate bound),
   the count and self ms a period of `ft_mpc.ext_rows` (their dense rows'
   assembly and line-search terms) over the "on" blocks' periods.
7. The terminal kernel alone against its plain version (`terminal_plain`)
   on one more period's own inputs: the first call with derivatives (an
   assembly's) and the first without (the line search's), ms a call.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PROGRAM = str(ROOT / "ft_mpc_torch") + os.sep
HARNESS = str(ROOT / "perfbench") + os.sep


def census(loop, recorder, cuda, sync):
    """The synchronizing calls torch reports in one period."""
    import torch

    found = []

    def seen(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        inside = [f for f in stack if f.filename.startswith(PROGRAM)]
        at = inside[-1] if inside else next(
            (f for f in reversed(stack) if f.filename.startswith(HARNESS)), stack[-1])
        found.append({"at": f"{os.path.relpath(at.filename, ROOT)}:{at.lineno}",
                      "function": at.name, "program": bool(inside),
                      "spans": [f[0] for f in recorder._stack()],
                      "message": str(message).splitlines()[0][:120]})

    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.period()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    sync()
    sites = {}
    for f in found:
        key = (f["at"], f["function"], f["program"], tuple(f["spans"]))
        sites.setdefault(key, {**f, "count": 0})["count"] += 1
    return sorted(sites.values(), key=lambda s: (not s["program"], s["at"]))


def alignment(loop, recorder, cuda, sync):
    """Offsets (us) of the recorder's first start of each span name in one
    traced period from the profiler's first range of that name."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        loop.period()
        sync()
    period = recorder.periods()[-1]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = trace.get("baseTimeNanoseconds", 0)
    first = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in period.spans:
            t = e["ts"] * 1e3 + base
            first[e["name"]] = min(first.get(e["name"], t), t)
    offsets = {name: 1e-3 * (recorder.to_profiler_ns(period.first_start_ns(name)) - first[name])
               for name in period.spans if name in first}
    return {"offsets_us": offsets, "missing": sorted(set(period.spans) - set(first)),
            "max_abs_offset_us": max(abs(v) for v in offsets.values())}


def span_cost_us(n=20000):
    """us a span: empty spans with the recorder on and off, bare ranges."""
    from torch.profiler import record_function

    from ft_mpc_torch.utils import logging as L

    def loop(make):
        t = time.perf_counter()
        for _ in range(n):
            with make("ft_mpc.cost"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"on": [], "off": [], "record_function": []}
    for _ in range(5):
        L.enable(True)
        out["on"].append(loop(L.span))
        L.enable(False)
        out["off"].append(loop(L.span))
        out["record_function"].append(loop(record_function))
    L.enable(True)
    return {k: statistics.median(v) for k, v in out.items()}


def readings(periods):
    """The recorder's numbers over the given periods (ms a period)."""
    names = sorted({n for p in periods for n in p.spans})
    per = lambda f: {n: 1e-6 * sum(f(p, n) for p in periods) / len(periods) for n in names}
    host = per(lambda p, n: p.host_ns(n))
    own = per(lambda p, n: p.self_ns(n))
    gaps = []
    for p in periods:
        roots = p.host_ns("ft_mpc.step") + p.host_ns("ft_mpc.shift")
        gaps.append(abs(sum(s[2] for s in p.spans.values()) - roots) / roots)
    return {"periods": len(periods),
            "count": {n: sum(p.count(n) for p in periods) / len(periods) for n in names},
            "host_ms": host, "self_ms": own,
            "step_host_ms": host.get("ft_mpc.step", 0.0),
            "step_unspanned_share": own.get("ft_mpc.step", 0.0) / host["ft_mpc.step"],
            "spans_a_period": sum(p.count(n) for p in periods for n in p.spans) / len(periods),
            "self_sum_gap_max": max(gaps)}


def terminal_timing(loop, cuda, sync, reps=20) -> dict:
    """Step 7: ms a call of the terminal kernel (the wrapper on the cell's
    device) and of `terminal_plain` on the (term, e) one period hands them.
    On the card the device spins while the calls are queued, so the events
    time the kernels alone."""
    import torch

    from ft_mpc_torch.controllers import spiraling
    from ft_mpc_torch.ops.terminal import terminal_plain

    seen, real = {}, spiraling.terminal_lanes

    def capture(term, e, derivs=False):
        seen.setdefault(derivs, (term, e.clone()))
        return real(term, e, derivs=derivs)

    spiraling.terminal_lanes = capture
    try:
        loop.period()
    finally:
        spiraling.terminal_lanes = real
    sync()

    def ms(fn, n):
        fn()
        sync()
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return 1e3 * (time.perf_counter() - t0) / n
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e7))  # at least 10 ms at up to 2 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    return {f"e={tuple(e.shape)} derivs={d}": {
        "kernel_ms": ms(lambda: real(term, e, derivs=d), reps),
        "plain_ms": ms(lambda: terminal_plain(term, e, d), 3)}
        for d, (term, e) in sorted(seen.items())}


def check(workload: str, seed: int, blocks: int, periods: int, device) -> dict:
    """Steps 1-4 on `device` (a CUDA device; the CPU runs them for a rehearsal,
    without the census's sync reports and the profiler's device activity)."""
    import torch

    from ft_mpc_torch.ops.linearize import linearize_lanes
    from ft_mpc_torch.ops.terminal import terminal_lanes
    from ft_mpc_torch.solvers.lanes_qp import admm_lanes
    from ft_mpc_torch.utils import logging as L
    from perfbench import cell as cells, plant, run as bench, system

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    c = cells.load(workload)
    tr = c.traffic
    sut = system.build(c.config, tr, device)
    x0 = plant.initial_states(tr["initial_state"], tr["batch"], seed)
    loop = bench.Loop(sut, c, x0, seed, device)
    for _ in range(tr["warmup_periods"]):
        loop.period()
    sync()
    rec = L.RECORDER

    out = {"workload": workload, "seed": seed, "card": bench.card_line() if cuda else None,
           "census": census(loop, rec, cuda, sync), "alignment": alignment(loop, rec, cuda, sync)}
    timed, on_periods = [], []
    lin0 = (linearize_lanes.launches, linearize_lanes.plain_calls)
    term0 = (terminal_lanes.launches, terminal_lanes.plain_calls)
    admm0 = dict(admm_lanes.launches_by_design)
    for b in range(blocks):
        on = b % 4 in (0, 3)
        L.enable(on)
        sync()
        t0 = time.perf_counter()
        for _ in range(periods):
            loop.period()
        sync()
        timed.append({"recorder": on, "step_ms": 1e3 * (time.perf_counter() - t0) / periods})
        if on:
            on_periods += rec.periods()[-periods:]
    L.enable(True)
    n = blocks * periods
    out["linearize_a_period"] = {"launches": (linearize_lanes.launches - lin0[0]) / n,
                                 "plain_calls": (linearize_lanes.plain_calls - lin0[1]) / n}
    out["terminal_a_period"] = {"launches": (terminal_lanes.launches - term0[0]) / n,
                                "plain_calls": (terminal_lanes.plain_calls - term0[1]) / n}
    out["admm_launches_a_period"] = {d: (k - admm0[d]) / n
                                     for d, k in admm_lanes.launches_by_design.items()}
    on_ms = [b["step_ms"] for b in timed if b["recorder"]]
    off_ms = [b["step_ms"] for b in timed if not b["recorder"]]
    out["readings"] = {**readings(on_periods), "step_ms": statistics.mean(on_ms)}
    if cells.extra_rows(c.config) > 0:
        r = out["readings"]
        out["ext_rows"] = {"rows": cells.extra_rows(c.config),
                           "count": r["count"].get("ft_mpc.ext_rows", 0.0),
                           "self_ms": r["self_ms"].get("ft_mpc.ext_rows", 0.0)}
    out["terminal_timing"] = terminal_timing(loop, cuda, sync)
    # after the readings: the empty spans land in the newest period
    out["cost"] = {"blocks": timed, "step_ms_on": statistics.median(on_ms),
                   "step_ms_off": statistics.median(off_ms), "us_a_span": span_cost_us()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--periods", type=int, default=8)
    args = ap.parse_args(argv)
    from perfbench import run as bench

    bench.environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("trace_check: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    out = check(args.workload, args.seed, args.blocks, args.periods, torch.device("cuda:0"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
