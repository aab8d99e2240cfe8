"""The traced window: a `torch.profiler` trace of some closed-loop periods,
read into what the per-layer metrics need.

  * host spans: the program's `ft_mpc.*` ranges (`record_function`), with
    their host start and end;
  * device activity: every kernel, copy and fill, with its device start and
    length, and the host spans open on the launching thread when the
    launch call ran (matched by the launch's correlation id);
  * the window: the harness's own span around the traced periods, which ends
    in a device synchronize, so the device's work of those periods lies in it.

The trace is written by the profiler to a temporary file and read back; the
file is deleted at once.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from types import SimpleNamespace

import torch

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def record(fn, sync) -> list[dict]:
    """Run fn() under the profiler inside the window span, ending with
    sync() (a device synchronize); the trace's events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class Spans:
    """Intervals of one span name on one thread: which one holds a time."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [a for a, _ in self.iv]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.iv[i][1] >= t


def analyse(events: list[dict]) -> SimpleNamespace:
    """Host spans, device activity with its launching spans, the window,
    device busy time and the breakdown."""
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    win = next(e for e in ann if e["name"] == WINDOW_SPAN)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    host_tid = win["tid"]
    spans = defaultdict(list)
    for e in ann:
        if e["tid"] == host_tid and w0 <= e["ts"] <= w1 and e["name"] != WINDOW_SPAN:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    finders = {name: Spans(iv) for name, iv in spans.items()}
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        t = None if launch is None else launch["ts"]
        open_spans = () if t is None else tuple(n for n, f in finders.items() if f.holds(t))
        device.append(SimpleNamespace(name=e["name"], start=a, end=b, launch=t, spans=open_spans))
    busy, gaps = _union(device, w0, w1)
    return SimpleNamespace(spans=dict(spans), finders=finders, device=device,
                           window_us=w1 - w0, busy_us=busy, gaps=gaps, w0=w0)


def _union(device, w0, w1):
    """Length of the union of the device intervals, and the idle gaps
    (start, end) between them inside the window."""
    iv = sorted((d.start, d.end) for d in device)
    busy, gaps, cur = 0.0, [], w0
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


def innermost(tr, t: float) -> str:
    """The shortest program span open on the host thread at time t."""
    best, best_len = "(outside the program's spans)", float("inf")
    for name, f in tr.finders.items():
        i = bisect.bisect_right(f.starts, t) - 1
        if i >= 0 and f.iv[i][1] >= t and f.iv[i][1] - f.iv[i][0] < best_len:
            best, best_len = name, f.iv[i][1] - f.iv[i][0]
    return best


def device_seconds(tr, span: str) -> float:
    """Device seconds of the work launched while `span` was open."""
    return 1e-6 * sum(d.end - d.start for d in tr.device if span in d.spans)


def host_seconds(tr, span: str, minus: str | None = None) -> float:
    """Host seconds inside `span`, less those inside `minus` spans nested in it."""
    total = sum(b - a for a, b in tr.spans.get(span, ()))
    if minus is not None and span in tr.finders:
        f = tr.finders[span]
        total -= sum(b - a for a, b in tr.spans.get(minus, ()) if f.holds(a))
    return 1e-6 * total


def breakdown(tr, top: int = 10) -> dict:
    """The device operations that took most time (by kernel and the
    innermost program span that launched it) and the longest idle gaps (by
    the program span open on the host when the gap began)."""
    ops = defaultdict(float)
    for d in tr.device:
        inner = min(d.spans, key=lambda s: _span_len(tr, s, d), default="(no span)")
        ops[f"{short(d.name)} @ {inner}"] += 1e-6 * (d.end - d.start)
    gaps = sorted(tr.gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[f"idle during {innermost(tr, a)}", 1e-6 * (b - a)] for a, b in gaps]}


def short(kernel: str) -> str:
    """A kernel's name without its template and argument lists, with the
    element-wise functor it runs where it names one."""
    name = re.sub(r"^(void |std::enable_if<[^>]*>::type )+", "",
                  kernel.replace("(anonymous namespace)::", ""))
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    functors = re.findall(r"\w*Functor\w*", name)
    return f"{base} [{functors[-1]}]" if functors else base


def _span_len(tr, name, d):
    f = tr.finders[name]
    i = bisect.bisect_right(f.starts, d.launch) - 1
    return f.iv[i][1] - f.iv[i][0] if i >= 0 else float("inf")
