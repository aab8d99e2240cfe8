"""Structured logging and the program's spans, counterpart of
`ft_mpc_tpu/utils/logging.py`.

  * `Logger`: stdlib logging behind the reference's .info / .warn surface.
  * `span(name)`: a named range at a layer boundary (`ft_mpc.step`,
    `ft_mpc.linearize`, ...).  It always opens the `torch.profiler` range of
    the same name, so a profiler trace shows it, and it also feeds
    `RECORDER`, the in-process span recorder, which is on by default
    (`enable(False)` switches it off; the profiler ranges stay).

The recorder keeps, for each control period and each span name, the count,
the host ns and the self ns (the span's time less the time its direct child
spans cover), on one monotonic clock (`time.perf_counter_ns`).  A period
opens when a `ft_mpc.step` span is entered outside any other one, and
takes every span entered until the next one opens (the caller's warm-start
shift after the step included); spans entered before the first step land
in the set-up record.  The last `capacity` periods are kept (a ring).
`Recorder.to_profiler_ns` turns a recorder time into the profiler's
timebase: epoch ns, a chrome trace's `ts` * 1e3 + `baseTimeNanoseconds`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from torch.profiler import record_function

STEP = "ft_mpc.step"


class Logger:
    """Reference-compatible logger surface backed by `logging`."""

    def __init__(self, name: str = "ft_mpc_torch", level: int = logging.INFO):
        self._log = logging.getLogger(name)
        if not self._log.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
            self._log.addHandler(h)
        self._log.setLevel(level)

    def info(self, msg: str) -> None:
        self._log.info(msg)

    def warn(self, msg: str) -> None:
        self._log.warning(msg)


class Period:
    """One control period's spans: `step` (None for the set-up record) and,
    per span name, [count, host ns, self ns, the first start's ns]."""

    __slots__ = ("step", "spans")

    def __init__(self, step: int | None):
        self.step, self.spans = step, {}

    def count(self, name: str) -> int:
        return self.spans[name][0] if name in self.spans else 0

    def host_ns(self, name: str) -> int:
        return self.spans[name][1] if name in self.spans else 0

    def self_ns(self, name: str) -> int:
        return self.spans[name][2] if name in self.spans else 0

    def first_start_ns(self, name: str) -> int | None:
        return self.spans[name][3] if name in self.spans else None


class Recorder:
    """Per-period span totals of the program (see the module's docstring)."""

    def __init__(self, capacity: int = 4096):
        self.on = True
        self.capacity = capacity
        # the anchor pair that maps the monotonic clock onto epoch ns
        self._anchor_mono, self._anchor_epoch = time.perf_counter_ns(), time.time_ns()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget every period and the set-up record; step ids restart at 0."""
        self.setup = Period(None)
        self._ring = collections.deque(maxlen=self.capacity)
        self._current = self.setup
        self._next_step = 0

    def periods(self) -> list[Period]:
        """The kept periods, oldest first; the newest may still be open."""
        return list(self._ring)

    def to_profiler_ns(self, t_ns: int) -> int:
        return t_ns - self._anchor_mono + self._anchor_epoch

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> list:
        """Enter a span: its frame [name, period, start ns, child ns]."""
        stack = self._stack()
        now = time.perf_counter_ns()
        if name == STEP and all(f[0] != STEP for f in stack):
            self._current = Period(self._next_step)
            self._next_step += 1
            self._ring.append(self._current)
        frame = [name, self._current, now, 0]
        stack.append(frame)
        return frame

    def close(self, frame: list) -> None:
        end = time.perf_counter_ns()
        stack = self._stack()
        stack.pop()  # spans are `with` blocks: the innermost closes first
        name, period, start, child = frame
        dur = end - start
        if stack:
            stack[-1][3] += dur
        s = period.spans.get(name)
        if s is None:
            period.spans[name] = [1, dur, dur - child, start]
        else:
            s[0] += 1
            s[1] += dur
            s[2] += dur - child


RECORDER = Recorder()


def enable(on: bool = True) -> None:
    """Switch the recorder on or off; `span` opens its profiler range either way."""
    RECORDER.on = bool(on)


class span:
    """`with span("ft_mpc.<layer>"):` -- the profiler range of that name and,
    while the recorder is on, one span of `RECORDER`."""

    __slots__ = ("_rf", "_frame")

    def __init__(self, name: str):
        self._rf = record_function(name)
        self._frame = None

    def __enter__(self):
        self._rf.__enter__()
        if RECORDER.on:
            self._frame = RECORDER.open(self._rf.name)
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            RECORDER.close(self._frame)
            self._frame = None
        return self._rf.__exit__(*exc)
