"""Structured logging and per-phase timing, counterpart of
`ft_mpc_tpu/utils/logging.py`.

  * `Logger`: stdlib logging behind the reference's .info / .warn surface.
  * `PhaseTimer`: accumulating wall-clock phases; `block_on` synchronizes the
    device of the given tensor(s) at phase exit, so a phase covers the
    device work it queued, not only its launch.
  * `trace_annotation`: a named `torch.profiler.record_function` range, the
    range type the controller's phases use (`ft_mpc.linearize`, ...).
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch
from torch.utils._pytree import tree_leaves


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


def _synchronize(tree) -> None:
    """Wait for the CUDA devices that hold the tensors of `tree`."""
    devices = {x.device for x in tree_leaves(tree) if isinstance(x, torch.Tensor)}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    with timer.phase("solve", block_on=out):  ...   -- synchronizes the
    device(s) of `out`'s tensors at exit.
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot*1e3:10.2f} ms total  x{n}  "
                         f"({tot/n*1e3:.2f} ms/call)")
        return "\n".join(lines)


def trace_annotation(name: str):
    """Named profiler range (shows in `torch.profiler` traces)."""
    return torch.profiler.record_function(name)
