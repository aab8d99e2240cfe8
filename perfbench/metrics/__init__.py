"""Per-layer metric readers, one file a metric, found by the metric's name.

Each file defines `read(run) -> float | None`.  `run` carries the traced
window (`run.trace`, see `perfbench/trace.py`), the number of periods it
traced (`run.periods`), the untraced window's periods, each period's
latency in it and the program's counters read over them
(`run.window_periods`, `run.latencies_s`, `run.rescues`), the cell's
configuration and traffic (`run.config`, `run.traffic`) and its bank size
and cleanup rows (`run.B`, `run.K`).  A reader that finds nothing to read
returns None, and the metric is left out of the result line.
"""
