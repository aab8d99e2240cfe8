"""Per cent of an untraced period in which the device does nothing:
1 - (device busy a period) / (the untraced window's time a period).

The busy time is the union of every kernel, copy and fill in the traced
periods, over their number; the period is the same run's untraced window
over its periods.  Not the traced window itself: the profiler stretches the
host's side of a period about 2.5x (1.247 against 0.502 s a condensed
period in one process, NVIDIA H100 80GB HBM3 at 700 W) and leaves the
device's work as it was, so an idle share over the traced window reads
mostly the profiler's own cost (92-93% against about 82% untraced).
"""


def read(run):
    tr = run.trace
    if tr.window_us <= 0 or run.window_periods == 0 or run.periods == 0:
        return None
    busy_s = 1e-6 * tr.busy_us / run.periods
    return 100.0 * (1.0 - busy_s / (run.window_s / run.window_periods))
