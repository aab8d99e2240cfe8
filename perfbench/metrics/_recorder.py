"""What the readers of the program's span recorder share: the recorder's
periods of the untraced window.

The program's `ft_mpc_torch.utils.logging.RECORDER` keeps per control
period (one `ft_mpc.step` span and what follows it until the next) the
count, host ns and self ns of each span name, on the host's monotonic
clock, with the profiler off.  A run's last `run.periods` periods are the
traced ones; the `run.window_periods` just before them are the untraced
window's.  Where the program has no recorder, or the periods kept do not
match those counts, there is nothing to read (None).
"""

STEP = "ft_mpc.step"


def window(run):
    """The untraced window's periods, oldest first, or None."""
    try:
        from ft_mpc_torch.utils.logging import RECORDER
    except ImportError:
        return None
    n, m = run.window_periods, run.periods
    kept = RECORDER.periods()
    if n == 0 or len(kept) < n + m:
        return None
    last = kept[len(kept) - n - m:]
    if last[-1].step - last[0].step != n + m - 1 or any(p.count(STEP) != 1 for p in last):
        return None
    return last[:n]


def ms_per_period(run, ns_of) -> float | None:
    """Mean over the untraced window's periods of ns_of(period), in ms."""
    w = window(run)
    return None if w is None else 1e-6 * sum(ns_of(p) for p in w) / len(w)
