"""Self ms a period of the program's `ft_mpc.ext_rows` spans, read by the
program's span recorder over the untraced window: the dense rows of a
configuration's state box and wrench-rate bound (their assembly, relaxation
and concatenation after the terminal rows) and their violations in the line
search's merit, in the main SQP and in the cleanup.  None where no period
of the window opened the span: a configuration without bounds, or a program
without the span."""

from perfbench.metrics import _recorder

SPAN = "ft_mpc.ext_rows"


def read(run):
    w = _recorder.window(run)
    if w is None or not any(p.count(SPAN) for p in w):
        return None
    return _recorder.ms_per_period(run, lambda p: p.self_ns(SPAN))
