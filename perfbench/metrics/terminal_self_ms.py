"""Self ms a period of the program's `ft_mpc.terminal` spans, read by the
program's span recorder over the untraced window: the terminal cost's
gradient and PSD-shifted Hessian in each assembly of the QP (the main SQP's
and the cleanup's), less any span nested in them.  None where no period of
the window opened the span."""

from perfbench.metrics import _recorder

SPAN = "ft_mpc.terminal"


def read(run):
    w = _recorder.window(run)
    if w is None or not any(p.count(SPAN) for p in w):
        return None
    return _recorder.ms_per_period(run, lambda p: p.self_ns(SPAN))
