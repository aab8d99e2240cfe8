"""Self ms a period of the program's `ft_mpc.stagewise_admm` spans, read by
the program's span recorder over the untraced window: the eager ADMM body
less the `ft_mpc.riccati` re-solves nested in it."""

from perfbench.metrics import _recorder


def read(run):
    return _recorder.ms_per_period(run, lambda p: p.self_ns("ft_mpc.stagewise_admm"))
