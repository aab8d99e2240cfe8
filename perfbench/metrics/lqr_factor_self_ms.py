"""Self ms a period of the program's `ft_mpc.lqr_factor` spans, read by the
program's span recorder over the untraced window: the stagewise backend's
Riccati factorization, once an ADMM phase."""

from perfbench.metrics import _recorder


def read(run):
    return _recorder.ms_per_period(run, lambda p: p.self_ns("ft_mpc.lqr_factor"))
