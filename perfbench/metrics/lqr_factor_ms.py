"""Host ms a period inside the program's `ft_mpc.lqr_factor` spans: the
stagewise backend's Riccati factorization, once an ADMM phase."""

from perfbench import trace


def read(run):
    s = trace.host_seconds(run.trace, "ft_mpc.lqr_factor")
    return 1e3 * s / run.periods if s > 0 else None
