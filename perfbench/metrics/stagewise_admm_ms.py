"""Host ms a period inside the program's `ft_mpc.stagewise_admm` spans, less
the `ft_mpc.riccati` spans nested in them: the eager ADMM body around each
LQR re-solve."""

from perfbench import trace


def read(run):
    if "ft_mpc.stagewise_admm" not in run.trace.spans:
        return None
    s = trace.host_seconds(run.trace, "ft_mpc.stagewise_admm", minus="ft_mpc.riccati")
    return 1e3 * s / run.periods
