"""Host ms a period inside the program's `ft_mpc.cleanup` span: the worst-K
re-solve (ranking, gather, assembly, solve, line search, scatter)."""

from perfbench import trace


def read(run):
    s = trace.host_seconds(run.trace, "ft_mpc.cleanup")
    return 1e3 * s / run.periods if s > 0 else None
