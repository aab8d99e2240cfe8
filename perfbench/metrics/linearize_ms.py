"""Host ms a period inside the program's `ft_mpc.linearize` spans (the main
SQP's and the cleanup's): the batched jacobians of the RK4 stage map."""

from perfbench import trace


def read(run):
    s = trace.host_seconds(run.trace, "ft_mpc.linearize")
    return 1e3 * s / run.periods if s > 0 else None
