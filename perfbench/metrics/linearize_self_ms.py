"""Self ms a period of the program's `ft_mpc.linearize` spans (the main
SQP's and the cleanup's), read by the program's span recorder over the
untraced window: the batched jacobians of the RK4 stage map, less any
span nested in them."""

from perfbench.metrics import _recorder


def read(run):
    return _recorder.ms_per_period(run, lambda p: p.self_ns("ft_mpc.linearize"))
