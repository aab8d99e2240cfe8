"""Self ms a period of the program's `ft_mpc.cleanup` span, read by the
program's span recorder over the untraced window: the worst-K ranking, the
gathers, the assembly and line search that no span of their own covers,
the scatters; the spans nested in it (linearization, QP, ...) excluded."""

from perfbench.metrics import _recorder


def read(run):
    return _recorder.ms_per_period(run, lambda p: p.self_ns("ft_mpc.cleanup"))
