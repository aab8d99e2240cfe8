"""Host ms a period inside the program's `ft_mpc.step` span, read by the
program's span recorder over the untraced window: the control step from
the states in to the allocation out.  The rest of `step_ms` is the wait for
the commands' copy, the harness's plant and the warm-start shift."""

from perfbench.metrics import _recorder


def read(run):
    return _recorder.ms_per_period(run, lambda p: p.host_ns("ft_mpc.step"))
