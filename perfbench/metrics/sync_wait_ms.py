"""Host ms a period inside the program's `ft_mpc.sync` spans, read by the
program's span recorder over the untraced window: the host waiting for the
device's queue to drain at a read of device data or a synchronizing copy.
`step_host_ms` less this is the host's own time, dispatch included."""

from perfbench.metrics import _recorder


def read(run):
    return _recorder.ms_per_period(run, lambda p: p.host_ns("ft_mpc.sync"))
