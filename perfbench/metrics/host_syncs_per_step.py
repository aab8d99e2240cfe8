"""Host synchronizations with the device a period: the count of the
program's `ft_mpc.sync` spans, read by the program's span recorder over the
untraced window.  Each K^-1 refresh reads its rescue flags (condensed), and
each line search copies its step sizes from pageable host memory (both)."""

from perfbench.metrics import _recorder


def read(run):
    w = _recorder.window(run)
    return None if w is None else sum(p.count("ft_mpc.sync") for p in w) / len(w)
