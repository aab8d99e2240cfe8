"""Device ms a traced period of the work launched while the program's
`ft_mpc.kinv_exact` span was open and its `ft_mpc.cleanup` span was not:
the main bank's exact refactors of K^-1 (Cholesky and solve against the
identity), taken on a failed Newton-Schulz refresh.  0 in a traced window
without one.  None where the run has no device activity (the CPU) or the
program does not open these spans (its trace has no `ft_mpc.step`)."""


def read(run):
    tr = run.trace
    if not tr.device or "ft_mpc.step" not in tr.spans:
        return None
    if run.config["mpc"]["qp_backend"] != "condensed":
        return None
    us = sum(d.end - d.start for d in tr.device
             if "ft_mpc.kinv_exact" in d.spans and "ft_mpc.cleanup" not in d.spans)
    return 1e-3 * us / run.periods
