"""Whole-bank exact refactors of the ADMM metric's inverse a period: the
program's `newton_kinv.rescues` counter over the untraced window's periods
(the condensed backend's Newton-Schulz refresh; the stagewise backend has
no such metric)."""


def read(run):
    if run.config["mpc"]["qp_backend"] != "condensed" or run.window_periods == 0:
        return None
    return run.rescues / run.window_periods
