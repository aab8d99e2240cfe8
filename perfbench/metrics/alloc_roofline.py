"""The allocation's share of its roofline: the least time the bank's
thruster allocation could take on the chip over the device time of
everything launched while the program's `ft_mpc.allocation` span was open.

Work of one call on B rows: read D (6 x 16, shared), the wrench and the
fault wrench (6 each), the bounds (16), the hull (F x 6, F), the generators
(6 x 16, 6), the step and the thrust bound; write u (16), the allocated
wrench (6) and 3 flags; float32, each once.  Operations: a frozen copy of
`chip_smoke.py:alloc_flops` at the configured FISTA and ADMM iterations.
The work does not depend on the QP's dense rows (terminal, state box,
wrench rate).
"""

from perfbench import peaks, trace


def alloc_flops(B, F, fista, admm):
    per = (12 * F
           + fista * (4 * 96 + 6 * 16)
           + 2 * 6 * 6 * 16 * 3 + 2 * 700
           + admm * (4 * 192 + 72 + 12 * 16 + 6 * 6)
           + 3 * 192 + 72)
    return float(B) * per


def work(B, F, fista, admm):
    """(bytes, operations) of one call on B rows."""
    n_bytes = 4.0 * (6 * 16 + B * (6 + 6 + 16 + F * 6 + F + 6 * 16 + 6 + 2 + 16 + 6 + 3))
    return n_bytes, alloc_flops(B, F, fista, admm)


def read(run):
    dev = trace.device_seconds(run.trace, "ft_mpc.allocation")
    if dev <= 0:
        return None
    a, F = run.config["allocation"], run.config["padding"]["hull_facets"]
    w = peaks.bound_s(*work(run.B, F, a["fista_iters"], a["admm_iters"]))
    return 100.0 * w * run.periods / dev
