"""Condensing's share of its roofline: the least time the prediction
matrices could take on the chip over the device time of everything launched
while the program's `ft_mpc.condense` span was open.

Work per call on R rows (a frozen copy of `chip_smoke.py:check_condense`'s
count): read the stage A (13 x 13), B (13 x 6) and defects (13), write S
(13 x n at every stage) and phi (13), float32, each once; operations of the
recursion, 13 x 13 @ 13 x n a stage for S and 13 x 13 for phi.  Per period:
sqp_iters calls on the bank's B rows and cleanup_rounds calls on its K rows.
The work does not depend on the dense rows that follow (terminal, state box,
wrench rate): those are the ADMM's.
"""

from perfbench import peaks, trace

N_X, N_U = 13, 6


def work(R, Nt):
    """(bytes, operations) of one call on R rows."""
    n = N_U * Nt
    n_bytes = 4.0 * R * Nt * (N_X * N_X + N_X * N_U + N_X + N_X * n + N_X)
    flops = float(R) * Nt * (2 * N_X * N_X * n + 2 * N_X * N_X + N_X + N_X * N_U)
    return n_bytes, flops


def call_s(R, Nt):
    return peaks.bound_s(*work(R, Nt))


def read(run):
    m = run.config["mpc"]
    if m["qp_backend"] != "condensed":
        return None
    dev = trace.device_seconds(run.trace, "ft_mpc.condense")
    if dev <= 0:
        return None
    total = m["sqp_iters"] * call_s(run.B, m["horizon"])
    if m["cleanup_iters"] > 0:
        total += m["cleanup_rounds"] * call_s(run.K, m["horizon"])
    return 100.0 * total * run.periods / dev
