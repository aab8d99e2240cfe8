"""ADMM's share of its roofline: the least time its configured iterations
could take on the chip over the device time of everything launched while
the program's `ft_mpc.admm` span was open.

The work is counted from the problem's shapes and the configured budget,
not from what implements it: per period, sqp_iters x phases solves of
`iters` iterations on the bank's B rows and cleanup_phases solves of
cleanup_iters iterations on its K rows.  A solve reads K^-1 (n x n), the
hull (F x 6) and its offsets (Nt x F), the dense rows (T x n) and offsets
(T), g, the start x, z and y and rho, and writes x, z and y, each once,
float32.  Operations: a frozen copy of `chip_smoke.py:admm_flops`.

The dense rows are the padded terminal rows and, after them, the rows of
the configuration's bounds (`cell.extra_rows`, as the program's
`n_extra_rows` counts them): 2 x 13 x (Nt - 1) for a state box, one-sided
or not, and 2 x 6 x (Nt - 1) for a wrench-rate bound.  At Nt=15 with both,
T = 64 + 364 + 168 = 596.  No other reader's work depends on T: condensing
reads the stages' A, B and defects and writes S and phi, the allocation
reads the hull and the generators.
"""

from perfbench import cell, peaks, trace

N_U = 6


def admm_flops(B, Nt, F, T, iters):
    n = N_U * Nt
    per_iter = (2 * n * F + 2 * n * T + 2 * n * n  # rhs, K^-1 matvec
                + 2 * Nt * F * 6 + 2 * T * n        # hull and dense rows of x~
                + 12 * (Nt * F + T) + 6 * n)        # projections, duals, relaxation
    return float(B) * iters * per_iter


def admm_bytes(B, Nt, F, T):
    n = N_U * Nt
    ins = n * n + F * 6 + Nt * F + T * n + T + n + n + 2 * (Nt * F + T) + 1
    outs = n + 2 * (Nt * F + T)
    return 4.0 * B * (ins + outs)


def work_s(run):
    m = run.config["mpc"]
    Nt, F = m["horizon"], run.config["padding"]["hull_facets"]
    T = run.config["padding"]["terminal_rows"] + cell.extra_rows(run.config)
    calls = [(run.B, m["admm"]["iters"])] * (m["sqp_iters"] * m["admm"]["phases"])
    if m["cleanup_iters"] > 0:
        calls += [(run.K, m["cleanup_iters"])] * (m["cleanup_phases"] * m["cleanup_rounds"])
    return sum(peaks.bound_s(admm_bytes(b, Nt, F, T), admm_flops(b, Nt, F, T, it))
               for b, it in calls)


def read(run):
    if run.config["mpc"]["qp_backend"] != "condensed":
        return None
    dev = trace.device_seconds(run.trace, "ft_mpc.admm")
    return 100.0 * work_s(run) * run.periods / dev if dev > 0 else None
