"""The LQR re-solves' share of their roofline: the least time the stagewise
ADMM's re-solves and their per-phase preparations could take on the chip
over the device time of everything launched while the program's
`ft_mpc.riccati` spans were open.

Counted from the shapes and the configured budget: per period,
sqp_iters x phases x iters re-solves on the bank's B rows and
cleanup_phases x cleanup_iters on its K rows; a preparation a phase.  A
re-solve reads the factorization of every stage (F 13 x 13, B 13 x 6, c 13,
K 6 x 13, Quu^-1 6 x 6, P c 13) and the linear terms (q 13, r 6 a stage,
qN, x0) and writes X and U, float32, each once; its operations are the two
affine sweeps as written (a frozen copy of `chip_smoke.py`'s
RICCATI_BWD_FLOPS + RICCATI_FWD_FLOPS).  A preparation reads the
factorization once (RICCATI_PREP_FLOPS a stage).
"""

from perfbench import peaks, trace

N_X, N_U = 13, 6
BWD_FLOPS = 13 + 2 * 78 + 6 + 2 * 36 + 2 * 169 + 2 * 78 + 2 * 13
FWD_FLOPS = 2 * 78 + 6 + 2 * 78 + 2 * 169 + 2 * 13
PREP_FLOPS = 2 * 169 + 2 * 78
FACT = N_X * N_X + N_X * N_U + N_X + N_U * N_X + N_U * N_U + N_X  # a stage


def resolve_work(R, Nt):
    """(bytes, operations) of one re-solve on R rows."""
    n_bytes = 4.0 * R * (Nt * (FACT + N_X + N_U) + 2 * N_X + (Nt + 1) * N_X + Nt * N_U)
    return n_bytes, float(R) * Nt * (BWD_FLOPS + FWD_FLOPS)


def prepare_work(R, Nt):
    """(bytes, operations) of one preparation on R rows."""
    return 4.0 * R * Nt * FACT, float(R) * Nt * PREP_FLOPS


def read(run):
    m = run.config["mpc"]
    if m["qp_backend"] != "stagewise":
        return None
    dev = trace.device_seconds(run.trace, "ft_mpc.riccati")
    if dev <= 0:
        return None
    s, Nt = m["stagewise"], m["horizon"]
    phases = [(run.B, s["iters"])] * (m["sqp_iters"] * s["phases"])
    if m["cleanup_iters"] > 0:
        phases += [(run.K, m["cleanup_iters"])] * (m["cleanup_phases"] * m["cleanup_rounds"])
    work = sum(peaks.bound_s(*prepare_work(R, Nt)) + it * peaks.bound_s(*resolve_work(R, Nt))
               for R, it in phases)
    return 100.0 * work * run.periods / dev
