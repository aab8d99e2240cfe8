"""The long-horizon operating envelope on the card, counterpart of
`benchmarks/envelope.py`.

Measures ms a step of the batched control step (`long_horizon.run`) at the
JAX script's seven (Nt, backend, B) points and reports, for each horizon,
the largest measured B whose step meets the 100 ms control period.

For the stagewise-lanes points it also estimates the bytes the Riccati
re-solve streams a step and the share of the H100's HBM peak (3.35 TB/s at
the full 700 W; the record names the card's power limit) that the measured
step time would imply.  The count is the port's own layout
(`csrc/riccati.cu`): a re-solve reads each stage's 588-float record
(`lanes_riccati.REC`), q and r, and qN and x0, and writes X and U; a phase's
preparation reads the factorization (F, B, K, Quu_inv, PC, c) and writes
the records.  The chunk transfer matrices (13x13 a chunk, at most 2% of the
records at Nt=240) are not counted.  The effective full-batch iteration
count is the JAX script's (`envelope.py:76-78`): sqp_iters * iters +
cleanup * 2 * K / B.

    python -m ft_mpc_torch.benchmarks.envelope [--reps 5] [--device cuda|cpu]
        [--out FILE]

Prints one JSON line a point and the envelope; --out writes the record.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

from ft_mpc_torch.benchmarks import common, long_horizon

N, M = 13, 6
PERIOD_MS = 100.0
# (Nt, backend, B): envelope.py:47-55
POINTS = (
    (15, "condensed", 512),
    (15, "condensed", 2048),
    (60, "stagewise-lanes", 256),
    (60, "stagewise-lanes", 512),
    (240, "stagewise-lanes", 64),
    (240, "stagewise-lanes", 128),
    (240, "stagewise-lanes", 512),
)


def resolve_bytes(nt: int, b: int) -> float:
    """Bytes one re-solve of b scenarios reads and writes (float32)."""
    from ft_mpc_torch.solvers.lanes_riccati import REC

    reads = nt * (REC + N + M) + N + N  # records, q, r; qN, x0
    writes = (nt + 1) * N + nt * M  # X, U
    return 4.0 * b * (reads + writes)


def prepare_bytes(nt: int, b: int) -> float:
    """Bytes one preparation of b scenarios reads and writes (float32)."""
    from ft_mpc_torch.solvers.lanes_riccati import REC

    return 4.0 * b * nt * (N * N + 2 * N * M + M * M + 2 * N + REC)


def eff_iters(args, b: int) -> float:
    """envelope.py:76-78: full-batch re-solves a step."""
    return args.sqp_iters * args.iters + args.cleanup * 2 * (max(1, b // 8) / b)


def stream_bytes(nt: int, b: int, args) -> float:
    """Bytes the stagewise-lanes step streams through the Riccati kernels:
    its re-solves and, once a phase, its preparations (the cleanup's two
    phases on K = B/8 rows)."""
    preps = args.sqp_iters + 2 * (max(1, b // 8) / b)
    return resolve_bytes(nt, b) * eff_iters(args, b) + prepare_bytes(nt, b) * preps


def envelope_summary(rows) -> dict:
    """envelope.py:86-95: for each Nt, the largest B meeting the period and
    its ms a step, or a note that none does."""
    env = {}
    for nt in sorted({r["Nt"] for r in rows}):
        ok = [r for r in rows if r["Nt"] == nt and r["meets_100ms"]]
        if ok:
            b = max(r["B"] for r in ok)
            env[str(nt)] = {"max_B_under_100ms": b,
                            "ms_per_step": min(r["ms_per_step"] for r in ok if r["B"] == b)}
        else:
            env[str(nt)] = {"max_B_under_100ms": 0, "note": "no measured point meets 100 ms"}
    return env


def main(points=POINTS, sqp_iters: int = 2, iters: int = 60, cleanup: int = 300,
         reps: int = 5, device=None, out=None) -> dict:
    """Every point through `long_horizon.run`; returns the record (and
    writes it to `out`)."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    args = SimpleNamespace(sqp_iters=sqp_iters, iters=iters, cleanup=cleanup, reps=reps)
    ident = common.card_identity(dev)
    rows = []
    for nt, backend, b in points:
        r = long_horizon.run(nt, backend, b, args, dev)
        row = {"Nt": nt, "backend": backend, "B": b, **r,
               "meets_100ms": r["ms_per_step"] <= PERIOD_MS, "eff_iters": eff_iters(args, b)}
        if backend == "stagewise-lanes":
            gb = stream_bytes(nt, b, args) / 1e9
            achieved = gb / (r["ms_per_step"] / 1e3)
            row.update(est_stream_GB_per_step=gb, achieved_GB_s=achieved,
                       h100_hbm_peak_fraction=achieved * 1e9 / common.H100_HBM_BYTES_PER_S)
        rows.append(row)
        print(json.dumps(row), flush=True)

    record = {"budgets": vars(args), "points": rows, "envelope_100ms": envelope_summary(rows),
              "hbm_peak_GB_s": common.H100_HBM_BYTES_PER_S / 1e9, **ident}
    fracs = [r["h100_hbm_peak_fraction"] for r in rows if "h100_hbm_peak_fraction" in r]
    if fracs and ident["card"] is not None:
        record["roofline_note"] = (
            f"the stagewise-lanes step implies at most {100 * max(fracs):.2f}% of the "
            f"H100's HBM peak ({record['hbm_peak_GB_s']:.0f} GB/s) under the re-solve "
            f"stream model, on {ident['nvidia_smi']}")
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--cleanup", type=int, default=300)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    record = main(POINTS, a.sqp_iters, a.iters, a.cleanup, a.reps, a.device, a.out)
    print(json.dumps(record["envelope_100ms"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
