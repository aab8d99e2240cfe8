"""A cell as data: its `BENCHMARK.json` entry, the configuration's file, the
traffic mix's file and the limits of its comparison, found by name.

    configs/<config>.json    the deployment: plant, tuning, weights and
                             bounds, solver budget, precision, guarantees
    traffic/<traffic>.json   the bank's patterns and size, initial states,
                             noise, reference, warm-up / traced / checked periods
    checks/<cell>.json       each compared number's limit and the readings
                             it was set from
    metrics/<metric>.py      a per-layer metric's reader (see `metrics/`)

A cell is added by adding files; no code here names a cell.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

N_X, N_U = 13, 6
# a configuration's optional bounds: the names and sizes of the program's
# `MPCWeights` fields (the state box on all 13 states, the wrench rate)
BOUNDS = {"x_lb": N_X, "x_ub": N_X, "du_max": N_U}

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(workload: str, bench_path: Path | None = None, data: Path | None = None):
    """The cell `workload`: (its entry, config, traffic, limits, the end-to-end
    and per-layer metric entries that it reports)."""
    bench = json.loads((bench_path or ROOT / "BENCHMARK.json").read_text())
    data = data or HERE
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    read = lambda sub, name: json.loads((data / sub / f"{name}.json").read_text())
    reports = lambda m: workload in m.get("workloads", [workload])
    return SimpleNamespace(
        entry=cell, config=read("configs", cell["config"]),
        traffic=read("traffic", cell["traffic"]), limits=read("checks", workload),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def cleanup_k(config: dict, B: int) -> int:
    return max(1, int(B * config["mpc"]["cleanup_k_fraction"]))


def reference_cfg(config: dict, B: int) -> SimpleNamespace:
    """The configuration as the reference reads it."""
    m = config["mpc"]
    return SimpleNamespace(
        **{k: v for k, v in m.items() if k not in ("admm", "stagewise", "cleanup_k_fraction")},
        admm=SimpleNamespace(**m["admm"]), stagewise=SimpleNamespace(**m["stagewise"]),
        cleanup_k=cleanup_k(config, B), alloc=dict(config["allocation"]))


def weight_bounds(config: dict) -> dict:
    """The configuration's bounds, each a list or None where the file has no
    such key; a key in `weights` other than Q, R and these, or a bound of
    the wrong length, is refused."""
    w = config["weights"]
    unknown = sorted(set(w) - {"Q", "R", *BOUNDS})
    if unknown:
        raise ValueError(f"weights: unknown key(s) {unknown}; "
                         f"the file may give Q, R and {sorted(BOUNDS)}")
    for k, n in BOUNDS.items():
        if k in w and len(w[k]) != n:
            raise ValueError(f"weights: {k} has {len(w[k])} numbers, not {n}")
    return {k: w.get(k) for k in BOUNDS}


def extra_rows(config: dict) -> int:
    """The dense rows that the bounds add after the terminal rows: both
    sides of the box (even one-sided) on the 13 states of stages 1..Nt-1,
    both signs of the rate on the 6 wrench components of steps 1..Nt-1."""
    b = weight_bounds(config)
    per_stage = (N_X if b["x_lb"] is not None or b["x_ub"] is not None else 0) \
        + (N_U if b["du_max"] is not None else 0)
    return 2 * per_stage * (config["mpc"]["horizon"] - 1)


def bank_rows(traffic: dict) -> list[int]:
    """Row i of the bank carries pattern rows[i]: the patterns in order,
    repeated to the batch."""
    if traffic["tiling"] != "in_order":
        raise ValueError(f"unknown tiling {traffic['tiling']!r}")
    P = len(traffic["patterns"])
    return [i % P for i in range(traffic["batch"])]
