"""Float32 NaN sanitizer of the deployed closed loop over the whole fault
census, counterpart of `benchmarks/sanitizer_onchip.py`.

The float32 NaN risk of the batched controller (K's condition number about
1e5) depends on the geometry, so the whole census runs: healthy, the 16
single and the 120 double faults (`default_fault_pool()`, the JAX script's
order), each built by `build_scenario_with_terminal(BodyParams.default(0.1,
torch.float32), f, DEFAULT_TUNING)` from the terminal cache, stacked into
one bank of B=137 rows on the device.  The configuration is the JAX
script's (`sanitizer_onchip.py:51-55`): horizon 15, 2 SQP iterations, ADMM
60x1 at rho 50 with adapt_clip 1.5, the worst-16 cleanup at 300x2; hover
references for 10 s about the healthy scenario's omega_des; states from
`default_rng(7)` (`:93-99`).

The run: four chained windows of `batched_rollout_lanes` (50 steps each,
'zero_mean' state noise from a generator on the device seeded with the
window's index; each window starts from the previous window's last
solve-time state, as the JAX script chains them), then the per-scenario
`rollout` on the (10, 11) double fault for 50 steps (no kernel runs there).
PyTorch has no `jax_debug_nans`: instead every field of every window's
`RolloutHistory` is checked at every step, and the first non-finite entry
raises `NonFiniteError`, naming the window, the step, the field, the rows
and their fault patterns (the JAX script asserts only the final `state` and
`u_phys`).

The record keeps the JAX script's fields (contraction counts within 50 and
200 steps, min / median / max of the 200-step ratio, the patterns that do
not contract with their ratio and whether their terminal ingredients are
the uncertified quadratic fallback, the uncertified patterns read from the
committed entries' meta, the largest term_gap over the last 5 steps, the
rollout's seconds), unrounded, and adds the card's: per-step ms (p50 and
p99 of the 200 steps, host clock to a device synchronize), `newton_kinv`
rescues (whole-batch exact refactors; apart, those taken because a
residual was non-finite, which no history field shows), the kernels' launches a step (3 / 4 / 1: condensing once per SQP
iteration and once in the cleanup, ADMM once per SQP iteration and once per
cleanup phase, allocation once; each window's `init_warmstart_batch`
condenses once more), and the card's name and power limit.

Gates, as the JAX script's (`:182-183`): max_term_gap_final <= 1e-3, and
every pattern contracts (ratio < 0.5 after 200 steps).

    python -m ft_mpc_torch.benchmarks.sanitizer [--device cuda|cpu] [--out FILE]

Prints the record as one JSON line, last; exits 1 when a gate fails and 2
when a non-finite value appears.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ft_mpc_torch.benchmarks import common

HORIZON = 15
WINDOWS = 4
WINDOW_STEPS = 50
SCENARIO_STEPS = 50  # the per-scenario rollout
DURATION = 10.0  # s of hover reference
SEED = 7
MASS = 16.8
CONTRACTION = 0.5  # a pattern contracts where its error falls below half its start
GAP_GATE = 1e-3
GAP_STEPS = 5  # max_term_gap_final: the last 5 steps
SCENARIO_PATTERN = (10, 11)  # the per-scenario rollout's double fault
# launches a step: condensing per SQP iteration and in the cleanup, ADMM per
# SQP iteration and per cleanup phase, allocation once
LAUNCHES_PER_STEP = {"condense_lanes": 3, "admm_lanes": 4, "allocate_thrusters_lanes": 1}


class NonFiniteError(FloatingPointError):
    """A non-finite value in a closed loop's history."""


def config():
    """`sanitizer_onchip.py:51-55`: the deployed configuration with its
    worst-16 cleanup."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig

    return MPCConfig(
        horizon=HORIZON, sqp_iters=2,
        admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
        cleanup_iters=300, cleanup_k=16, cleanup_phases=2,
    )


def census() -> list:
    """healthy, the 16 single and the 120 double faults, in the JAX
    script's order (`sanitizer_onchip.py:59-65`)."""
    from ft_mpc_torch.geometry.scenario import default_fault_pool

    return default_fault_pool()


def uncertified(patterns) -> list[int]:
    """The rows whose committed entry is the quadratic fallback (its meta,
    `sanitizer_onchip.py:72-85`)."""
    from ft_mpc_torch.api import DEFAULT_TUNING, cached_terminal_path
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.terminal.pipeline import load_terminal_ingredients

    plant = BodyParams.default(common.DT, dtype=torch.float32, device="cpu")
    return [i for i, f in enumerate(patterns) if "fallback" in load_terminal_ingredients(
        cached_terminal_path(plant, f, DEFAULT_TUNING)).meta]


def x0_states(B: int) -> np.ndarray:
    """`sanitizer_onchip.py:93-99` exactly: seeded positions, velocities and
    rates, identity attitude, float32."""
    rng = np.random.default_rng(SEED)
    x0 = np.zeros((B, 13), np.float32)
    x0[:, 0:3] = rng.uniform(-0.5, 0.5, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.2, 0.2, (B, 3))
    x0[:, 6:10] = [0, 0, 0, 1]
    x0[:, 10:13] = rng.uniform(-0.3, 0.3, (B, 3))
    return x0


def references(omega_des) -> tuple[np.ndarray, np.ndarray]:
    """(x_ref, u_ref), float32: 10 s of hover about `omega_des`
    (`sanitizer_onchip.py:56, 87-91`)."""
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    traj = generate_trajectory("hover", common.DT, DURATION)
    x_ref, u_ref = prepare_center_trajectory(traj, np.asarray(omega_des), MASS, common.DT,
                                             HORIZON + 1)
    return x_ref.astype(np.float32), u_ref.astype(np.float32)


def inputs(device, patterns=None):
    """The run's inputs on `device`: `patterns`, `bank` (one row each),
    `uncertified` (rows), `params`, `weights`, `cfg`, `x0`, `x_ref`,
    `u_ref`, `build_s` (host seconds of the bank's build and copy)."""
    from ft_mpc_torch.api import DEFAULT_TUNING
    from ft_mpc_torch.controllers.spiraling import MPCWeights
    from ft_mpc_torch.ops.dynamics import BodyParams

    patterns = census() if patterns is None else patterns
    t0 = time.perf_counter()
    scs = common.build_scenarios(patterns)
    bank = common.tiled_bank(scs, len(scs), device)
    common.sync(device)
    build_s = time.perf_counter() - t0
    x_ref, u_ref = references(scs[0].omega_des.cpu().numpy())
    t = lambda a: torch.as_tensor(a, device=device)
    return SimpleNamespace(
        patterns=patterns, bank=bank, uncertified=uncertified(patterns), build_s=build_s,
        params=BodyParams.default(common.DT, dtype=torch.float32, device=device),
        weights=MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                          dtype=torch.float32, device=device),
        cfg=config(), x0=t(x0_states(len(patterns))), x_ref=t(x_ref), u_ref=t(u_ref))


def pattern_indices(pattern) -> list[int]:
    return [int(f.index) for f in pattern]


def check_finite(hist, window, patterns) -> None:
    """Raise NonFiniteError at the first step of `hist` (B, T, ...) where a
    field holds a non-finite value; at that step the first such field, in
    the history's order, is named with its rows and their patterns."""
    first = None
    for field, x in zip(hist._fields, hist):
        bad = ~torch.isfinite(x.reshape(x.shape[0], x.shape[1], -1)).all(dim=2)  # (B, T)
        steps = torch.nonzero(bad.any(dim=0)).flatten()
        if len(steps) and (first is None or int(steps[0]) < first[0]):
            step = int(steps[0])
            first = (step, field, torch.nonzero(bad[:, step]).flatten().tolist())
    if first is not None:
        step, field, rows = first
        raise NonFiniteError(
            f"non-finite {field} in window {window}, step {step}, rows {rows} (patterns "
            f"{[pattern_indices(patterns[r]) for r in rows]})")


def _centre_error(hist, step: int) -> np.ndarray:
    """|orbit-centre position - reference| of each row at `step`."""
    return torch.linalg.vector_norm(
        hist.c0[:, step, 0:3] - hist.x_ref0[:, step, 0:3], dim=1).double().cpu().numpy()


def run(s) -> dict:
    """The closed loops on `inputs`' `s` (WINDOWS windows of WINDOW_STEPS
    steps, SCENARIO_STEPS per-scenario steps); returns the record without
    the card's identity.  Also sets `s.last_step`: the last batched step's
    robot state `x0`, warm start `warm` and reference windows `x_ref`,
    `u_ref`."""
    from ft_mpc_torch.geometry.scenario import take_rows
    from ft_mpc_torch.sim.env import SimConfig, _window, batched_rollout_lanes, rollout

    windows, window_steps, scenario_steps = WINDOWS, WINDOW_STEPS, SCENARIO_STEPS
    dev = s.x0.device
    patterns, B = s.patterns, len(s.patterns)
    sim = SimConfig(steps=window_steps, noise_mode="zero_mean")
    marks, last = [], {}

    def on_step(i, state, warm):
        common.sync(dev)
        marks[-1].append(time.perf_counter())
        if i < window_steps:
            last.update(i=i, x0=state, warm=warm)

    common.zero_counters()
    t0 = time.perf_counter()
    state = s.x0
    for w in range(windows):
        marks.append([])
        gen = torch.Generator(device=dev).manual_seed(w)
        hist = batched_rollout_lanes(s.params, s.bank, s.weights, s.cfg, sim, state, s.x_ref,
                                     s.u_ref, gen, on_step=on_step)
        check_finite(hist, w, patterns)
        if w == 0:
            e0, e50 = _centre_error(hist, 0), _centre_error(hist, -1)
        state = hist.state[:, -1]
    common.sync(dev)
    lanes_s = time.perf_counter() - t0
    counted = common.read_launches(windows * window_steps)
    eT = _centre_error(hist, -1)
    gap = hist.term_gap[:, -GAP_STEPS:].amax(dim=1).double().cpu().numpy()
    Nt = s.cfg.horizon
    s.last_step = SimpleNamespace(x0=last["x0"], warm=last["warm"],
                                  x_ref=_window(s.x_ref, last["i"], Nt + 1),
                                  u_ref=_window(s.u_ref, last["i"], Nt + 1))

    # the per-scenario path on the reference's double fault
    want = [f for f in patterns if tuple(pattern_indices(f)) == SCENARIO_PATTERN]
    i_ref = patterns.index(want[0]) if want else 0
    common.zero_counters()
    t0 = time.perf_counter()
    h = rollout(s.params, take_rows(s.bank, i_ref), s.weights, s.cfg,
                sim._replace(steps=scenario_steps), s.x0[i_ref], s.x_ref, s.u_ref,
                torch.Generator(device=dev).manual_seed(0))
    # one rollout: histories (T, ...), checked as a batch of one row
    check_finite(type(h)(*(x[None] for x in h)), "per-scenario", [patterns[i_ref]])
    common.sync(dev)
    scenario_s = time.perf_counter() - t0
    scenario_launches = common.read_counters()

    ms = 1e3 * np.concatenate([np.diff(m) for m in marks])
    ratio_50 = e50 / np.maximum(e0, 1e-9)
    ratio = eT / np.maximum(e0, 1e-9)
    contracting = ratio < CONTRACTION
    unc = set(s.uncertified)
    record = {
        "artifact": "float32 NaN sanitizer run of the batched closed loop, full fault census",
        "sanitizer": "every RolloutHistory field finite at every step of every window",
        "batch": B,
        "geometries": "healthy + 16 singles + 120 doubles" if B == 137 else f"{B} patterns",
        "steps": windows * window_steps,
        "windows": windows,
        "config": "sqp=2 admm=60x1 cleanup=300x2@K16 fp32",
        "all_finite": True,
        "n_contracting_200_steps": int(contracting.sum()),
        "n_contracting_50_steps": int((ratio_50 < CONTRACTION).sum()),
        "contraction_200_min_med_max": [float(np.min(ratio)), float(np.median(ratio)),
                                        float(np.max(ratio))],
        "not_contracting": [{"pattern": pattern_indices(patterns[i]),
                             "ratio_200": float(ratio[i]),
                             "uncertified_terminal": int(i) in unc}
                            for i in np.flatnonzero(~contracting)],
        "uncertified_patterns": [pattern_indices(patterns[i]) for i in s.uncertified],
        "max_term_gap_final": float(gap.max()),
        "lanes_rollout_s": lanes_s,
        "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p99": float(np.percentile(ms, 99)),
        "step_ms_max": float(ms.max()),
        "per_scenario_pattern": pattern_indices(patterns[i_ref]),
        "per_scenario_steps": scenario_steps,
        "per_scenario_rollout_s": scenario_s,
        "per_scenario_launches": scenario_launches,
        "bank_build_s": s.build_s,
        "newton_rescues": counted["newton_rescues"],
        "newton_rescues_nonfinite": counted["newton_rescues_nonfinite"],
        "launches": counted["launches"],
        "launches_per_step": counted["launches_per_step"],
        "launches_expected": {k: v * windows * window_steps
                              + (windows if k == "condense_lanes" else 0)
                              for k, v in LAUNCHES_PER_STEP.items()},
        "admm_launches_by_design": counted["admm_launches_by_design"],
    }
    record["failed_gates"] = gates(record)
    return record


def gates(record: dict) -> list[str]:
    """`sanitizer_onchip.py:182-183`'s gates that the record fails."""
    failed = []
    if not record["max_term_gap_final"] <= GAP_GATE:
        failed.append(f"closed-loop restoration gap remains: max_term_gap_final "
                      f"{record['max_term_gap_final']} > {GAP_GATE}")
    if record["not_contracting"]:
        failed.append(f"not contracting in {record['steps']} steps: "
                      f"{record['not_contracting']}")
    return failed


def main(device=None, out=None) -> dict:
    """Run the sanitizer on the census; returns the record (and writes it to
    `out`).  A non-finite value raises NonFiniteError."""
    from ft_mpc_torch import resolve_device

    dev = resolve_device(device)
    ident = common.card_identity(dev)
    s = inputs(dev)
    record = {**run(s), **ident}
    common.write_record(record, out)
    return record


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record (JSON) here")
    a = ap.parse_args(argv)
    try:
        record = main(device=a.device, out=a.out)
    except NonFiniteError as e:
        print(f"sanitizer: {e}", file=sys.stderr)
        return 2
    if record["failed_gates"]:
        print("sanitizer gates FAILED: " + "; ".join(record["failed_gates"]), file=sys.stderr)
    print(json.dumps(record))
    return 1 if record["failed_gates"] else 0


if __name__ == "__main__":
    raise SystemExit(cli())
