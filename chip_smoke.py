#!/usr/bin/env python3
"""Run the PyTorch port (`ft_mpc_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile out.txt   # also trace steps of both paths

1. Builds the CUDA kernels of `ft_mpc_torch/csrc/` with nvcc (one process
   per source, all at once) into `build/`.
2. Drives the condensed path: the batched condensed control step at the bench's
   size (`bench.py`: B=2048 scenarios tiled from the 32-pattern bank,
   horizon 15, 2 SQP iterations, 60 ADMM iterations, 3 Newton steps,
   worst-256 cleanup at 600x3), `init_warmstart_batch` and then
   WARMUP + STEPS = 10 + 30 warm-chained `get_control_batch` steps, as
   bench.py chains them.  The kernels' launch counters are zeroed just
   before and read just after.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and times both (CUDA events around back-to-back
   calls, median of 3 rounds; a kernel's calls are all queued before the
   first event); each kernel line carries its share of the bound
   (bound_ms / ms), and ADMM's and allocation's their us per iteration.
   The allocation kernel is also held at its hull test's threshold and on
   the main path's own wrenches.
4. Compares one whole step on the card with the port's CPU run on 64 rows,
   from states near the terminal sets and from the bench's states.
5. Drives the stagewise (long-horizon) path at the largest point of
   `benchmarks/envelope.py`: B=512 scenarios, horizon 240, 2 SQP iterations,
   60 Riccati-in-ADMM iterations, worst-64 cleanup at 300x2, SW_WARMUP +
   SW_STEPS = 3 + 6 chained steps, with the launch counters zeroed just
   before and read just after: one backward and one forward sweep a
   re-solve (720 a step) in one launch, one preparation a phase (4 a
   step), printed a step and a re-solve and by design; then holds the
   Riccati re-solve at the plan `riccati_plan` gives (each sweep against
   its plain half, the pair against `lqr_resolve`, the preparation against
   its plain version) on the factorization and linear terms that path last
   gave it (B=512, the cleanup's B=64 and its first 8 rows, the
   long-horizon envelope's cleanup batch), the allocation kernel on that path's own
   wrenches (B=512, held and timed), and compares two chained stagewise
   steps on the card with the CPU run at B=32, horizon 60.  The path's
   max_r_prim and max_term_gap are gated.
6. Drives the closed loop (`ft_mpc_torch/sim/env.py`), each run with the
   launch counters zeroed just before and read just after:
   - `batched_rollout_lanes` at the condensed path's configuration, B=2048,
     LOOP_STEPS = 20 steps, seeded 'reference' noise: per-step times, the
     kernels' launches per step (3 / 5 / 1), the plant and fault gates, and
     the allocation kernel held on the last step's wrenches;
   - 3 closed-loop steps at B=32 (one row per pattern, no noise), each step
     also taken by the port's CPU run from the card's state and warm start;
   - the per-scenario path, which launches no kernel: the demo through its
     own entry point (`ft_mpc_torch.examples.sim.main`, as
     `examples/sim.py` runs it: the (10, 11) double fault, 300 steps of
     hover, 'reference' noise; its final orbit-centre error gated below
     0.1 m),
     `batched_rollout` at B=128 for 10 steps, `rollout_with_fault_schedule`
     (healthy, then (10, 11) from step 15 of 25), and the stagewise backend
     (mode 'scan', horizon 60) for 3 steps.
7. Drives banks built by the port itself (`ft_mpc_torch.api`,
   `geometry.scenario`), each run with the launch counters zeroed just
   before and read just after:
   - builds all 137 fault classes of bench.py's census (healthy, 16 singles,
     120 doubles) with `build_scenario_with_terminal(..., DEFAULT_TUNING)`
     from the terminal cache on the host, and holds its first 32 rows leaf
     for leaf against `ft_mpc_torch/data/bench_bank32.npz`;
   - runs the condensed configuration of section 2 on that bank tiled to
     B=2048 and on `build_randomized_bank(n=2048, seed=0)` (per-row mass and
     inertia, the rows' own states), 3 + 10 steps each: plant and launch
     gates (3 / 5 / 1 a step), kernels 1-3 held on each bank's own inputs,
     and one whole step card vs CPU port on 64 / 32 rows;
   - runs the condensed path at B=256 and horizons 20, 38 and 40 (the ADMM
     cluster design: 1, 2 and 2 blocks a scenario) for 2 steps each, and
     holds the ADMM kernel against its plain version on each run's last QP
     (T=64, 60 iterations).

8. Drives the user-facing slice (`ft_mpc_torch.api`, the demo, the
   accuracy harness, the offline pipeline):
   - the terminal pipeline on the card for healthy, (8, 9) (a searched
     orbit) and (12, 13) (the quadratic fallback), each a miss of an empty
     cache, against the committed entry: orbit, emax, r_empc and the
     terminal set exactly, the grid's feasible points against the committed
     run's (those decided otherwise on the 1e-4 threshold), P9, p9 and c
     within 1e-3; host seconds and the grid's batched ADMM time;
   - `SpiralingMPC` and `SimulationEnvironment` at the demo's tuning from
     the demo's state, 10 steps, `set_fault` with a single fault the
     committed cache lacks (timed), 10 more steps; the broken thruster at
     most 1e-6 N; `to_history` and `export_csv` (67 columns);
   - the demo's `main` with --batch 16, its duration cut to 1.5 s, cache
     misses through the pipeline;
   - the whole lanes step at B=1 (the accuracy harness's lanes leg: cleanup
     K=1 over 4 rounds) for 3 chained steps, launches counted, each step
     against the CPU port from the card's state and warm start, and kernels
     1-3 against their plain versions on the last step's inputs;
   - `kkt_residuals` in float64 at a converged per-scenario solution;
   - the accuracy harness (`ft_mpc_torch.benchmarks.accuracy`) for
     ACC_STEPS steps with the gates those steps reach.
9. Drives scenario sharding (`ft_mpc_torch.parallel`) and the planar model
   family (`ft_mpc_torch.models.planar`), each run with the launch counters
   zeroed just before and read just after:
   - 9a: `make_scenario_mesh()` (every CUDA device: one here), the condensed
     configuration of section 2 at B=2048 through `sharded_init_warmstart`
     and `sharded_control_step_lanes`, 3 + 10 steps: equal to a direct
     `get_control_batch` on the same inputs, launches 3 / 5 / 1 a step, the
     metrics the reductions of the outputs;
   - 9b: the same on two shards of the one card (`["cuda:0", "cuda:0"]`):
     each shard equal to `get_control_batch` on its own rows within 1e-6 N,
     2 x (3 / 5 / 1) launches a step; the rows whose cleanup differs from
     the unsharded step's (printed); `sharded_rollout_lanes` for 5 steps,
     one seeded generator per shard, with section 6's plant and fault gates;
   - 9c: `python -m ft_mpc_torch.parallel.launch` in subprocesses: a NCCL
     world of one with two shards, two processes sharing the card over gloo
     (equal to the first at 1e-5 N), a NCCL world of one with one shard;
   - 9d: `dryrun_multichip(2, device="cuda")`, its three legs gated (its
     boxed leg at B=4, T=216);
   - 9e: the planar bank (healthy, (6) and (2) stuck on, pipeline misses of
     an empty cache) tiled to B=2048 from planar states, 3 + 10 condensed
     steps: thrusters 8-15 at most 1e-6 N, max_term_gap <= 0.4, launches
     3 / 5 / 1, kernels 1-3 held and timed on its own inputs, one step card
     vs CPU on 32 rows; then `tests/test_planar.py`'s hover (per-scenario,
     15 steps), its drift printed and its absent thrusters gated at 1e-6 N.
10. Drives the condensed configuration of section 2 with the state box and
   rate rows of the reference's reactive.yaml (`tests/test_config_bounds.py`:
   0.5 m/s on the three velocities, du_max [2, 2, 2, 1, 1, 1]; T=596 dense
   rows at Nt=15), B=2048, `init_warmstart_batch` and 3 + 10 chained steps
   with the launch counters zeroed just before and read just after: p50,
   p99, solves/s, max_r_prim, max_term_gap and the largest planned stage
   velocity beyond the box printed; finite outputs, u_phys (2048, 16),
   launches 3 / 5 / 1 a step with every ADMM launch in the cluster design;
   the ADMM kernel held against its plain version on the path's last QP (60
   iterations) and on its worst 256 rows (600 iterations), each timed beside
   its bound; the allocation kernel on the path's wrenches; one whole step
   on 64 rows three ways (the kernels against their plain versions on the
   card and the card against the CPU port, from the path's states; the card
   against the CPU port near the terminal sets), each within TOL_STEP_U on
   the rows where every threshold of the step went the same way on both
   sides, with at most a quarter of the rows on a threshold (BOX_STATES_NOTE),
   the box excess of both sides and their distance from the CPU port in
   float64 printed.
11. Drives the bench entry and the measuring scripts of
   `ft_mpc_torch/benchmarks/` as smoke runs (the full measurements are their
   own calls), each record printed on a line of its own and gated; each
   script zeroes the launch counters just before its windows and reads them
   just after:
   - `bench.main` at B=2048 with 1 warm-up and BENCH_WINDOWS = 1 timed
     windows of 10 chained steps: no failed gate, the record's fields, the
     card's name and power limit, finite outputs, max_term_gap <= 0.4, the
     gap rows within the pinned set, launches 3 / 5 / 1 a step;
   - `envelope.main` on Nt=240 stagewise-lanes at B=64 and condensed at
     B=512 (2 + 2 steps each): max_r_prim <= 1e-2 and max_term_gap <= 0.4;
     one launch a re-solve (720 a step) and 4 preparations a step on the
     first, 3 / 4 / 1 on the second (its cleanup has 2 phases);
   - `long_horizon.run`'s 'stagewise' backend (mode 'scan') at Nt=15, B=64,
     1 + 1 steps: max_r_prim equal to the stagewise-lanes backend's at the
     same point (rtol 5e-2, atol 1e-3), max_term_gap <= 0.4, one allocation
     launch a step;
   - `profile_step.main` at B=2048 with one repetition a component and (h)
     at B=4096: host and event times for each component, the device-busy
     time and peak device memory of the full step, (a) and (h).

12. Drives the census scripts of `ft_mpc_torch/benchmarks/`, each record
   printed and gated:
   - 12a: the sanitizer (`sanitizer.inputs`, `sanitizer.run`) over the whole
     census, B=137 rows, 4 chained windows of 50 steps of
     `batched_rollout_lanes` (every history field finite at every step),
     then the per-scenario rollout on (10, 11) for 50 steps; its gates
     (every pattern contracts, max_term_gap_final <= 1e-3), launches
     3 / 4 / 1 a step with one more condensing a window (zeroed before the
     windows, read after), none on the per-scenario path; kernels 1-3 held
     and timed on the last batched step's inputs at B=137, and ADMM on its
     cleanup's K=16 rows at 300 iterations;
   - 12b: the census cache build (`build_terminal_cache.main`) on healthy,
     (0), (8, 9) and (12, 13) into a temporary directory: every row equal to
     the committed entry (orbit, emax, r_empc, terminal set; the grid's
     points decided otherwise on the threshold, the fit on the JAX run's
     points within 1e-3), counts 2 / 1 / 1, the committed cache untouched;
   - 12c: `scaling.main`: the bench at B=512 and 2048 with 1 timed window
     (no failed gate, 3 / 5 / 1 launches a step) and the sharded step on 1
     and 2 shards of the card, 2 chained steps each (2 / 2 / 1 launches a
     step a shard).

13. Drives the JAX repo's last measuring scripts, ported to
   `ft_mpc_torch/benchmarks/`, as smoke runs (their full measurements are
   their own calls), and `parallel.dryrun.entry`; each record printed and
   gated, every output of every step finite (each script raises otherwise):
   - 13a: `pareto.main` on two points, (2, 60, 1, 3, 0, 0) and the deployed
     one, B=2048, 2 rounds in turns after each point's untimed window:
     launches 2 / 2 / 1 and 3 / 5 / 1 a step, the record's card;
   - 13b: `diag_cleanup.run` at cleanup 300x1 on K=512 rows, B=2048, 3
     chained steps: launches 3 / 3 / 1 a step; the ADMM kernel held against
     its plain version on the run's worst 512 rows at 300 iterations and
     timed beside its bound (a row of the kernels line);
   - 13c: `diag_residual.run`'s pair at 160x2 on B=128, 3 steps each: the
     batched run 2 / 4 / 1 launches a step, the per-scenario run none; the
     ADMM kernel held and timed on the batched run's QP at B=128, 160
     iterations (a row of the kernels line); then the stagewise leg (B=512,
     Nt=240) at 2 steps, 720 re-solve launches and 4 preparations a step;
   - 13d: `diag_stub.main` at 3 steps with one rho and one budget of the
     probe: the worst row, its h_term, a finite probe;
   - 13e: `ablate.main` on two variants, 2 rounds: no kernel launch;
   - 13f: `entry()`'s step once: shapes (16,), (6,), (), finite, no launch.

14. Holds the linearization kernel (`ft_mpc_torch/csrc/linearize.cu`,
   `ops.linearize.linearize_lanes`) against its plain version
   (`linearize_plain`, vmap(jacfwd)) on the card at B=2048 / Nt=15 (the
   condensed path), B=512 / Nt=240 (the stagewise path) and B=64 / Nt=240
   (its cleanup), on each path's warm-start trajectory with seeded inputs:
   float32 within TOL_LINEARIZE and float64 within TOL_LINEARIZE_F64 of
   the scale of A, of B and of the states (`lin_gap`), both float32 sides'
   distance from the float64 plain version
   printed; the kernel timed alone (CUDA events, median of 3) beside its
   bound in bytes and operations, the wrapper's calls back to back and the
   plain version; then counts its launches on 2 chained steps of both paths:
   3 a step (two SQP iterations and the cleanup), 1 more in the condensed
   `init_warmstart_batch`, no plain call.

15. Holds the terminal kernel (`ft_mpc_torch/csrc/terminal.cu`,
   `ops.terminal.terminal_lanes`) against its plain version
   (`terminal_plain`, vmap of grad / hessian) on the main path's own inputs:
   the (term, e) of the first assembly (V, gradient and PSD-shifted
   Hessian) and of the first line search (V of the 3 x B candidates) of a
   condensed step at B=2048 and at the census's B=137, and of a stagewise
   step at B=512; float32 within TOL_TERMINAL_F32 (V, gradient, Hessian off
   the omega diagonal) and the omega diagonal within TOL_TERMINAL_SHIFT_F32
   of float64 or 4 times the plain float32's distance (`terminal_gaps`),
   float64 within TOL_TERMINAL_F64; the kernel timed alone beside its bound,
   the wrapper's calls back to back and the plain version; then counts its
   launches on 2 chained steps of both paths: 7 a step (3 assemblies, 3
   line searches, the trajectory's cost) and 1 more in the condensed
   `init_warmstart_batch`, no plain call.

Prints the card's name and power limit, one JSON line with every kernel's
numbers, and as its last line {"ok": true, "device": {...}}.  Exits with a
non-zero code and prints no result without a CUDA device, or when the
package is not beside it; any failed check fails the run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ft_mpc_torch.benchmarks.common import (
    H100_HBM_BYTES_PER_S,
    bench_x0,
    card_line,
    long_horizon_x0,
    read_counters,
    zero_counters,
)

REPO = Path(__file__).resolve().parent

# H100 SXM published peak (NVIDIA data sheet): fp32 outside the tensor
# cores; the HBM3 bandwidth is common's.  A card set below 700 W runs slower
# under load.
PEAK_FP32_FLOPS = 67e12

Q_DIAG = [1, 1, 1, 1, 1, 1, 2, 2, 2]  # DEFAULT_TUNING of the JAX package
R_DIAG = [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]
HORIZON = 15
BATCH = 2048
PERIOD_MS = 100.0  # the controller's 0.1 s control period
GAP_GATE = 0.4  # bench.py's max_term_gap gate
REFERENCE_GAP_ROWS = {209, 828, 1204, 1400, 1713}  # bench.py's pinned set

# Tolerances of each kernel against its plain version on the same inputs
# (both float32 on the card; they differ only in summation order):
#   condense: relative to max|S| -- a 15-step recursion of 13-term sums;
#   admm: relative to each output's scale -- 60 (or 600) iterations of a
#     map whose x-update multiplies by K^-1 (condition ~1e5) amplify the
#     per-iteration rounding difference (5.5e-5 seen at 600 iterations on
#     an H100, so 5e-4 leaves a 10x margin);
#   alloc: u atol 2e-3 N, the JAX suite's own class for its fp32 kernel
#     (tests/test_lanes_alloc.py:75-78), on seeded demands;
#   alloc on the main path's wrenches (see check_alloc_main): u atol 1e-2 N
#     on the rows where both took the same branches, and a branch choice may
#     differ only on rows that sit on the hull test's threshold or the
#     fallback threshold, on at most 1/16 of the rows.  On an H100 these read
#     2.8e-3 N and 44 of 2048 rows; the control, the plain version in float32
#     against itself in float64, reads 1.8e-3 N and 109 rows, so the kernel
#     sits as close to float64 as the plain float32 arithmetic does.
TOL_CONDENSE = 1e-5
TOL_ADMM = 5e-4
TOL_ALLOC = 2e-3
TOL_ALLOC_MAIN = 1e-2
MAX_FLIP_SHARE = 1 / 16
TOL_STEP_U = 2e-2  # whole step, card vs CPU: tests/test_lanes.py:174-178
#   riccati (both sweeps): relative to each output's scale, against the plain
#     float32 sweep on the same inputs -- a 240-stage recursion of 13-term
#     sums whose closed loop F_t contracts, so the summation-order difference
#     does not grow along the horizon; and TOL_RICCATI_F64 against the plain
#     sweep run in float64, which is the float32 rounding of the recursion
#     itself (the plain float32 sweep's own distance is printed beside it).
TOL_RICCATI = 1e-4
TOL_RICCATI_F64 = 1e-3

HULL_MARGIN = 1e-7  # the hull test: hull_A w_total <= hull_b + 1e-7
FALLBACK_EQ_ERR = 1e-2  # the fallback replaces u only above this equality error
U32 = 2.0 ** -24  # float32 unit roundoff
WARMUP = 10  # bench.py: warm-up steps, then timed steps, all chained
STEPS = 30  # cut from 120 so that the script fits its time limit

# The stagewise path: the largest point of benchmarks/envelope.py, with the
# configuration of benchmarks/long_horizon.py.
SW_HORIZON = 240
SW_BATCH = 512
SW_WARMUP = 3
SW_STEPS = 6  # depth cut so that the script fits its time limit (12 before)
SW_SMALL = (32, 60)  # (B, horizon) of the card-vs-CPU stagewise steps
SW_SMALL_STEPS = 2  # chained, so the carried warm start, duals and rho are held
# max_r_prim after the chained steps: the solver reaches 4.1e-3 on this bank
# (16 single and 15 double faults) in every run on an H100, and a solver that
# stops converging (a wrong rho rule, duals dropped between steps) reads far
# above; benchmarks/long_horizon.py reports the same number and gates nothing.
SW_R_PRIM_GATE = 1e-2
RICCATI_SMALL = 8  # the sweeps' batch in the long-horizon envelope's B=64 cleanup
# The closed loop (ft_mpc_torch/sim/env.py)
LOOP_STEPS = 20  # batched_rollout_lanes at B=BATCH; cut from 50 to fit the time limit
LOOP_SMALL = (32, 3)  # (B, steps) of the same-state card-vs-CPU closed loop
# launches per step on the condensed path: condensing once per SQP iteration
# and once in the cleanup; ADMM once per SQP iteration and once per cleanup
# phase; allocation once.  init_warmstart_batch condenses once more.
LOOP_LAUNCHES = {"condense_lanes": 3, "admm_lanes": 5, "allocate_thrusters_lanes": 1}
DEMO_STEPS = 300  # examples/sim.py: 30 s of hover at dt 0.1
DEMO_ERR_GATE = 0.1  # m, final orbit-centre position error of the demo
SCEN_BATCH = (128, 10)  # (B, steps) of batched_rollout (examples/sim.py --batch 128)
SCHEDULE = (15, 25)  # (switch step, steps), tests/test_mpc.py:188-212 (40 steps there)
SW_ROLLOUT = (60, 3)  # (horizon, steps) of the per-scenario stagewise rollout
# section 7: banks built by the port
PORT_WARMUP = 3
PORT_STEPS = 10
PORT_SMALL = (64, 32)  # rows of the card-vs-CPU step: census bank, randomized bank
TOL_BANK = 1e-12  # the port's bench rows against bench_bank32.npz (float64)
C2_HORIZONS = (20, 38, 40)  # the ADMM cluster design: 1, 2 and 2 blocks a scenario
C2_BATCH = 256
C2_STEPS = 2
# section 8: the user-facing API, the demo, the accuracy harness, the pipeline
PIPELINE_PATTERNS = (("healthy", ()), ("8_9", (8, 9)), ("12_13", (12, 13)))
TOL_PIPE = 1e-3  # P9, p9, c: rtol, atol TOL_PIPE max|P9| (tests/test_torch_pipeline.py)
THRESHOLD_BAND = 20.0  # a grid point decided otherwise has r_prim within 20x of 1e-4
API_STEPS = (10, 10)  # SimulationEnvironment steps before and after the runtime fault
DEMO_BATCH = 16
DEMO_DURATION = 1.5  # s of the --batch demo (the configuration's 30 s, cut to fit)
ACC_STEPS = 1  # the accuracy leg, cut from the harness's 120 to fit (about 30 s a step
#   on an H100: the float64 golden's 25 SQP iterations of 900 ADMM iterations); it
#   reaches none of the harness's gates (the first from step 20), so it holds
#   finiteness and the lanes leg's kernel launches; the 120 steps run separately
LANES_B1_STEPS = 3
# section 9: scenario sharding and the planar model family
SHARD_TOL = 1e-6  # N: a shard against get_control_batch on its own rows (same card)
SHARD_ROLLOUT = 5  # steps of sharded_rollout_lanes
LAUNCH_REPS = 4  # --reps of each launch run (10 before; cut to fit the time limit)
LAUNCH_TIMEOUT = 300  # s, each launch subprocess
TOL_PROCS = 1e-5  # 2 processes against 1: tests/test_distributed.py:164-171
PLANAR_PATTERNS = ((), (6,), (2,))
PLANAR_SMALL = 32  # rows of the planar card-vs-CPU step
PLANAR_LOOP = 15  # steps of the planar hover (per-scenario path)
# section 10: the condensed step with the reference's state box and rate rows
BOX_V = 0.5  # m/s on the three velocities: the reactive.yaml of tests/test_config_bounds.py
BOX_DU_MAX = (2.0, 2.0, 2.0, 1.0, 1.0, 1.0)
BOX_WARMUP = 3
BOX_STEPS = 10
BOX_SMALL = 64  # rows of the card-vs-CPU boxed step
BOX_STATES_NOTE = (
    "with the state box, a few of 64 rows end up to ~0.1 N apart between any two "
    "float32 runs of the step (card or CPU, kernels or their plain versions), each "
    "on a row where one of the step's thresholds went the other way: ADMM holds rho "
    "once a phase's r_prim <= 1e-4 and otherwise adapts it (by up to 5x in the "
    "cleanup), and the line search picks one of three step lengths; such rows are "
    "counted, as the allocation's branches are, and the others held to TOL_STEP_U")
# section 11: the bench entry and the measuring scripts (ft_mpc_torch/benchmarks)
BENCH_WINDOWS = 1  # 1 warm-up and 1 timed window of 10 chained steps (12 in the bench)
ENVELOPE_POINTS = ((240, "stagewise-lanes", 64), (15, "condensed", 512))
ENVELOPE_REPS = 2
SCAN_POINT = (15, 64)  # (Nt, B) of long_horizon.run's 'stagewise' (mode 'scan') backend
PROFILE_SWEEP = (4096,)  # (h) of profile_step, one repetition a component
BENCH_FIELDS = (
    "metric", "value", "unit", "batch", "per_step_latency_ms", "latency_p50_ms",
    "latency_p99_ms", "latency_windows", "max_r_prim", "max_term_gap", "n_restoration_gap",
    "gap_rows", "gap_patterns", "device", "card", "power_limit", "steps_per_window",
    "warmup_windows", "init_ms", "bank_build_s", "meets_control_period", "newton_rescues",
    "launches_per_step", "failed_gates",
)
# section 12: the sanitizer, the census cache build and the scaling sweeps
CENSUS_BUILD = ((), (0,), (8, 9), (12, 13))  # 12b: default orbit twice, searched, fallback
CENSUS_BUILD_COUNTS = (2, 1, 1)  # certified at the default orbit, at a searched one, not
UNCERTIFIED = [[12, 13], [12, 15], [13, 14], [14, 15]]  # the committed entries' fallbacks
SWEEP_BATCHES = (512, 2048)  # 12c: the batch sweep's points
SWEEP_WINDOWS = 1  # timed windows of the bench at each point (12 in the bench)
SWEEP_REPS = 2  # chained steps of each mesh of the device sweep (5 in the script)
# section 13: pareto, the three diagnostics, the ablation and the single-scenario entry
PARETO_POINTS = ((2, 60, 1, 3, 0, 0), (2, 60, 1, 3, 600, 256))
PARETO_ROUNDS = 2
CLEANUP_RUN = (60, 300, 512, 1)  # diag_cleanup's (admm iters, cleanup iters, K, phases)
DIAG_STEPS = 3
RESIDUAL_PAIR = (("lanes", 2, 160, 2, 3, 50.0, 1.5), ("condensed", 2, 160, 2, 3, 50.0, 1.5))
RESIDUAL_BATCH = 128
STAGEWISE_STEPS = 2
ABLATE_VARIANTS = ("full (3 sqp, admm 25x2)", "sqp=1")
ABLATE_REPS = 2
# section 14: the linearization kernel
LIN_SHAPES = ((BATCH, HORIZON), (SW_BATCH, SW_HORIZON), (64, SW_HORIZON))
LIN_STEPS = 2  # chained steps of each path whose linearizations are counted
# forward mode's flops a stage, counted from csrc/linearize.cu (an FMA two):
# the primal once and each of the 19 tangents
LIN_PRIMAL_FLOPS = 928
LIN_TANGENT_FLOPS = 1384
# kernel against vmap(jacfwd), relative to the scale of A, of B and of the
# states (`lin_gap`): float32, the same few hundred roundings of 6e-8 in
# another order and with fused multiply-adds; float64, the same at 1.1e-16
TOL_LINEARIZE = 1e-5
TOL_LINEARIZE_F64 = 1e-12
# section 15: the terminal kernel
TERM_BATCHES = ((BATCH, 0), (137, 0), (SW_BATCH, SW_HORIZON))  # (B, stagewise horizon)
TERM_STEPS = 2  # chained steps of each path whose terminal launches are counted
# operations a row, about, counted from csrc/terminal.cu (an FMA two, a pow,
# acos or cos one): the part without the tables' terms, and each K1 and K2
# term; V alone, and V with the gradient and the shifted Hessian
TERM_FLOPS = {False: (222, 4, 8), True: (561, 46, 64)}
# kernel against the plain version (tests/test_torch_cuda.py): relative to
# each output's scale; the omega diagonal against float64
TOL_TERMINAL_F32 = 1e-6
TOL_TERMINAL_SHIFT_F32 = 5e-5
TOL_TERMINAL_F64 = 1e-12
CONDENSED_KERNELS = ("condense_lanes", "admm_lanes", "allocate_thrusters_lanes")
STAGEWISE_KERNELS = ("riccati_bwd_lanes", "riccati_fwd_lanes", "riccati_prepare_lanes",
                     "allocate_thrusters_lanes")


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class Ctx:
    """Everything the main path needs, on one device and dtype."""

    def __init__(self, device, dtype, B: int, x0=None, stagewise_horizon: int = 0,
                 bank=None, params=None, horizon: int = 0, mass: float = 16.8,
                 box: bool = False):
        """`bank` (tiled over its rows to B; default the 32-pattern snapshot)
        and `params` (default BodyParams.default) give another bank and
        plant, `mass` the nominal mass of its reference inputs; `horizon`
        another horizon of the condensed configuration; `box` the weights of
        `box_weights` (the state box and rate rows)."""
        from ft_mpc_torch.controllers import spiraling as sp
        from ft_mpc_torch.geometry.scenario import load_bank_snapshot, take_rows, tile_bank
        from ft_mpc_torch.ops.dynamics import BodyParams
        from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
        from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig
        from ft_mpc_torch.utils.trajectory import (
            generate_trajectory,
            prepare_center_trajectory,
        )

        self.sp, self.device = sp, device
        if bank is None:
            bank = load_bank_snapshot(device=device, dtype=dtype)
        bank = tree_to(bank, device, dtype)
        bank = tile_bank(bank, -(-B // len(bank.r)))
        self.bank = take_rows(bank, torch.arange(B, device=device))
        self.params = (BodyParams.default(0.1, dtype=dtype, device=device) if params is None
                       else tree_to(params, device, dtype))
        self.weights = (box_weights(device, dtype) if box else
                        sp.MPCWeights.from_diagonals(Q_DIAG, R_DIAG, dtype=dtype,
                                                     device=device))
        if stagewise_horizon:
            # benchmarks/long_horizon.py:73-101
            Nt = stagewise_horizon
            self.cfg = sp.MPCConfig(
                horizon=Nt, sqp_iters=2, qp_backend="stagewise",
                stagewise=StagewiseConfig(iters=60, phases=1, rho=50.0,
                                          adapt_clip=1.5, mode="lanes"),
                newton_iters=3, cleanup_iters=300, cleanup_k=max(1, B // 8),
                cleanup_phases=2,
            )
            traj = generate_trajectory("hover", 0.1, max(30, (Nt + 2) * 0.1))
            default_x0 = long_horizon_x0
        else:
            # bench.py's deployed config
            Nt = horizon or HORIZON
            self.cfg = sp.MPCConfig(
                horizon=Nt, sqp_iters=2,
                admm=StructuredADMMConfig(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
                newton_iters=3, cleanup_iters=600, cleanup_k=256, cleanup_phases=3,
            )
            traj = generate_trajectory("hover", 0.1, max(5, (Nt + 2) * 0.1))
            default_x0 = bench_x0
        x_ref, u_ref = prepare_center_trajectory(
            traj, np.array([0.0, 0.0, 0.6]), mass, 0.1, Nt + 1
        )
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.x_ref, self.u_ref = t(x_ref[: Nt + 1]), t(u_ref[: Nt + 1])
        self.x_ref_full, self.u_ref_full = t(x_ref), t(u_ref)  # for closed loops
        self.x0 = t(default_x0(B) if x0 is None else x0)

    def init(self):
        c0 = self.sp.robot_to_center(self.bank.r, self.x0)
        return self.sp.init_warmstart_batch(self.params, self.bank, self.weights,
                                            self.cfg, c0, self.x_ref, self.u_ref)

    def step(self, warm):
        return self.sp.get_control_batch(self.params, self.bank, self.weights, self.cfg,
                                         self.x0, self.x_ref, self.u_ref, warm)


def box_weights(device, dtype=torch.float32):
    """The weights of tests/test_config_bounds.py's reactive.yaml: Q, R of
    DEFAULT_TUNING, xub 1e8 but BOX_V on the three velocities, xlb = -xub,
    du_max BOX_DU_MAX.  At Nt=15 they add 2*13*14 box and 2*6*14 rate rows to
    the 64 terminal rows: T=596."""
    from ft_mpc_torch.controllers import spiraling as sp

    x_ub = np.full(13, 1e8)
    x_ub[3:6] = BOX_V
    return sp.MPCWeights.from_diagonals(Q_DIAG, R_DIAG, x_lb=-x_ub, x_ub=x_ub,
                                        du_max=BOX_DU_MAX, dtype=dtype, device=device)


def box_excess(X) -> float:
    """The largest planned stage velocity beyond the box: max over rows of
    max(0, |v| - BOX_V) on stages 1..Nt-1 (stage 0 is the measured state)."""
    return float(torch.clamp(X[:, 1:-1, 3:6].abs() - BOX_V, min=0).max())


def tree_to(tree, device, dtype):
    """A NamedTuple of tensors on `device`; float leaves cast to `dtype`."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.to(device, dtype) if x.is_floating_point()
                    else x.to(device), tree)


def gentle_x0(B: int) -> np.ndarray:
    """States near the certified terminal sets (tests/test_lanes.py:139-149),
    where the JAX suite compares its whole step across implementations."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.15, 0.15, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-0.15, 0.15, (B, 3))
    return x0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device, rounds: int = 3, device_only: bool = False) -> float:
    """ms per call: the median over `rounds` of `reps` back-to-back calls
    between two CUDA events (host clock on the CPU), after one warm-up.

    `device_only`: the device first spins for twice the host's time to
    enqueue the calls, so every call is queued before the first event and
    the events time the kernels alone, not a host that launches slower than
    they run (a wrapper's checks and allocations take tens of us)."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    sync(device)
    times = []
    for _ in range(rounds):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if device_only:
                # cycles at an upper bound of 2 GHz: the spin lasts at least as long
                torch.cuda._sleep(int(2e9 * max(2 * reps * host_s, 1e-3)))
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / reps)
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_kernels() -> float:
    from ft_mpc_torch import kernels

    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name in kernels.SOURCES:
        log_text = logs.get(name)
        if log_text is None:
            log_text = kernels.lib_path(name).with_suffix(".log").read_text()
        usage = [ln.strip() for ln in log_text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"ptxas {name}: " + " | ".join(usage))
    return build_s


def drive_main_path(ctx: Ctx, warmup: int = WARMUP, steps: int = STEPS):
    """init + warmup + steps chained steps; launch counts zeroed before, read
    after."""
    from ft_mpc_torch.solvers.lanes_qp import admm_lanes, newton_kinv
    from ft_mpc_torch.solvers.lanes_riccati import riccati_split_lanes

    zero_counters()
    t0 = time.perf_counter()
    warm = ctx.init()
    sync(ctx.device)
    init_ms = 1e3 * (time.perf_counter() - t0)
    out = None
    for _ in range(warmup):
        out = ctx.step(warm)
        warm = out.warm
    sync(ctx.device)
    samples = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = ctx.step(warm)
        sync(ctx.device)
        samples.append(1e3 * (time.perf_counter() - t0))
        warm = out.warm
    launches = read_counters()
    by_design = dict(admm_lanes.launches_by_design)
    riccati_by_design = dict(riccati_split_lanes.launches_by_design)
    rescues = newton_kinv.rescues
    samples = np.asarray(samples)
    windows = samples[: len(samples) // 10 * 10].reshape(-1, 10).mean(axis=1)

    u = out.u_phys
    gaps = out.info.term_gap.double().cpu().numpy()
    gap_rows = sorted(int(r) for r in np.flatnonzero(gaps > 1e-3))
    res = {
        "init_ms": init_ms,
        "p50_ms": float(np.percentile(samples, 50)),
        "p99_ms": float(np.percentile(samples, 99)),
        "window_p50_ms": float(np.percentile(windows, 50)) if len(windows) else None,
        "steps": warmup + steps,
        "launches": launches,
        "launches_per_step": {k: v / (warmup + steps) for k, v in launches.items()},
        "admm_launches_by_design": by_design,
        "riccati_launches_by_design": riccati_by_design,
        "newton_rescues": rescues,
        "slowest_steps_ms": {int(i): float(samples[i])
                             for i in np.argsort(samples)[::-1][:5]},
        "max_r_prim": float(out.info.r_prim.max()),
        "max_term_gap": float(np.nanmax(gaps)),
        "gap_rows": gap_rows,
        "finite": bool(torch.isfinite(u).all() and torch.isfinite(out.wrench).all()
                       and torch.isfinite(out.warm.X).all()),
        "u_shape": tuple(u.shape),
    }
    res["solves_per_s"] = len(ctx.bank.r) * 1e3 / res["p50_ms"]
    return res, warm, out


def check_condense(ctx: Ctx, warm) -> dict:
    """Kernel 1 at the main path's shapes: stage jacobians of the final warm."""
    from ft_mpc_torch.solvers.lanes_condense import _condense_cuda, condense_plain

    sp = ctx.sp
    X = torch.cat([sp.robot_to_center(ctx.bank.r, ctx.x0)[:, None], warm.X[:, 1:]], dim=1)
    A, Bm, d = sp._linearize(ctx.params, ctx.bank, ctx.cfg, X, warm.U, ctx.u_ref)
    A, Bm, d = (t.float().contiguous() for t in (A, Bm, d))
    S, phi = _condense_cuda(A, Bm, d)
    S0, phi0 = condense_plain(A, Bm, d)
    sync(ctx.device)
    scale = max(1.0, float(S0.abs().max()), float(phi0.abs().max()))
    err = max(float((S - S0).abs().max()), float((phi - phi0).abs().max()))
    B, Nt = A.shape[:2]
    n = 6 * Nt
    # recursion as computed: 13x13 @ 13xn per stage for S, 13x13 for phi
    flops = B * Nt * (2 * 13 * 13 * n + 2 * 13 * 13 + 13 + 13 * 6)
    b_ms, b_by = bound_ms(nbytes(A, Bm, d, S, phi), flops)
    return {
        "name": "condense_lanes", "route": "cuda",
        "source": "ft_mpc_torch/csrc/condense.cu",
        "replaces": "ft_mpc_tpu/solvers/lanes_condense.py:38",
        "max_abs_err": err, "tol": TOL_CONDENSE * scale,
        "ms": time_ms(lambda: _condense_cuda(A, Bm, d), 20, ctx.device, device_only=True),
        "plain_ms": time_ms(lambda: condense_plain(A, Bm, d), 3, ctx.device),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"B={B} Nt={Nt}",
    }


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, the same over the reference's scale) over tensor pairs."""
    err = rel = 0.0
    for g, r in zip(got, ref):
        e = float((g.double() - r.double()).abs().max())
        err, rel = max(err, e), max(rel, e / max(1.0, float(r.abs().max())))
    return err, rel


def admm_inputs(ctx: Ctx, warm, weights, rows=None):
    """The QP of the final warm (as the main path assembles it) and its exact
    inverse metric, float32, optionally restricted to `rows`."""
    from ft_mpc_torch.solvers.lanes_qp import build_K, exact_kinv

    sp = ctx.sp
    bank = ctx.bank if rows is None else sp.take_rows(ctx.bank, rows)
    sel = (lambda t: t) if rows is None else (lambda t: t[rows])
    x_ref = sp._per_scenario_ref(bank, ctx.x_ref, len(bank.r))
    geo = sp._masked_geometry(bank)
    c0 = sp.robot_to_center(bank.r, sel(ctx.x0))
    X = torch.cat([c0[:, None], sel(warm.X)[:, 1:]], dim=1)
    U = sel(warm.U)
    qp, _, _, _ = sp._assemble_condensed_batch(ctx.params, bank, weights, ctx.cfg, X, U,
                                               x_ref, ctx.u_ref, *geo)
    yt = sel(warm.y_term)
    if yt.shape != qp.h_term.shape:  # extra dense rows start from zero duals
        yt = torch.zeros_like(qp.h_term)
    rho = sel(warm.rho).float()
    K, _ = build_K(qp, rho, ctx.cfg.admm.sigma)
    kinv = exact_kinv(K)
    f = lambda t: t.float().contiguous()
    zh0 = f(torch.clamp(qp.h_hull, max=0.0))
    zt0 = f(torch.clamp(qp.h_term, max=0.0))
    x0 = torch.zeros_like(f(qp.g))
    return [f(kinv), f(qp.hull_A), f(qp.h_hull), f(qp.G_term), f(qp.h_term), f(qp.g),
            x0, zh0, zt0, f(sel(warm.y_hull)), f(yt), f(rho)]


def admm_flops(B, Nt, F, T, iters) -> float:
    n = 6 * Nt
    per_iter = (2 * n * F + 2 * n * T + 2 * n * n  # rhs, K^-1 matvec
                + 2 * Nt * F * 6 + 2 * T * n        # hull and dense rows of x~
                + 12 * (Nt * F + T) + 6 * n)        # projections, duals, relaxation
    return float(B) * iters * per_iter


def check_admm(ctx: Ctx, args, iters, label, reps=10) -> dict:
    from ft_mpc_torch.solvers.lanes_qp import _admm_cuda, admm_plain

    c = ctx.cfg.admm
    run = lambda: _admm_cuda(*args, c.sigma, c.alpha, iters, c.elastic_y_max)
    plain = lambda: admm_plain(*args, c.sigma, c.alpha, iters, c.elastic_y_max)
    out, ref = run(), plain()
    sync(ctx.device)
    err, rel = rel_err(out, ref)  # x, zh, zt, yh, yt, each against its own scale
    B, Nt, F = args[2].shape
    T = args[4].shape[1]
    b_ms, b_by = bound_ms(nbytes(*args, *out), admm_flops(B, Nt, F, T, iters))
    ms = time_ms(run, reps, ctx.device, device_only=True)
    return {
        "name": "admm_lanes", "route": "cuda", "source": "ft_mpc_torch/csrc/admm.cu",
        "replaces": "ft_mpc_tpu/solvers/lanes_qp.py:181",
        "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_ADMM,
        "ms": ms, "us_per_iter": 1e3 * ms / iters,
        "plain_ms": time_ms(plain, 1, ctx.device),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{label}: B={B} Nt={Nt} F={F} T={T} iters={iters}",
    }


def alloc_flops(B, F, fista, admm) -> float:
    per = (12 * F                       # hull test
           + fista * (4 * 96 + 6 * 16)  # FISTA: G eta, G^T r, clip and momentum
           + 2 * 6 * 6 * 16 * 3 + 2 * 700  # two capacitance matrices, two 6x6 GJ
           + admm * (4 * 192 + 72 + 12 * 16 + 6 * 6)  # ADMM Woodbury steps
           + 3 * 192 + 72)              # polish and residuals
    return float(B) * per


ALLOC_HYPER = (60, 40, 1.0, 1e3, 1e-6, 1.6)  # allocate_thrusters_lanes defaults


def alloc_args(ctx: Ctx, demand) -> list:
    """The allocation kernel's float32 inputs on the main path's bank rows,
    as `allocate_thrusters_lanes` prepares them, for wrench commands `demand`."""
    from ft_mpc_torch.solvers.lanes_alloc import _BIG

    b, p = ctx.bank, ctx.params
    f = lambda t: torch.as_tensor(t, device=ctx.device).float().contiguous()
    hb = torch.where(b.hull_mask > 0.5, b.hull_b, _BIG)
    return [f(p.D), f(demand), f(b.faulty_force_gen), f(b.u_ub),
            f(b.hull_A * b.hull_mask[:, :, None]), f(hb), f(b.gen_G), f(b.gen_c),
            f(1.0 / torch.clamp(b.gen_L.float(), min=1e-12)),
            f(p.max_thrust.float().expand(len(hb)))]


def hull_slack(hA, hb, w, ff):
    """The allocation's hull test in float64 on its float32 inputs.

    Per facet: the slack hull_A (w + ff) - hull_b - margin (> 0 fails the
    test), and a bound on the error of any float32 evaluation of it -- w + ff
    rounded, a 6-term dot product, hull_b + margin rounded: 8 unit roundoffs
    of the terms' magnitudes.
    """
    hA, hb = hA.double(), hb.double()
    wt = w.double() + ff.double()
    slack = torch.einsum("bfi,bi->bf", hA, wt) - hb - HULL_MARGIN
    band = 8 * U32 * (torch.einsum("bfi,bi->bf", hA.abs(), wt.abs()) + hb.abs())
    return slack, band


def hull_truth(hA, hb, w, ff):
    """Per row: whether the exact hull test clips, and whether the row sits on
    its threshold (a float32 evaluation may then decide either way)."""
    slack, band = hull_slack(hA, hb, w, ff)
    surely_out = (slack > band).any(dim=1)
    surely_in = (slack < -band).all(dim=1)
    return (slack > 0).any(dim=1), ~(surely_out | surely_in)


def facet_demands(hA, hb, G, c, ff, rng) -> torch.Tensor:
    """Wrench commands (float64) whose hull test lies two error bounds inside
    (even rows) or outside (odd rows) the margin: on a random ray from the
    centre of the attainable zonotope, at the first facet the ray crosses."""
    hA, hb, G, c, ff = (t.double() for t in (hA, hb, G, c, ff))
    B = hb.shape[0]
    centre = c + 0.5 * G.sum(dim=-1)
    s0 = torch.einsum("bfi,bi->bf", hA, centre) - hb - HULL_MARGIN
    if not bool((s0 < 0).all()):
        raise ValueError("facet_demands: a zonotope centre fails its own hull test")
    ray = torch.as_tensor(rng.standard_normal((B, 6)), dtype=torch.float64,
                          device=hb.device)
    rate = torch.einsum("bfi,bi->bf", hA, ray)
    t_hit, facet = torch.where(rate > 0, -s0 / rate, torch.inf).min(dim=1)
    on = centre + t_hit[:, None] * ray
    _, band = hull_slack(hA, hb, on - ff, ff)
    rows = torch.arange(B, device=hb.device)
    side = torch.where(rows % 2 == 0, -1.0, 1.0).double()
    t = t_hit + side * 2.0 * band[rows, facet] / rate[rows, facet]
    return centre + t[:, None] * ray - ff


def check_alloc(ctx: Ctx) -> dict:
    """Kernel 3 on the main path's bank rows (B=2048, F=32) with seeded wrench
    demands of +-0.5: about a quarter are clipped, a few take the fallback.
    Both branch choices (hull test, fallback) must be equal, u within
    TOL_ALLOC.  These demands stay clear of every branch threshold."""
    from ft_mpc_torch.solvers.lanes_alloc import _alloc_cuda, alloc_plain

    rng = np.random.default_rng(1)
    B = len(ctx.bank.r)
    args = alloc_args(ctx, rng.uniform(-0.5, 0.5, (B, 6)))
    got, ref = _alloc_cuda(*args, *ALLOC_HYPER), alloc_plain(*args, *ALLOC_HYPER)
    sync(ctx.device)
    return {**alloc_timing(ctx, args, got, "B={B} F={F}"),
            "max_abs_err": float((got[0] - ref[0]).abs().max()), "tol": TOL_ALLOC,
            "branches_equal": bool(torch.equal(got[2][:, :2], ref[2][:, :2]))}


def alloc_timing(ctx: Ctx, args, got, shape: str) -> dict:
    """Kernel 3's row: its time and its plain version's on `args`, beside
    the bound; `shape` is formatted with B and F."""
    from ft_mpc_torch.solvers.lanes_alloc import _alloc_cuda, alloc_plain

    B, F = args[5].shape
    fista, admm = ALLOC_HYPER[:2]
    b_ms, b_by = bound_ms(nbytes(*args, *got), alloc_flops(B, F, fista, admm))
    ms = time_ms(lambda: _alloc_cuda(*args, *ALLOC_HYPER), 20, ctx.device, device_only=True)
    return {
        "name": "allocate_thrusters_lanes", "route": "cuda",
        "source": "ft_mpc_torch/csrc/alloc.cu",
        "replaces": "ft_mpc_tpu/solvers/lanes_alloc.py:67",
        "ms": ms, "us_per_iter": 1e3 * ms / (fista + admm),
        "plain_ms": time_ms(lambda: alloc_plain(*args, *ALLOC_HYPER), 1, ctx.device),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": shape.format(B=B, F=F),
    }


def check_alloc_facets(ctx: Ctx) -> dict:
    """Kernel 3's hull test at its threshold: demands 2 error bounds either
    side of the margin on every row (facet_demands).  The kernel must give
    the exact answer on every row that is not on the threshold."""
    from ft_mpc_torch.solvers.lanes_alloc import _alloc_cuda, alloc_plain

    B = len(ctx.bank.r)
    D, _, ff, u_ub, hA, hb, G, c, step, mt = alloc_args(ctx, torch.zeros(B, 6))
    w = facet_demands(hA, hb, G, c, ff, np.random.default_rng(2)).float()
    args = [D, w, ff, u_ub, hA, hb, G, c, step, mt]
    got, ref = _alloc_cuda(*args, *ALLOC_HYPER), alloc_plain(*args, *ALLOC_HYPER)
    clipped, on_thr = hull_truth(hA, hb, w, ff)
    _, band = hull_slack(hA, hb, w, ff)
    wrong = lambda r: int((((r[2][:, 0] > 0.5) != clipped) & ~on_thr).sum())
    return {"rows": B, "decisive": int((~on_thr).sum()), "clipped": int(clipped.sum()),
            "wrong_kernel": wrong(got), "wrong_plain": wrong(ref),
            "band_median": float(band[hb < 1e7].median()),
            "band_max": float(band[hb < 1e7].max())}


def check_alloc_main(ctx: Ctx, out) -> dict:
    """Kernel 3 against its plain version on the main path's own wrenches,
    with the plain version in float64 as the control for float32 rounding.

    The MPC drives its wrenches onto hull facets, where the hull test is
    decided by rounding, and clipped rows take the 60-step FISTA projection
    instead of the wrench.  So a branch choice may differ, but only on a row
    that sits on a threshold: the hull test within its error bound
    (hull_slack), or the fallback where the side that kept its u has an
    equality error above half the fallback threshold.
    """
    from ft_mpc_torch.solvers.lanes_alloc import _alloc_cuda, alloc_plain

    args = alloc_args(ctx, out.wrench)
    got = _alloc_cuda(*args, *ALLOC_HYPER)
    ref = alloc_plain(*args, *ALLOC_HYPER)
    ref64 = alloc_plain(*(a.double() for a in args), *ALLOC_HYPER)
    branch = lambda r: r[2][:, :2] > 0.5

    def compare(a, b):
        same = (branch(a) == branch(b)).all(dim=1)
        du = (a[0].double() - b[0].double()).abs().max(dim=1).values
        return same, (float(du[same].max()) if bool(same.any()) else 0.0)

    same, err = compare(got, ref)
    same_c, err_c = compare(ref, ref64)
    same_k, err_k = compare(got, ref64)
    _, on_thr = hull_truth(*args[4:6], args[1], args[2])
    bk, bp = branch(got), branch(ref)
    hull_flip = bk[:, 0] != bp[:, 0]
    fb_flip = ~hull_flip & (bk[:, 1] != bp[:, 1])
    # the side that kept its u reports its equality error in flags[:, 2]
    kept_eq = torch.where(bk[:, 1], ref[2][:, 2], got[2][:, 2])
    B = len(args[1])
    return {
        "rows": B,
        "branch_rows": int((~same).sum()),
        "hull_flips": int(hull_flip.sum()),
        "hull_flips_off_threshold": int((hull_flip & ~on_thr).sum()),
        "rows_on_hull_threshold": int(on_thr.sum()),
        "fallback_flips": int(fb_flip.sum()),
        "fallback_flips_kept_eq_err": sorted(float(e) for e in kept_eq[fb_flip]),
        "u_err": err,
        "control_branch_rows": int((~same_c).sum()), "control_u_err": err_c,
        "kernel_vs_f64_branch_rows": int((~same_k).sum()), "kernel_vs_f64_u_err": err_k,
    }


def hold_alloc_main(c: Ctx, c_out, path: str, check) -> dict:
    """Kernel 3 on a path's own wrenches, with the gates of the C1 rule;
    returns the comparison."""
    am = check_alloc_main(c, c_out)
    log(f"alloc on the {path} path's wrenches (B={am['rows']}; control: plain "
        "float32 vs plain float64): " + json.dumps(am))
    check(am["u_err"] <= TOL_ALLOC_MAIN,
          f"allocation kernel: max |du| {am['u_err']} > {TOL_ALLOC_MAIN} on the "
          f"{path} path's rows with equal branches")
    check(am["branch_rows"] <= MAX_FLIP_SHARE * am["rows"],
          f"allocation kernel, {path} path: branches differ on {am['branch_rows']} "
          f"of {am['rows']} rows")
    check(am["hull_flips_off_threshold"] == 0,
          f"allocation kernel, {path} path: the hull test differs on a row off its "
          "threshold")
    check(all(e > FALLBACK_EQ_ERR / 2 for e in am["fallback_flips_kept_eq_err"]),
          f"allocation kernel, {path} path: the fallback choice differs on a row "
          "far from its threshold")
    return am


def time_alloc_main(ctx: Ctx, out, label: str) -> dict:
    """Kernel 3 timed on a path's own wrenches (its batch and bank rows)."""
    from ft_mpc_torch.solvers.lanes_alloc import _alloc_cuda

    args = alloc_args(ctx, out.wrench)
    got = _alloc_cuda(*args, *ALLOC_HYPER)
    sync(ctx.device)
    return alloc_timing(ctx, args, got, label + ": B={B} F={F}, the path's own wrenches")


def with_share(row: dict) -> dict:
    """The row with its share of the bound (bound_ms / ms) beside ms."""
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def capture_riccati(ctx: Ctx, warm) -> dict:
    """One more stagewise step with the solver's `lqr_resolve_lanes` wrapped,
    keeping the arguments of the last call at each batch size:
    {B: (fact, q, r, qN, x0)}, the path's own factorization (float32, as
    its phase's `prepare_resolve` holds it) and linear terms, late in an
    ADMM run.  Runs after the counted window; the solver's reference is put
    back."""
    from ft_mpc_torch.solvers import mpc_qp_stagewise as sw
    from ft_mpc_torch.solvers.lanes_riccati import RiccatiPrep

    seen = {}
    real = sw.lqr_resolve_lanes

    def recording(fact, *lin):
        f = fact.fact if isinstance(fact, RiccatiPrep) else fact
        seen[f.F.shape[0]] = (f, *lin)
        return real(fact, *lin)

    sw.lqr_resolve_lanes = recording
    try:
        ctx.step(warm)
        sync(ctx.device)
    finally:
        sw.lqr_resolve_lanes = real
    return seen


# per scenario-stage: flops of the recursions as written
RICCATI_BWD_FLOPS = 13 + 2 * 78 + 6 + 2 * 36 + 2 * 169 + 2 * 78 + 2 * 13
RICCATI_FWD_FLOPS = 2 * 78 + 6 + 2 * 78 + 2 * 169 + 2 * 13
# the preparation: F'PC and B'PC, and a chunk's product a stage (C > 1)
RICCATI_PREP_FLOPS = 2 * 169 + 2 * 78
RICCATI_PSI_FLOPS = 2 * 13 ** 3


def riccati_bounds(F, Bm, c, K, Qi, PC, q, r, qN, x0) -> dict:
    """(bound ms, bound by) of the backward sweep, the forward sweep and the
    pair: each input read once, each output written once."""
    B, Nt = F.shape[:2]
    ks_b = 4 * B * Nt * 6
    xu_b = 4 * (B * (Nt + 1) * 13 + B * Nt * 6)
    return {
        "bwd": bound_ms(nbytes(F, Bm, K, Qi, PC, q, r, qN) + ks_b, float(B) * Nt * RICCATI_BWD_FLOPS),
        "fwd": bound_ms(nbytes(F, Bm, c, K, x0) + ks_b + xu_b, float(B) * Nt * RICCATI_FWD_FLOPS),
        "pair": bound_ms(nbytes(F, Bm, c, K, Qi, PC, q, r, qN, x0) + xu_b,
                         float(B) * Nt * (RICCATI_BWD_FLOPS + RICCATI_FWD_FLOPS)),
    }


def check_riccati(ctx: Ctx, fact, q, r, qN, x0, label: str, reps: int = 20) -> list[dict]:
    """Kernels 4 and 5 at the plan `riccati_plan` gives this shape: the
    backward and forward sweeps alone, each against its plain half on the
    same inputs, the pair through `lqr_resolve_lanes` against
    `lqr_resolve`, all against the plain sweeps in float64; also with a
    seeded non-zero qN and x0 (the path passes x0 = 0).  The preparation
    against its plain version.  Each row carries the pair's time (what a
    re-solve costs) beside its sweep's."""
    from ft_mpc_torch.solvers.lanes_riccati import (
        lqr_resolve_lanes,
        prepared,
        riccati_plan,
        riccati_prepare_lanes,
        riccati_prepare_plain,
        riccati_split_lanes,
    )
    from ft_mpc_torch.solvers.riccati import (
        LQRFactorization,
        lqr_resolve,
        resolve_bwd_plain,
        resolve_fwd_plain,
    )

    f32 = lambda t: t.float().contiguous()  # as prepare_resolve hands them on
    f = LQRFactorization(*(f32(t) for t in fact))
    F, Bm, c, K, Qi, PC = f.F, f.B, f.c, f.K, f.Quu_inv, f.PC
    q, r, qN, x0 = (f32(t) for t in (q, r, qN, x0))
    B, Nt = F.shape[:2]
    plan = riccati_plan(B, Nt)
    prep = prepared(f, plan["chunk"])
    rec_p, psi_p = riccati_prepare_plain(f, plan["chunk"])
    rec_err = rel_err([prep.rec] + ([] if prep.psi is None else [prep.psi]),
                      [rec_p] + ([] if psi_p is None else [psi_p]))
    bwd_k = lambda qN_i, x0_i: riccati_split_lanes(prep, q, r, qN_i, x0_i, parts=1)
    fwd_k = lambda ks, qN_i, x0_i: riccati_split_lanes(prep, q, r, qN_i, x0_i, parts=2, ks=ks)
    rng = np.random.default_rng(3)
    rnd = lambda t: torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype,
                                    device=t.device)
    dbl = lambda ts: [t.double() for t in ts]
    res = {"bwd": [0.0, 0.0, 0.0, 0.0], "fwd": [0.0, 0.0, 0.0, 0.0]}

    def hold(key, got, ref, ref64):
        e, rel = rel_err(got, ref)
        _, rel64 = rel_err(got, ref64)
        _, plain64 = rel_err(ref, ref64)
        res[key] = [max(a, b) for a, b in zip(res[key], (e, rel, rel64, plain64))]

    for qN_i, x0_i in ((qN, x0), (rnd(qN), rnd(x0))):
        b_in = (F, Bm, K, Qi, PC, q, r, qN_i)
        ks_p = resolve_bwd_plain(*b_in)
        hold("bwd", [bwd_k(qN_i, x0_i)], [ks_p], [resolve_bwd_plain(*dbl(b_in))])
        f_in = (F, Bm, c, K, ks_p, x0_i)
        hold("fwd", fwd_k(ks_p, qN_i, x0_i), resolve_fwd_plain(*f_in),
             resolve_fwd_plain(*dbl(f_in)))
    # the pair, through the wrapper, against the plain re-solve
    pair = rel_err(lqr_resolve_lanes(prep, q, r, qN, x0), lqr_resolve(f, q, r, qN, x0))
    sync(ctx.device)

    ks_p = resolve_bwd_plain(F, Bm, K, Qi, PC, q, r, qN)
    times = {"bwd": time_ms(lambda: bwd_k(qN, x0), reps, ctx.device, device_only=True),
             "fwd": time_ms(lambda: fwd_k(ks_p, qN, x0), reps, ctx.device, device_only=True),
             "pair": time_ms(lambda: riccati_split_lanes(prep, q, r, qN, x0), reps, ctx.device,
                             device_only=True)}
    bounds = riccati_bounds(F, Bm, c, K, Qi, PC, q, r, qN, x0)
    plains = {"bwd": time_ms(lambda: resolve_bwd_plain(F, Bm, K, Qi, PC, q, r, qN), 1, ctx.device),
              "fwd": time_ms(lambda: resolve_fwd_plain(F, Bm, c, K, ks_p, x0), 1, ctx.device)}
    shape = f"{label}: B={B} Nt={Nt}"
    rows = []
    for key, name, line in (("bwd", "riccati_bwd_lanes", 46), ("fwd", "riccati_fwd_lanes", 64)):
        e, rel, rel64, plain64 = res[key]
        rows.append({
            "name": name, "route": "cuda", "source": "ft_mpc_torch/csrc/riccati.cu",
            "replaces": f"ft_mpc_tpu/solvers/lanes_riccati.py:{line}",
            "max_abs_err": e, "max_rel_err": rel, "tol_rel": TOL_RICCATI,
            "rel_err_vs_f64": rel64, "plain_rel_err_vs_f64": plain64,
            "tol_rel_f64": TOL_RICCATI_F64, "pair_rel_err": pair[1],
            "design": plan["design"], "plan": plan,
            "ms": times[key], "plain_ms": plains[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None,
            "pair_ms": times["pair"], "pair_bound_ms": bounds["pair"][0],
            "shape": shape,
        })
    C = plan["chunks"]
    n_b = nbytes(F, Bm, K, Qi, PC, c) + nbytes(prep.rec) + (
        0 if prep.psi is None else nbytes(prep.psi))
    flops = float(B) * Nt * (RICCATI_PREP_FLOPS + (RICCATI_PSI_FLOPS if C > 1 else 0))
    b_ms, b_by = bound_ms(n_b, flops)
    rows.append({
        "name": "riccati_prepare_lanes", "route": "cuda",
        "source": "ft_mpc_torch/csrc/riccati.cu",
        "replaces": "ft_mpc_tpu/solvers/lanes_riccati.py:46",
        "note": "the per-phase part of kernels 4 and 5 (no TPU counterpart: the "
                "Pallas sweeps read the factorization as it is)",
        "max_abs_err": rec_err[0], "max_rel_err": rec_err[1], "tol_rel": TOL_RICCATI,
        "design": plan["design"], "plan": plan,
        "ms": time_ms(lambda: riccati_prepare_lanes(f, plan["chunk"]), reps, ctx.device,
                      device_only=True),
        "plain_ms": time_ms(lambda: riccati_prepare_plain(f, plan["chunk"]), 1, ctx.device),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": shape,
    })
    return rows


class PlainKernels:
    """For the length of a `with` block, every kernel launcher runs its plain
    PyTorch version on the card's tensors (and counts no launch)."""

    def __enter__(self):
        from ft_mpc_torch.solvers import lanes_alloc, lanes_condense, lanes_qp

        self.swaps = [(lanes_qp, "_admm_cuda", lanes_qp.admm_plain),
                      (lanes_condense, "_condense_cuda", lanes_condense.condense_plain),
                      (lanes_alloc, "_alloc_cuda", lanes_alloc.alloc_plain)]
        self.real = [getattr(m, name) for m, name, _ in self.swaps]
        for m, name, plain in self.swaps:
            setattr(m, name, plain)
        return self

    def __exit__(self, *exc):
        for (m, name, _), real in zip(self.swaps, self.real):
            setattr(m, name, real)


class _Hooked:
    """A module function with a hook called after each call (`after(args,
    kwargs, out)`); attributes (the launch counters) are the function's."""

    def __init__(self, real, after):
        object.__setattr__(self, "real", real)
        object.__setattr__(self, "after", after)

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.after(args, kwargs, out)
        return out

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __setattr__(self, name, value):
        setattr(self.real, name, value)


class Decisions:
    """For the length of a `with` block, the discrete decisions the condensed
    step takes on each bank row: after every ADMM phase whether rho stayed
    (it freezes once the phase's r_prim <= 1e-4, `solvers/lanes_qp.py`), and
    the line search's step length; the cleanup's rows are mapped back through
    its row choice.  `table(B)` gives them as columns, NaN where a row took
    no part."""

    def __enter__(self):
        from ft_mpc_torch.controllers import spiraling as sp
        from ft_mpc_torch.solvers import lanes_qp as lq

        self.log, self.rows, rho_args = [], None, []

        def solved(args, kwargs, sol):
            seq = rho_args + [sol.rho]
            held = [(seq[i + 1] == seq[i]).cpu() for i in range(len(seq) - 1)]
            self.log.append((self.rows, torch.stack(held, dim=1)))
            rho_args.clear()

        def chose(args, kwargs, out):
            self.rows = args[1].cpu()

        hooks = ((lq, "admm_lanes", lambda a, k, o: rho_args.append(a[11].clone())),
                 (sp, "solve_mpc_qp_lanes", solved), (sp, "take_rows", chose),
                 (sp, "_merit_alpha", lambda a, k, o: self.log.append(
                     (self.rows, o.cpu()[:, None]))))
        self.swaps = [(m, name, getattr(m, name)) for m, name, _ in hooks]
        for m, name, after in hooks:
            setattr(m, name, _Hooked(getattr(m, name), after))
        return self

    def __exit__(self, *exc):
        for m, name, real in self.swaps:
            setattr(m, name, real)

    def table(self, B: int) -> torch.Tensor:
        cols = []
        for rows, v in self.log:
            full = torch.full((B, v.shape[1]), float("nan"), dtype=torch.float64)
            full[slice(None) if rows is None else rows] = v.double()
            cols.append(full)
        return torch.cat(cols, dim=1) if cols else torch.empty((B, 0), dtype=torch.float64)


def card_vs_cpu(device, x0: np.ndarray, stagewise_horizon: int = 0,
                steps: int = 1, plain_on_card: bool = False, decisions: bool = False,
                f64: bool = False, **ctx_kw) -> dict:
    """init + `steps` chained whole steps on the card and in the port's CPU
    run, float32 both, on the first len(x0) bank rows from states x0; the
    condensed step, or the stagewise one at `stagewise_horizon`.  Every step
    is compared (from the second on, the warm start, duals and rho carried
    across steps are held too), and the worst is returned.  With
    `plain_on_card` the other side is the card with every kernel's plain
    version (`PlainKernels`) instead of the CPU.  With `f64` the port's CPU
    run in float64 is a third side, and each float32 side's largest wrench
    distance from it is returned (`wrench_err_vs_f64`, card first).

    The MPC's wrench is compared on every row.  u_phys is compared on the rows
    whose allocation took the same branches on both sides: the wrench lands
    on a hull facet (an active constraint), so the hull test is decided by
    rounding, and the clipped branch's 60-step FISTA projection moves u by up
    to ~1 N (the float64 CPU run differs from the float32 one in the same
    way).  Those rows are counted.  With `decisions` the condensed step's
    own thresholds are read too (`Decisions`: rho held or adapted after each
    ADMM phase, the step length); rows where one of them went differently
    on the two sides are counted (`split_rows`) and the errors also taken
    without them (`wrench_err_kept`, `u_err_kept`).  `ctx_kw` (bank, params)
    go to Ctx.
    """
    import contextlib

    rows = len(x0)
    outs, excess, tables = [], [], []
    other = (device, PlainKernels) if plain_on_card else (torch.device("cpu"),
                                                          contextlib.nullcontext)
    sides = [(device, torch.float32, contextlib.nullcontext),
             (other[0], torch.float32, other[1])]
    if f64:
        sides.append((torch.device("cpu"), torch.float64, contextlib.nullcontext))
    record = Decisions if decisions else contextlib.nullcontext
    for dev, dtype, kernels_as in sides:
        with kernels_as():
            ctx = Ctx(dev, dtype, rows, x0=x0, stagewise_horizon=stagewise_horizon,
                      **ctx_kw)
            with record() as d:
                warm = ctx.init()
            per_step, table = [], [d.table(rows)] if decisions else []
            for _ in range(steps):
                with record() as d:
                    o = ctx.step(warm)
                warm = o.warm
                flags = torch.stack([o.alloc.was_clipped, o.alloc.used_fallback], dim=1)
                per_step.append((o.u_phys.cpu(), o.wrench.cpu(), flags.cpu()))
                if decisions:
                    table.append(d.table(rows))
        outs.append(per_step)
        excess.append(box_excess(warm.X))
        tables.append(torch.cat(table, dim=1) if decisions else None)
    if f64:
        ref, outs, excess = outs.pop(), outs, excess[:2]
    split = torch.zeros(rows, dtype=torch.bool)
    if decisions:
        a, b = tables[:2]
        split = (torch.ones(rows, dtype=torch.bool) if a.shape != b.shape else
                 ~((a == b) | (a.isnan() & b.isnan())).all(dim=1))
    res = {"finite": True, "wrench_err": 0.0, "u_err": 0.0, "branch_rows": 0,
           "rows": rows, "wrench_err_per_step": [], "box_excess_card_cpu": excess,
           "rows_beyond_tol": [], "split_rows": split.nonzero().flatten().tolist(),
           "wrench_err_kept": 0.0, "u_err_kept": 0.0, "off_rows": 0}
    off = split.clone()  # rows on a threshold: a split decision or allocation branch
    for (u_g, w_g, f_g), (u_c, w_c, f_c) in zip(*outs):
        same = (f_g == f_c).all(dim=1)
        off |= ~same
        dw = (w_g - w_c).abs().amax(dim=1)
        du = (u_g - u_c).abs().amax(dim=1)
        w_err = float(dw.max())
        u_err = float(du[same].max()) if same.any() else 0.0
        res["finite"] &= bool(torch.isfinite(u_g).all() and torch.isfinite(w_g).all())
        res["wrench_err"] = max(res["wrench_err"], w_err)
        res["u_err"] = max(res["u_err"], u_err)
        res["branch_rows"] = max(res["branch_rows"], int((~same).sum()))
        res["wrench_err_per_step"].append(w_err)
        res["rows_beyond_tol"] = sorted(set(res["rows_beyond_tol"]) | set(
            (dw > TOL_STEP_U).nonzero().flatten().tolist()))
        kept = ~split
        if kept.any():
            res["wrench_err_kept"] = max(res["wrench_err_kept"], float(dw[kept].max()))
        if (kept & same).any():
            res["u_err_kept"] = max(res["u_err_kept"], float(du[kept & same].max()))
    res["off_rows"] = int(off.sum())
    if f64:
        res["wrench_err_vs_f64"] = [
            max(float((side[1].double() - r[1]).abs().max()) for side, r in zip(out, ref))
            for out in outs]
    return res


# ---------------------------------------------------------------------------
# the closed loop (ft_mpc_torch/sim/env.py)
# ---------------------------------------------------------------------------


class StepRecorder:
    """Wraps the controller entry point a rollout calls (`env.<name>`) for
    the length of a `with` block: a timestamp after a device sync at every
    step's start (so per-step times cover the whole step: controller, plant,
    noise, warm-start shift), and with `keep` each step's inputs and output.
    The rollout itself is not changed."""

    def __init__(self, name: str, device, keep: bool = False):
        self.name, self.device, self.keep = name, device, keep
        self.stamps, self.calls = [], []

    def __enter__(self):
        from ft_mpc_torch.sim import env

        self.env, self.real = env, getattr(env, self.name)

        def wrapped(*args):
            sync(self.device)
            self.stamps.append(time.perf_counter())
            out = self.real(*args)
            if self.keep:
                self.calls.append((args, out))
            return out

        setattr(env, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.env, self.name, self.real)
        sync(self.device)
        self.stamps.append(time.perf_counter())

    def step_ms(self) -> np.ndarray:
        return 1e3 * np.diff(np.asarray(self.stamps))


def history_stats(hist, rec: StepRecorder, u_ub) -> dict:
    """A rollout's per-step times and health, from its (B, T, ...) history;
    u_ub (B, 16), or (B, T, 16) where the scenario changes with the step."""
    ms = rec.step_ms()
    B, T = hist.u_phys.shape[:2]
    u = hist.u_phys.double()
    ub = (u_ub[:, None, :] if u_ub.dim() == 2 else u_ub).double().expand_as(u)
    broken = ub <= 0
    finite = all(bool(torch.isfinite(getattr(hist, f).double()).all())
                 for f in ("state", "c0", "u_phys", "wrench", "cost", "r_prim"))
    return {
        "B": B, "steps": T,
        "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
        "wall_s": float(ms.sum() / 1e3),
        "solves_per_s": B * 1e3 / float(np.percentile(ms, 50)),
        "finite": finite,
        "u_below_0": float(torch.clamp(-u, min=0).max()),
        "u_above_ub": float(torch.clamp(u - ub, min=0).max()),
        "max_broken_u": float(u[broken].abs().max()) if bool(broken.any()) else 0.0,
        "max_r_prim_per_step": [float(v) for v in hist.r_prim.double().amax(dim=0)],
        "max_term_gap_per_step": [float(v) for v in hist.term_gap.double().amax(dim=0)],
    }


def loop_lanes(ctx: Ctx, steps: int, noise: bool = True, keep: bool = False):
    """`batched_rollout_lanes` on ctx's bank, states and configuration, with
    the launch counters zeroed just before and read just after."""
    from ft_mpc_torch.sim import env

    gen = torch.Generator(device=ctx.device).manual_seed(0) if noise else None
    sim = env.SimConfig(steps=steps, noise_mode="reference" if noise else "none")
    zero_counters()
    with StepRecorder("get_control_batch", ctx.device, keep=keep) as rec:
        hist = env.batched_rollout_lanes(ctx.params, ctx.bank, ctx.weights, ctx.cfg, sim,
                                         ctx.x0, ctx.x_ref_full, ctx.u_ref_full, gen)
    launches = read_counters()
    res = history_stats(hist, rec, ctx.bank.u_ub)
    res["launches"] = launches
    res["launches_per_step"] = {k: v / steps for k, v in launches.items()}
    return res, hist, rec


def flip_on_threshold(ctx_g: Ctx, out_g, out_c) -> torch.Tensor:
    """Per row of a card step and the CPU step from the same state: whether a
    branch choice that differs sits on a threshold.  A hull-test flip is on
    it when the exact (float64) test of the two sides' wrenches disagrees,
    or either lies within float32 rounding of the margin; a fallback flip
    when the side that kept its u has an equality error above half the
    fallback threshold (as in check_alloc_main)."""
    from ft_mpc_torch.solvers.lanes_alloc import _BIG

    b = ctx_g.bank
    hA = (b.hull_A * b.hull_mask[:, :, None]).float().cpu()
    hb = torch.where(b.hull_mask > 0.5, b.hull_b, _BIG).float().cpu()
    ff = b.faulty_force_gen.float().cpu()
    s_g, band_g = hull_slack(hA, hb, out_g.wrench.float().cpu(), ff)
    s_c, band_c = hull_slack(hA, hb, out_c.wrench.float().cpu(), ff)
    out_g_side = (s_g > 0).any(dim=1)
    out_c_side = (s_c > 0).any(dim=1)
    near = ((s_g.abs() <= band_g).any(dim=1)) | ((s_c.abs() <= band_c).any(dim=1))
    hull_ok = (out_g_side != out_c_side) | near
    clip_g, fb_g = out_g.alloc.was_clipped.cpu(), out_g.alloc.used_fallback.cpu()
    clip_c, fb_c = out_c.alloc.was_clipped.cpu(), out_c.alloc.used_fallback.cpu()
    kept_eq = torch.where(fb_g, out_c.alloc.r_prim.cpu(), out_g.alloc.r_prim.cpu()).double()
    fb_ok = kept_eq > FALLBACK_EQ_ERR / 2
    hull_flip = clip_g != clip_c
    fb_flip = ~hull_flip & (fb_g != fb_c)
    return torch.where(hull_flip, hull_ok, torch.where(fb_flip, fb_ok, True))


def loop_card_vs_cpu(device, B: int, steps: int) -> dict:
    """`steps` closed-loop steps on the card (bank32 rows, bench states, no
    noise); the CPU port takes each step's controller call from the card's
    state and warm start.  u_phys on same-branch rows and the wrench on every
    row within TOL_STEP_U; every branch flip must sit on a threshold."""
    ctx = Ctx(device, torch.float32, B)
    _, hist, rec = loop_lanes(ctx, steps, noise=False, keep=True)
    cpu = Ctx(torch.device("cpu"), torch.float32, B)
    host = lambda t: None if t is None else t.cpu()
    res = {"rows": B, "steps": steps, "wrench_err": [], "u_err": [], "branch_rows": [],
           "flips_off_threshold": 0, "finite": bool(torch.isfinite(hist.u_phys).all())}
    for (args, out_g) in rec.calls:
        x0, x_ref, u_ref, warm = args[4:]
        warm_c = type(warm)(*(host(t) for t in warm))
        out_c = cpu.sp.get_control_batch(cpu.params, cpu.bank, cpu.weights, cpu.cfg,
                                         x0.cpu(), x_ref.cpu(), u_ref.cpu(), warm_c)
        same = ((out_g.alloc.was_clipped.cpu() == out_c.alloc.was_clipped)
                & (out_g.alloc.used_fallback.cpu() == out_c.alloc.used_fallback))
        du = (out_g.u_phys.cpu() - out_c.u_phys).abs().amax(dim=1)
        res["wrench_err"].append(float((out_g.wrench.cpu() - out_c.wrench).abs().max()))
        res["u_err"].append(float(du[same].max()) if bool(same.any()) else 0.0)
        res["branch_rows"].append(int((~same).sum()))
        res["flips_off_threshold"] += int((~flip_on_threshold(ctx, out_g, out_c)).sum())
    return res


def demo_setup(device, terminal_mode: str = "empc", horizon: int = 15):
    """The demo's plant, scenario, weights and references (examples/sim.py:
    the (10, 11) double fault, hover for 30 s, float32)."""
    from ft_mpc_torch.controllers import spiraling as sp
    from ft_mpc_torch.geometry.scenario import load_demo_scenario
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    f32 = torch.float32
    sc = load_demo_scenario(terminal_mode, device=device, dtype=f32)
    params = BodyParams.default(0.1, dtype=f32, device=device)
    weights = sp.MPCWeights.from_diagonals(Q_DIAG, R_DIAG, dtype=f32, device=device)
    traj = generate_trajectory("hover", 0.1, 30)
    x_ref, u_ref = prepare_center_trajectory(traj, sc.omega_des.double().cpu().numpy(),
                                             16.8, 0.1, horizon + 1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=device)
    return sp, sc, params, weights, t(x_ref), t(u_ref)


def demo_x0() -> np.ndarray:
    """examples/sim.py:82-86."""
    from scipy.spatial.transform import Rotation

    x0 = np.zeros(13)
    x0[0:3] = [1, 0, 1]
    x0[3:6] = [1, 0.5, 0]
    x0[6:10] = Rotation.from_euler("zyx", [50, 30, -10], degrees=True).as_quat()
    x0[10:13] = [0.3, 0.8, -0.1]
    return x0


def demo_rollout(device, steps: int = DEMO_STEPS) -> dict:
    """The demo through its own entry point (`ft_mpc_torch.examples.sim.main`,
    as `python -m ft_mpc_torch.examples.sim` runs it): the default
    configuration ((10, 11), 30 s, 'reference' noise seeded 0, MPCConfig's
    defaults at horizon 15), its duration cut to `steps` control periods
    where that is fewer; the terminal cache read from a scratch copy."""
    import tempfile

    import yaml

    from ft_mpc_torch.examples import sim
    from ft_mpc_torch.utils.config import DEFAULT_CONFIG_PATH

    raw = yaml.safe_load(DEFAULT_CONFIG_PATH.read_text())
    if steps != int(raw["traj_duration"] / raw["time_step"]):
        raw["traj_duration"] = (steps + 0.5) * raw["time_step"]
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        config = tmp / "demo.yaml"
        config.write_text(yaml.safe_dump(raw))
        cache = copy_cache(tmp / "cache")
        zero_counters()
        with StepRecorder("get_control_rows", device) as rec:
            out = sim.main(["--config", str(config), "--no-anim", "--device", str(device),
                            "--csv", str(tmp / "demo.csv"), "--cache-dir", str(cache)])
    hist = out["history"]
    res = history_stats(type(hist)(*(t[None] for t in hist)), rec, out["scenario"].u_ub[None])
    res["launches"] = read_counters()
    res["final_orbit_center_error_m"] = out["final_error_m"]
    return res


def scenario_batch_rollout(device, B: int, steps: int) -> dict:
    """`batched_rollout` (the per-scenario controller on every row): the
    snapshot tiled to B rows, every row from the demo's state."""
    from ft_mpc_torch.sim import env

    ctx = Ctx(device, torch.float32, B, x0=np.tile(demo_x0(), (B, 1)))
    sp = ctx.sp
    cfg = sp.MPCConfig(horizon=15)
    _, sc, params, weights, x_ref, u_ref = demo_setup(device)
    gen = torch.Generator(device=device).manual_seed(0)
    zero_counters()
    with StepRecorder("get_control_rows", device) as rec:
        hist = env.batched_rollout(params, ctx.bank, weights, cfg, env.SimConfig(steps=steps),
                                   ctx.x0, x_ref, u_ref, gen)
    res = history_stats(hist, rec, ctx.bank.u_ub)
    res["launches"] = read_counters()
    return res


def schedule_rollout(device, switch: int, steps: int) -> dict:
    """`rollout_with_fault_schedule`: healthy, then the (10, 11) double fault
    from step `switch` (tests/test_mpc.py:188-212, no noise)."""
    from torch.utils._pytree import tree_map

    from ft_mpc_torch.geometry.scenario import load_bank_snapshot, take_rows
    from ft_mpc_torch.sim import env

    sp, faulted, params, weights, x_ref, u_ref = demo_setup(device)
    healthy = take_rows(load_bank_snapshot(device=device), 0)
    sched = tree_map(lambda a, b: torch.stack([a, b]), healthy, faulted)
    x0 = np.zeros(13)
    x0[0:3] = [0.3, 0.1, -0.2]
    x0[9] = 1.0
    zero_counters()
    with StepRecorder("get_control_rows", device) as rec:
        hist = env.rollout_with_fault_schedule(
            params, sched, torch.tensor([0, switch], device=device), weights,
            sp.MPCConfig(horizon=15), env.SimConfig(steps=steps, noise_mode="none"),
            torch.as_tensor(x0, dtype=torch.float32, device=device), x_ref, u_ref)
    u = hist.u_phys.double()
    u_ub = torch.where(torch.arange(steps, device=device)[:, None] < switch,
                       healthy.u_ub, faulted.u_ub)  # (T, 16): the active scenario's
    res = history_stats(type(hist)(*(t[None] for t in hist)), rec, u_ub[None])
    res["launches"] = read_counters()
    res["max_u_10_11_before"] = float(u[:switch, 10:12].max())
    res["max_u_10_11_after"] = float(u[switch:, 10:12].abs().max())
    return res


def stagewise_rollout(device, horizon: int, steps: int) -> dict:
    """`rollout` on the stagewise backend (mode 'scan', the configuration of
    benchmarks/long_horizon.py), the demo's scenario from rest near the
    orbit, no noise."""
    from ft_mpc_torch.sim import env
    from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig

    sp, sc, params, weights, x_ref, u_ref = demo_setup(device, horizon=horizon)
    cfg = sp.MPCConfig(horizon=horizon, sqp_iters=2, qp_backend="stagewise",
                       stagewise=StagewiseConfig(iters=60, phases=1, rho=50.0,
                                                 adapt_clip=1.5, mode="scan"))
    x0 = np.zeros(13)
    x0[0:3] = [0.3, 0.1, -0.2]
    x0[9] = 1.0
    zero_counters()
    with StepRecorder("get_control_rows", device) as rec:
        hist = env.rollout(params, sc, weights, cfg, env.SimConfig(steps=steps, noise_mode="none"),
                           torch.as_tensor(x0, dtype=torch.float32, device=device), x_ref, u_ref)
    res = history_stats(type(hist)(*(t[None] for t in hist)), rec, sc.u_ub[None])
    res["launches"] = read_counters()
    res["max_term_gap"] = max(res["max_term_gap_per_step"])
    return res


def profile_steps(ctx: Ctx, warm, label: str, n: int = 2) -> str:
    """`profile_run` over `n` chained steps of ctx's path."""

    def run():
        w = warm
        for _ in range(n):
            w = ctx.step(w).warm

    return profile_run(run, ctx.device, label, n)


def profile_run(run, device, label: str, n: int) -> str:
    """torch.profiler around `run()`, which takes `n` steps: device time by
    kernel and host time by the port's ranges; the summary is printed, and
    returned with the full table."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        sync(device)
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    ev = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_time = lambda e: getattr(e, "self_device_time_total", 0)
    # device time of kernels and copies; the port's ranges (ft_mpc.*) also
    # appear as device-side spans, which would count their kernels twice
    dev_us = sum(dev_time(e) for e in ev
                 if getattr(e, "device_type", None) == cuda
                 and not e.key.startswith("ft_mpc."))
    table = ev.table(sort_by="self_device_time_total", row_limit=60)
    lines = [f"{label}: wall per step {wall_ms:.3f} ms under the profiler, device busy per "
             f"step {dev_us / 1e3 / n:.3f} ms ({100 * dev_us / 1e3 / n / wall_ms:.1f}%)"]
    spans = {e.key: dev_time(e) for e in ev if e.key.startswith("ft_mpc.")
             and getattr(e, "device_type", None) == cuda}
    hosts = [e for e in ev if e.key.startswith("ft_mpc.") and e.cpu_time_total > 0]
    for e in sorted(hosts, key=lambda e: -e.cpu_time_total):
        lines.append(f"{e.key}: host {e.cpu_time_total / 1e3 / n:.3f} ms/step "
                     f"({100 * e.cpu_time_total / 1e3 / n / wall_ms:.1f}%), device span "
                     f"{spans.get(e.key, 0) / 1e3 / n:.3f} ms/step, {e.count // n} per step")
    for ln in lines:
        log("profile: " + ln)
    return "\n".join(lines) + "\n\n" + table + "\n"


def drive_closed_loop(device, card: str, check, profiles: list | None = None) -> None:
    """The closed-loop phases (section 6 of the module docstring); with
    `profiles`, also traces three steps of the demo's rollout into it."""
    ctx = Ctx(device, torch.float32, BATCH)
    res, hist, _ = loop_lanes(ctx, LOOP_STEPS)
    log("closed loop, batched_rollout_lanes: " + json.dumps(res))
    log(f"closed loop, batched_rollout_lanes (B={BATCH}, Nt={HORIZON}, {LOOP_STEPS} steps, "
        f"'reference' noise): p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms per step, "
        f"{res['solves_per_s']:.1f} solves/s, max r_prim {max(res['max_r_prim_per_step']):.3e}, "
        f"max term_gap {max(res['max_term_gap_per_step']):.3e}, launches per step "
        f"{res['launches_per_step']}; card: {card}")
    check(res["finite"], "closed loop (lanes): history not finite")
    check(res["u_below_0"] <= 1e-6 and res["u_above_ub"] <= 1e-6,
          f"closed loop (lanes): u_phys outside [0, u_ub] by {res['u_below_0']}, "
          f"{res['u_above_ub']}")
    check(res["max_broken_u"] <= 1e-6,
          f"closed loop (lanes): a broken thruster commanded {res['max_broken_u']}")
    want = {k: n * LOOP_STEPS + (k == "condense_lanes") for k, n in LOOP_LAUNCHES.items()}
    got = {k: res["launches"][k] for k in want}
    check(got == want, f"closed loop (lanes): launches {got}, expected {want} "
          "(3 / 5 / 1 a step and the warm start's condensing)")
    check(all(res["launches"][k] == 0 for k in STAGEWISE_KERNELS[:3]),
          "closed loop (lanes): a stagewise kernel launched")
    last = SimpleNamespace(wrench=hist.wrench[:, -1])
    am = check_alloc_main(ctx, last)
    log("alloc on the closed loop's last wrenches (control: plain float32 vs plain "
        "float64): " + json.dumps(am))
    check(am["u_err"] <= TOL_ALLOC_MAIN and am["branch_rows"] <= MAX_FLIP_SHARE * am["rows"]
          and am["hull_flips_off_threshold"] == 0
          and all(e > FALLBACK_EQ_ERR / 2 for e in am["fallback_flips_kept_eq_err"]),
          f"allocation kernel disagrees with its plain version on the closed loop: {am}")
    del ctx, hist, last
    torch.cuda.empty_cache()

    B_s, steps_s = LOOP_SMALL
    same = loop_card_vs_cpu(device, B_s, steps_s)
    log(f"closed loop, same state card vs CPU port ({B_s} rows, {steps_s} steps, float32): "
        + json.dumps(same))
    # the branch rows are counted; a flip is allowed only on a threshold
    check(same["finite"] and max(same["wrench_err"]) <= TOL_STEP_U
          and max(same["u_err"]) <= TOL_STEP_U and same["flips_off_threshold"] == 0,
          f"closed loop: the card's step differs from the CPU port's: {same}")

    none = lambda r: all(v == 0 for v in r["launches"].values())
    demo = demo_rollout(device, DEMO_STEPS)
    log("demo rollout: " + json.dumps(demo))
    log(f"demo rollout (examples/sim.py: (10, 11), empc, Nt=15, {DEMO_STEPS} steps, "
        f"'reference' noise): p50 {demo['p50_ms']:.3f} ms per step, wall {demo['wall_s']:.2f} s, "
        f"{DEMO_STEPS / demo['wall_s']:.1f} solves/s, final orbit-center position error "
        f"{demo['final_orbit_center_error_m']:.4f} m (gate {DEMO_ERR_GATE}); card: {card}")
    check(demo["finite"] and demo["final_orbit_center_error_m"] < DEMO_ERR_GATE,
          f"demo: final orbit-center error {demo['final_orbit_center_error_m']}")
    check(demo["max_broken_u"] <= 1e-6 and demo["u_above_ub"] <= 1e-6
          and demo["u_below_0"] <= 1e-6, f"demo: thruster bounds violated: {demo}")
    check(none(demo), f"demo: the per-scenario path launched a kernel: {demo['launches']}")
    if profiles is not None:
        profiles.append(profile_run(lambda: demo_rollout(device, 3), device,
                                    "demo rollout, per-scenario path", 3))

    B_b, steps_b = SCEN_BATCH
    batch = scenario_batch_rollout(device, B_b, steps_b)
    log("batched_rollout: " + json.dumps(batch))
    log(f"batched_rollout (B={B_b}, {steps_b} steps): p50 {batch['p50_ms']:.3f} ms per step, "
        f"{batch['solves_per_s']:.1f} solves/s; card: {card}")
    check(batch["finite"] and batch["max_broken_u"] <= 1e-6,
          f"batched_rollout: not finite, or a broken thruster commanded: {batch}")
    check(none(batch), f"batched_rollout launched a kernel: {batch['launches']}")

    switch, steps_f = SCHEDULE
    sched = schedule_rollout(device, switch, steps_f)
    log("rollout_with_fault_schedule: " + json.dumps(sched))
    check(sched["finite"] and sched["max_u_10_11_before"] > 1e-4
          and sched["max_u_10_11_after"] <= 1e-6 and sched["max_broken_u"] <= 1e-6
          and sched["u_above_ub"] <= 1e-6 and sched["u_below_0"] <= 1e-6,
          f"rollout_with_fault_schedule: thrusters 10/11 {sched['max_u_10_11_before']} before, "
          f"{sched['max_u_10_11_after']} after step {switch}")
    check(none(sched), f"rollout_with_fault_schedule launched a kernel: {sched['launches']}")

    Nt_s, steps_w = SW_ROLLOUT
    swr = stagewise_rollout(device, Nt_s, steps_w)
    log("stagewise rollout: " + json.dumps(swr))
    log(f"stagewise rollout (mode 'scan', Nt={Nt_s}, {steps_w} steps): p50 {swr['p50_ms']:.3f} ms "
        f"per step, max_term_gap {swr['max_term_gap']:.3e}; card: {card}")
    check(swr["finite"] and swr["max_term_gap"] <= GAP_GATE,
          f"stagewise rollout: finite {swr['finite']}, max_term_gap {swr['max_term_gap']}")
    check(none(swr), f"stagewise rollout launched a kernel: {swr['launches']}")


# ---------------------------------------------------------------------------
# section 7: banks built by the port (ft_mpc_torch.api, geometry.scenario)
# ---------------------------------------------------------------------------


def port_census_bank(check) -> tuple:
    """7a: all 137 DEFAULT_TUNING fault classes of bench.py's census built by
    the port on the host, from the terminal cache (81 searched orbits, 4
    quadratic fallbacks), float32; its first 32 rows, the bench's patterns,
    held leaf for leaf (as float64) against the committed snapshot.
    Returns (the 137-row bank on the host, host seconds, max |difference|)."""
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.convert import flatten_namedtuple
    from ft_mpc_torch.geometry.scenario import BENCH_BANK, default_fault_pool, stack_scenarios
    from ft_mpc_torch.ops.dynamics import BodyParams

    cpu = torch.device("cpu")
    plant = BodyParams.default(0.1, dtype=torch.float32, device=cpu)
    t0 = time.perf_counter()
    scs = [build_scenario_with_terminal(plant, f, DEFAULT_TUNING, device=cpu)
           for f in default_fault_pool()]
    bank = stack_scenarios(scs, device=cpu, dtype=torch.float32)
    host_s = time.perf_counter() - t0
    bench = flatten_namedtuple(stack_scenarios(scs[:32], device=cpu,
                                               dtype=torch.float64).scenarios)
    with np.load(BENCH_BANK) as z:
        snap = {k: z[k] for k in z.files}
    check(sorted(bench) == sorted(snap), "port's bench bank: leaves differ from the snapshot's")
    err = max(float(np.abs(bench[k] - snap[k]).max()) for k in snap if k in bench)
    return bank, host_s, err


def port_bank_path(device, label: str, check, bank, small_rows, params=None,
                   x0=None) -> None:
    """7b / 7c: the condensed configuration of section 2 at B=2048 on a bank
    the port built (tiled to BATCH), PORT_WARMUP + PORT_STEPS chained steps
    with the launch counters zeroed before and read after, the plant and
    launch gates, kernels 1-3 held against their plain versions on this
    bank's own inputs, and one whole step on `small_rows` rows against the
    CPU port."""
    ctx = Ctx(device, torch.float32, BATCH, x0=x0, bank=bank, params=params)
    res, warm, out = drive_main_path(ctx, PORT_WARMUP, PORT_STEPS)
    u, ub = out.u_phys.double(), ctx.bank.u_ub.double()
    res["u_below_0"] = float(torch.clamp(-u, min=0).max())
    res["u_above_ub"] = float(torch.clamp(u - ub, min=0).max())
    res["max_broken_u"] = float(u[ub <= 0].abs().max()) if bool((ub <= 0).any()) else 0.0
    log(f"{label}: " + json.dumps(res))
    log(f"{label} (B={BATCH}, Nt={HORIZON}, {PORT_WARMUP}+{PORT_STEPS} steps): "
        f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
        f"{res['solves_per_s']:.1f} solves/s, max_r_prim {res['max_r_prim']:.3e}, "
        f"max_term_gap {res['max_term_gap']:.5f} (neither gated), launches per step "
        f"{res['launches_per_step']}")
    check(res["finite"], f"{label}: non-finite outputs")
    check(res["u_below_0"] <= 1e-6 and res["u_above_ub"] <= 1e-6,
          f"{label}: u_phys outside [0, u_ub] by {res['u_below_0']}, {res['u_above_ub']}")
    check(res["max_broken_u"] <= 1e-6,
          f"{label}: a broken thruster commanded {res['max_broken_u']}")
    n = PORT_WARMUP + PORT_STEPS
    want = {k: m * n + (k == "condense_lanes") for k, m in LOOP_LAUNCHES.items()}
    want.update(riccati_bwd_lanes=0, riccati_fwd_lanes=0, riccati_prepare_lanes=0)
    check(res["launches"] == want, f"{label}: launches {res['launches']}, expected {want} "
          "(3 / 5 / 1 a step and the warm start's condensing)")

    krows = [check_condense(ctx, warm),
             check_admm(ctx, admm_inputs(ctx, warm, ctx.weights), ctx.cfg.admm.iters,
                        "T=64")]
    for r in krows:
        r["shape"] = f"{label}: {r['shape']}"
        log("kernel: " + json.dumps(with_share(r)))
        ok = (r["max_abs_err"] <= r["tol"]) if "tol" in r else (r["max_rel_err"] <= r["tol_rel"])
        check(ok and np.isfinite(r["max_abs_err"]),
              f"{r['name']} ({r['shape']}) disagrees with its plain version")
    hold_alloc_main(ctx, out, label, check)

    sub = ctx.sp.take_rows(ctx.bank, small_rows)
    sub_params = ctx.sp._params_row(ctx.params, ctx.sp.params_batch_axes(ctx.params),
                                    small_rows)
    step = card_vs_cpu(device, ctx.x0[small_rows].cpu().numpy(), bank=sub, params=sub_params)
    log(f"{label}, whole step card vs CPU port ({step['rows']} rows, float32): "
        f"max |dwrench| {step['wrench_err']:.3e}, max |du_phys| {step['u_err']:.3e} "
        f"(tol {TOL_STEP_U}) on the rows whose allocation took the same branches; "
        f"{step['branch_rows']} rows on a branch threshold")
    check(step["finite"], f"{label}: card step is not finite")
    check(step["wrench_err"] <= TOL_STEP_U and step["u_err"] <= TOL_STEP_U
          and step["branch_rows"] <= step["rows"] // 8,
          f"{label}: card step differs from the CPU port: {step}")


def c2_horizons(device, check, bank) -> dict:
    """7d: the condensed path at B=C2_BATCH on the port's census bank at the
    horizons of C2_HORIZONS (the ADMM cluster design), C2_STEPS chained
    steps each with the counters zeroed before and read after; then the ADMM
    kernel held against its plain version (TOL_ADMM, relative) on each run's
    last QP, T=64, 60 iterations, and timed beside its bound.  Returns {Nt:
    kernel row}."""
    from ft_mpc_torch.solvers.lanes_qp import admm_plan

    rows = {}
    for Nt in C2_HORIZONS:
        ctx = Ctx(device, torch.float32, C2_BATCH, bank=bank, horizon=Nt)
        res, warm, _ = drive_main_path(ctx, 0, C2_STEPS)
        plan = admm_plan(Nt, ctx.bank.hull_A.shape[1], ctx.bank.term_A.shape[1])
        design = plan["design"]
        by = res["admm_launches_by_design"]
        log(f"condensed path at Nt={Nt} (B={C2_BATCH}, {C2_STEPS} steps): p50 "
            f"{res['p50_ms']:.3f} ms, max_r_prim {res['max_r_prim']:.3e}, ADMM plan "
            f"{plan}, launches {res['launches']}, ADMM by design {by}")
        check(res["finite"], f"condensed path at Nt={Nt}: non-finite outputs")
        check(by[design] == 5 * C2_STEPS and res["launches"]["admm_lanes"] == 5 * C2_STEPS,
              f"condensed path at Nt={Nt}: ADMM launches {by}, expected 5 a step of "
              f"design '{design}'")
        r = check_admm(ctx, admm_inputs(ctx, warm, ctx.weights), ctx.cfg.admm.iters,
                       f"C2 Nt={Nt} ({design} design, {plan['cluster']} blocks)", reps=5)
        r["launches"] = by[design]
        r["design"], r["cluster"] = design, plan["cluster"]
        log("kernel: " + json.dumps(with_share(r)))
        check(r["max_rel_err"] <= r["tol_rel"] and np.isfinite(r["max_abs_err"]),
              f"admm_lanes ({r['shape']}) disagrees with its plain version")
        rows[Nt] = r
        del ctx, warm
        torch.cuda.empty_cache()
    check(all(r["design"] == "cluster" for r in rows.values()),
          f"ADMM designs at Nt={C2_HORIZONS}: {[r['design'] for r in rows.values()]}")
    return rows


def drive_port_banks(device, card: str, check) -> dict:
    """Section 7; returns the ADMM kernel row of the cluster design at Nt=40."""
    from ft_mpc_torch.geometry.scenario import build_randomized_bank
    from ft_mpc_torch.ops.dynamics import BodyParams

    census, host_s, err = port_census_bank(check)
    log(f"port-built banks: the 137 DEFAULT_TUNING classes built on the host in "
        f"{host_s:.3f} s; the bench's 32 rows against bench_bank32.npz: max |diff| "
        f"{err:.3e} (tol {TOL_BANK})")
    check(err <= TOL_BANK, f"port's bench bank differs from the snapshot by {err}")
    span = torch.as_tensor(np.linspace(0, len(census.scenarios.r) - 1, PORT_SMALL[0])
                           .round().astype(np.int64))
    port_bank_path(device, "census bank (137 classes tiled)", check, census.scenarios, span)

    t0 = time.perf_counter()
    plant = BodyParams.default(0.1, dtype=torch.float32, device="cpu")
    rbank, rparams, rx0 = build_randomized_bank(plant, BATCH, seed=0, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    log(f"randomized bank (build_randomized_bank, n={BATCH}, seed 0): built in "
        f"{build_s:.3f} s on the host, per-row mass {float(rparams.mass.min()):.4f}.."
        f"{float(rparams.mass.max()):.4f} kg; card: {card}")
    port_bank_path(device, "randomized bank", check, rbank.scenarios,
                   torch.arange(PORT_SMALL[1]), params=rparams, x0=rx0.cpu().numpy())
    del rbank, rparams, rx0
    torch.cuda.empty_cache()

    c2 = c2_horizons(device, check, census.scenarios)
    row = dict(c2[40])
    row["name"] = "admm_lanes (cluster design, Nt=40)"
    return row



# ---------------------------------------------------------------------------
# section 8: the API, the demo, the accuracy harness and the pipeline
# ---------------------------------------------------------------------------


def copy_cache(dest: Path) -> Path:
    """A scratch copy of the committed terminal cache (never written here)."""
    import shutil

    from ft_mpc_torch.api import TERMINAL_CACHE

    shutil.copytree(TERMINAL_CACHE, dest)
    return dest


def committed_masks() -> dict:
    """The committed float32 entries' feasible grid points (the JAX package's
    runs; `ft_mpc_torch/data/terminal_grid_masks.npz`)."""
    from ft_mpc_torch.benchmarks.build_terminal_cache import load_grid_masks

    return {k: m.feasible for k, m in load_grid_masks().items()}


def pipeline_phase(device, card: str, check, tmp: Path) -> list:
    """8a: the offline pipeline on the card (the value-function QPs on the
    plant's device) for three patterns, each a miss of an empty cache,
    against the committed entry: orbit, emax, r_empc, uimax and the terminal
    set exactly; the grid's feasible points against the committed run's,
    those decided otherwise on the threshold; P9, p9 and c within TOL_PIPE
    (fitted on the committed run's points where they differ).  Also times
    `sample_value_function`'s grid on the card (CUDA events; its host
    numpy included)."""
    from ft_mpc_torch.api import (
        DEFAULT_TUNING,
        build_scenario_with_terminal,
        empc_terminal_ingredients,
        terminal_cache_path,
    )
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.terminal import pipeline as tpl
    from ft_mpc_torch.utils.faults import BrokenThruster

    plant = BodyParams.default(0.1, dtype=torch.float32, device=device)
    masks = committed_masks()
    rows = []
    for name, pat in PIPELINE_PATTERNS:
        faults = [BrokenThruster(i, 1.0) for i in pat]
        cache = tmp / f"pipeline_{name}"
        t0 = time.perf_counter()
        built = empc_terminal_ingredients(plant, faults, DEFAULT_TUNING, cache)
        sync(device)
        host_s = time.perf_counter() - t0
        # the scenario from the entry the miss wrote (a hit now)
        build_scenario_with_terminal(plant, faults, DEFAULT_TUNING, cache_dir=cache,
                                     device=device)
        (entry,) = cache.iterdir()
        ti = tpl.load_terminal_ingredients(entry)
        ref = tpl.load_terminal_ingredients(terminal_cache_path(plant, faults, DEFAULT_TUNING))
        exact = (ti.meta.get("orbit") == ref.meta.get("orbit")
                 and ti.meta.get("fallback") == ref.meta.get("fallback")
                 and np.array_equal(ti.emax, ref.emax) and ti.r_empc == ref.r_empc
                 and ti.meta.get("uimax") == ref.meta.get("uimax")
                 and np.array_equal(ti.term_set.A, ref.term_set.A)
                 and np.array_equal(ti.term_set.b, ref.term_set.b))
        tol = TOL_PIPE * float(np.abs(ref.P9).max())
        close = lambda P, p, c: (np.allclose(P, ref.P9[:6, :6], rtol=TOL_PIPE, atol=tol)
                                 and np.allclose(p, ref.p9, rtol=TOL_PIPE, atol=tol)
                                 and abs(c - ref.c) <= tol)
        row = {"pattern": name, "host_s": host_s, "exact_parts_equal": exact,
               "orbit": ti.meta.get("orbit"), "fallback": ti.meta.get("fallback"),
               "n_grid": ti.meta.get("n_grid"), "n_grid_committed": ref.meta.get("n_grid"),
               "own_fit_close": close(ti.P9[:6, :6], ti.p9, ti.c)
               and np.array_equal(ti.P9[6:, 6:], ref.P9[6:, 6:])}
        if "fallback" in ref.meta:
            row["own_fit_close"] = bool(np.array_equal(ti.P9, ref.P9)
                                        and np.array_equal(ti.p9, ref.p9) and ti.c == ref.c)
        else:
            g = built.grid
            pts, V, r_prim = g.points, g.values, g.r_prim
            row["sample_value_function_ms"] = time_ms(
                lambda: tpl.value_function_grid(g.empc, g.horizon, device=device), 3, device)
            mine = r_prim < tpl.FEASIBLE_R_PRIM
            differ = np.flatnonzero(mine != masks[name])
            row["grid_points_decided_otherwise"] = pts[differ].round(6).tolist()
            row["their_r_prim"] = r_prim[differ].tolist()
            row["differ_on_threshold"] = bool(np.all(
                np.abs(np.log(r_prim[differ] / tpl.FEASIBLE_R_PRIM)) <= np.log(THRESHOLD_BAND)))
            P9, p9, c = tpl.quadratic_bound_blocks(
                *tpl.fit_quadratic_upper_bound(pts[masks[name]], V[masks[name]]),
                ref.P9[6:, 6:])
            row["fit_on_committed_points_close"] = close(P9[:6, :6], p9, c)
            row["grid_n_grid"] = int(mine.sum())
        log(f"pipeline {name}: " + json.dumps(row))
        log(f"pipeline {name} (float32 plant, DEFAULT_TUNING, a miss of an empty cache): "
            f"{host_s:.3f} s on the host, sample_value_function (3131 QPs, one batched "
            f"admm_solve) {row.get('sample_value_function_ms', float('nan')):.3f} ms; n_grid "
            f"{row['n_grid']} (committed {row['n_grid_committed']}); card: {card}")
        check(exact, f"pipeline {name}: orbit, emax, r_empc or the terminal set differ "
              "from the committed entry")
        if "fallback" in ref.meta:
            check(row["own_fit_close"], f"pipeline {name}: fallback ingredients differ")
        else:
            check(row["differ_on_threshold"] and row["grid_n_grid"] == row["n_grid"],
                  f"pipeline {name}: grid points off the threshold decided otherwise: {row}")
            check(row["fit_on_committed_points_close"]
                  and (row["own_fit_close"] or len(differ) > 0),
                  f"pipeline {name}: P9, p9 or c differ from the committed entry: {row}")
        rows.append(row)
    return rows


def api_phase(device, card: str, check, tmp: Path) -> dict:
    """8b: `SpiralingMPC` and `SimulationEnvironment` at the demo's tuning,
    float32 on the card, from the demo's state: API_STEPS[0] steps healthy,
    then `set_fault` with a single fault the committed cache lacks for this
    tuning and plant (a miss: orbit search and pipeline, timed), then
    API_STEPS[1] steps; then `to_history` and `export_csv`."""
    from ft_mpc_torch.api import (
        DEFAULT_TUNING,
        SimulationEnvironment,
        SpiralingMPC,
        cached_terminal_path,
    )
    from ft_mpc_torch.examples.sim import demo_x0
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.utils.config import load_config
    from ft_mpc_torch.utils.faults import BrokenThruster

    cache = copy_cache(tmp / "api_cache")
    tuning = {**DEFAULT_TUNING, **load_config(None).tuning}
    plant = BodyParams.default(0.1, dtype=torch.float32, device=device)
    fault = next(BrokenThruster(i, 1.0) for i in range(16)
                 if cached_terminal_path(plant, [BrokenThruster(i, 1.0)], tuning, cache) is None)
    mpc = SpiralingMPC(plant, [], tuning, cache_dir=cache)
    mpc.load_trajectory("hover", 30.0)
    env = SimulationEnvironment(plant, mpc, seed=0)
    x0 = demo_x0()
    env.set_initial_state(x0[0:3], x0[3:6], x0[6:10], x0[10:13])
    ms = []

    def run(n):
        for _ in range(n):
            t0 = time.perf_counter()
            env.step()
            sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))

    run(API_STEPS[0])
    t0 = time.perf_counter()
    env.set_fault(fault)
    sync(device)
    fault_s = time.perf_counter() - t0
    run(API_STEPS[1])
    u = np.asarray([h[2] for h in env.history])
    hist = env.to_history()
    csv = tmp / "api.csv"
    env.export_csv(str(csv))
    table = np.loadtxt(csv, delimiter=";")
    res = {"fault": fault.index, "set_fault_s": fault_s, "steps": len(ms),
           "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
           "broken_u_after_fault": float(np.abs(u[API_STEPS[0]:, fault.index]).max()),
           "u_before_fault": float(u[:API_STEPS[0], fault.index].max()),
           "finite": bool(np.isfinite(u).all() and np.isfinite(env.state).all()
                          and all(bool(torch.isfinite(t.double()).all()) for t in hist)),
           "csv_shape": list(table.shape),
           "final_orbit_center_error_m": float(np.linalg.norm(
               hist.c0[-1, 0:3].numpy() - hist.x_ref0[-1, 0:3].numpy()))}
    log("api: " + json.dumps(res))
    log(f"api (SpiralingMPC + SimulationEnvironment, the demo's tuning, float32): "
        f"set_fault({fault.index}) on a cache miss {fault_s:.3f} s; p50 {res['p50_ms']:.3f} ms, "
        f"p99 {res['p99_ms']:.3f} ms per step; thruster {fault.index} after the fault "
        f"{res['broken_u_after_fault']:.3e} N; card: {card}")
    check(res["finite"], f"api: non-finite values: {res}")
    check(res["broken_u_after_fault"] <= 1e-6,
          f"api: broken thruster {fault.index} commanded {res['broken_u_after_fault']} N")
    check(res["csv_shape"] == [sum(API_STEPS), 67], f"api: CSV shape {res['csv_shape']}")
    return res


def demo_batch_phase(device, card: str, check, tmp: Path) -> dict:
    """8c: the demo's `main` with --batch DEMO_BATCH on a copy of the default
    configuration whose duration is cut to DEMO_DURATION; patterns the
    committed cache lacks go through the pipeline into a scratch copy."""
    import yaml

    from ft_mpc_torch.examples import sim
    from ft_mpc_torch.utils.config import DEFAULT_CONFIG_PATH

    raw = yaml.safe_load(DEFAULT_CONFIG_PATH.read_text())
    full = raw["traj_duration"]
    raw["traj_duration"] = DEMO_DURATION
    config = tmp / "demo_batch.yaml"
    config.write_text(yaml.safe_dump(raw))
    cache = copy_cache(tmp / "demo_cache")
    zero_counters()
    res = sim.main(["--config", str(config), "--batch", str(DEMO_BATCH), "--no-anim",
                    "--csv", str(tmp / "demo_batch.csv"), "--device", str(device),
                    "--cache-dir", str(cache)])
    out = {k: res[k] for k in ("final_error_m", "elapsed_s", "build_s", "misses",
                               "scenarios", "steps")}
    out["launches"] = read_counters()
    out["finite"] = bool(torch.isfinite(res["history"].u_phys).all())
    log("demo --batch: " + json.dumps(out))
    log(f"demo --batch {DEMO_BATCH} (duration cut from {full} s to {DEMO_DURATION} s): "
        f"{out['misses']} cache misses through the pipeline, scenarios built in "
        f"{out['build_s']:.2f} s; {out['steps']} steps in {out['elapsed_s']:.2f} s; "
        f"card: {card}")
    check(out["finite"] and out["scenarios"] == DEMO_BATCH,
          f"demo --batch: {out}")
    check(all(v == 0 for v in out["launches"].values()),
          f"demo --batch: the per-scenario path launched a kernel: {out['launches']}")
    return out


def accuracy_phase(device, card: str, check) -> dict:
    """8d: the accuracy harness for ACC_STEPS steps on the card, with the
    gates that step count reaches (ft_mpc_torch.benchmarks.accuracy)."""
    from ft_mpc_torch.benchmarks import accuracy

    zero_counters()
    res = accuracy.main(steps=ACC_STEPS, device=device)
    launches = read_counters()
    keep = ("same_state_max_dev_N", "lanes_same_state_max_dev_N", "closed_loop_max_dev_N",
            "chaos_floor_N", "golden_step_ms", "fast_step_ms", "lanes_step_ms",
            "failed_gates")
    log(f"accuracy ({ACC_STEPS} steps of the harness's {accuracy.STEPS}): "
        + json.dumps({k: res[k] for k in keep}) + f"; launches {launches}; card: {card}")
    check(not res["failed_gates"], f"accuracy gates: {res['failed_gates']}")
    check(all(launches[k] > 0 for k in CONDENSED_KERNELS),
          f"accuracy: the lanes leg launched no kernel of {CONDENSED_KERNELS}: {launches}")
    return res


def lanes_b1_phase(device, card: str, check) -> list:
    """8e: the whole lanes step at B=1 (the accuracy harness's lanes leg:
    cleanup K=1 over 4 rounds) from the demo's state, LANES_B1_STEPS chained
    steps on the card with the launch counters zeroed before and read after;
    each step also taken by the CPU port from the card's state and warm
    start (wrench within TOL_STEP_U, u_phys on a same-branch row, a flip only
    on a threshold); then kernels 1-3 held against their plain versions on
    the last step's own inputs."""
    from torch.utils._pytree import tree_map

    from ft_mpc_torch.benchmarks import accuracy
    from ft_mpc_torch.examples.sim import demo_x0
    from ft_mpc_torch.ops.dynamics import robot_step

    _, _, lanes = accuracy.configs()
    ctxs = []
    for dev in (device, torch.device("cpu")):
        _, sc, *_ = accuracy.setup(dev, torch.float32)
        c = Ctx(dev, torch.float32, 1, x0=demo_x0()[None], bank=tree_map(lambda x: x[None], sc))
        c.cfg = lanes
        ctxs.append(c)
    g, c = ctxs
    zero_counters()
    warm = g.init()
    res = {"wrench_err": [], "u_err": [], "branch_flips": 0, "flips_off_threshold": 0,
           "finite": True}
    for _ in range(LANES_B1_STEPS):
        out = g.step(warm)
        c.x0 = g.x0.cpu()
        ref = c.step(type(warm)(*(None if t is None else t.cpu() for t in warm)))
        same = bool((out.alloc.was_clipped.cpu() == ref.alloc.was_clipped).all()
                    and (out.alloc.used_fallback.cpu() == ref.alloc.used_fallback).all())
        res["wrench_err"].append(float((out.wrench.cpu() - ref.wrench).abs().max()))
        res["u_err"].append(float((out.u_phys.cpu() - ref.u_phys).abs().max()) if same else 0.0)
        res["branch_flips"] += int(not same)
        res["flips_off_threshold"] += int(not bool(flip_on_threshold(g, out, ref).all()))
        res["finite"] &= bool(torch.isfinite(out.u_phys).all() and torch.isfinite(out.warm.X).all())
        last_x0, last_warm, last_out = g.x0, warm, out
        g.x0 = robot_step(g.params, g.bank.fault, g.x0, out.u_phys)
        warm = g.sp.shift_warmstart(out.warm, g.sp.robot_to_center(g.bank.r, g.x0))
    sync(device)
    res["launches"] = read_counters()
    log("lanes step at B=1, card vs CPU port: " + json.dumps(res))
    want = {"condense_lanes": 6 * LANES_B1_STEPS + 1, "admm_lanes": 10 * LANES_B1_STEPS,
            "allocate_thrusters_lanes": LANES_B1_STEPS}
    check({k: res["launches"][k] for k in want} == want,
          f"lanes step at B=1: launches {res['launches']}, expected {want} "
          "(2 + 4 cleanup rounds, 2 + 4 x 2, 1 a step; the warm start condenses once)")
    check(res["finite"] and max(res["wrench_err"]) <= TOL_STEP_U
          and max(res["u_err"]) <= TOL_STEP_U and res["flips_off_threshold"] == 0,
          f"lanes step at B=1: the card's step differs from the CPU port's: {res}")

    g.x0 = last_x0
    rows = [check_condense(g, last_warm),
            check_admm(g, admm_inputs(g, last_warm, g.weights), lanes.admm.iters,
                       "lanes B=1", reps=5),
            check_admm(g, admm_inputs(g, last_warm, g.weights), lanes.cleanup_iters,
                       "lanes B=1 cleanup", reps=3),
            time_alloc_main(g, last_out, "lanes step")]
    for r in rows:
        log("kernel (lanes step at B=1): " + json.dumps(with_share(r)))
        if r["name"] == "allocate_thrusters_lanes":
            continue  # held below, by the C1 rule
        ok = (r["max_abs_err"] <= r["tol"]) if "tol" in r else (r["max_rel_err"] <= r["tol_rel"])
        check(ok and np.isfinite(r["max_abs_err"]),
              f"{r['name']} ({r['shape']}) disagrees with its plain version")
    am = check_alloc_main(g, last_out)
    log("alloc on the lanes step's wrench at B=1: " + json.dumps(am))
    check(am["u_err"] <= TOL_ALLOC_MAIN and am["hull_flips_off_threshold"] == 0
          and all(e > FALLBACK_EQ_ERR / 2 for e in am["fallback_flips_kept_eq_err"]),
          f"allocation kernel disagrees with its plain version at B=1: {am}")
    return rows


def kkt_phase(device, card: str, check) -> dict:
    """8f: `kkt_residuals` on the card (float64) at a converged per-scenario
    solution: tests/test_certify.py:24-61's problem and gates."""
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.controllers import spiraling as sp
    from ft_mpc_torch.controllers.certify import kkt_residuals
    from ft_mpc_torch.examples.sim import demo_x0
    from ft_mpc_torch.ops.dynamics import BodyParams
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    f64 = torch.float64
    params = BodyParams.default(0.1, dtype=f64, device=device)
    sc = build_scenario_with_terminal(params, [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)],
                                      DEFAULT_TUNING, terminal_mode="quadratic", device=device,
                                      dtype=f64)
    w = sp.MPCWeights.from_diagonals(Q_DIAG, R_DIAG, dtype=f64, device=device)
    traj = generate_trajectory("hover", 0.1, 30)
    xr, ur = prepare_center_trajectory(traj, sc.omega_des.cpu().numpy(), 16.8, 0.1, 16)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=device)
    xr, ur = t(xr[:16]), t(ur[:16])
    c0 = sp.robot_to_center(sc.r, t(demo_x0()))
    cfg = sp.MPCConfig(horizon=15, sqp_iters=20,
                       admm=StructuredADMMConfig(iters=100, phases=4, rho=50.0))
    point, _ = sp.sqp_solve(params, sc, w, cfg, c0, xr, ur,
                            sp.init_warmstart(params, sc, cfg, c0))
    t0 = time.perf_counter()
    res = kkt_residuals(params, sc, w, cfg, c0, xr, ur, point)
    sync(device)
    out = {f: float(getattr(res, f)) for f in res._fields}
    out["ms"] = 1e3 * (time.perf_counter() - t0)
    log(f"kkt_residuals on the card (float64): {json.dumps(out)}; card: {card}")
    check(out["defect"] < 1e-6 and out["hull_violation"] < 1e-5
          and out["term_violation"] < 1e-5 and out["stationarity"] < 0.5,
          f"kkt_residuals: {out}")
    return out


def drive_slice_api(device, card: str, check) -> list:
    """Section 8; returns kernel rows of the lanes step at B=1 (printed, not
    in the kernels line)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        pipeline_phase(device, card, check, tmp)
        api_phase(device, card, check, tmp)
        demo_batch_phase(device, card, check, tmp)
    rows = lanes_b1_phase(device, card, check)
    kkt_phase(device, card, check)
    accuracy_phase(device, card, check)
    return rows


# ---------------------------------------------------------------------------
# section 9: scenario sharding (ft_mpc_torch/parallel) and the planar family
# ---------------------------------------------------------------------------


def sharded_steps(ctx: Ctx, mesh, warmup: int, steps: int):
    """`sharded_init_warmstart` + warmup + steps chained
    `sharded_control_step_lanes` on ctx's bank, states and configuration,
    with the launch counters zeroed just before and read just after.
    Returns (numbers, the last step's incoming warm start, output, metrics)."""
    from ft_mpc_torch.parallel import mesh as pm

    sc = pm.shard_scenario_batch(mesh, ctx.bank)
    x0 = pm.shard_scenario_batch(mesh, ctx.x0)
    zero_counters()
    c0 = pm.map_shards(mesh, lambda b, x: ctx.sp.robot_to_center(b.r, x), (sc, x0))
    warm = pm.sharded_init_warmstart(mesh, ctx.params, sc, ctx.weights, ctx.cfg, c0,
                                     ctx.x_ref, ctx.u_ref)
    samples = []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        out, metrics = pm.sharded_control_step_lanes(mesh, ctx.params, sc, ctx.weights,
                                                     ctx.cfg, x0, ctx.x_ref, ctx.u_ref, warm)
        sync(ctx.device)
        if i >= warmup:
            samples.append(1e3 * (time.perf_counter() - t0))
        prev, warm = warm, out._replace(shards=tuple(o.warm for o in out.shards))
    launches = read_counters()
    n = warmup + steps
    want = {k: m * n * mesh.size + (k == "condense_lanes") * mesh.size
            for k, m in LOOP_LAUNCHES.items()}
    want.update(riccati_bwd_lanes=0, riccati_fwd_lanes=0, riccati_prepare_lanes=0)
    res = {"shards": mesh.size, "B": len(ctx.bank.r), "steps": n,
           "p50_ms": float(np.percentile(samples, 50)),
           "p99_ms": float(np.percentile(samples, 99)),
           "launches": launches, "launches_expected": want,
           "mean_cost": float(metrics.mean_cost), "max_r_prim": float(metrics.max_r_prim),
           "max_term_gap": float(metrics.max_term_gap)}
    res["solves_per_s"] = res["B"] * 1e3 / res["p50_ms"]
    return res, prev, out, metrics


class CleanupRows:
    """Records the rows the worst-K cleanup takes (`spiraling.take_rows`,
    which the condensed step calls only there) for the length of a block."""

    def __enter__(self):
        from ft_mpc_torch.controllers import spiraling as sp

        self.sp, self.real, self.rows = sp, sp.take_rows, []

        def wrapped(bank, idx):
            self.rows.append(idx.detach().cpu())
            return self.real(bank, idx)

        sp.take_rows = wrapped
        return self

    def __exit__(self, *exc):
        self.sp.take_rows = self.real


def shards_vs_own(ctx: Ctx, prev, out) -> dict:
    """Each shard of the last sharded step against `get_control_batch` on
    that shard's own rows from the same warm start (the same calls on the
    same card), the rows its cleanup took (global row numbers) and its
    whole-batch exact refactors (`newton_kinv` rescues)."""
    from ft_mpc_torch.solvers.lanes_qp import newton_kinv

    per = len(ctx.bank.r) // len(out.shards)
    err = {"u_phys": 0.0, "wrench": 0.0, "warm": 0.0}
    cleaned, rescues = [], []
    for i, shard in enumerate(out.shards):
        rows = torch.arange(i * per, (i + 1) * per, device=ctx.device)
        bank = ctx.sp.take_rows(ctx.bank, rows)
        n0 = newton_kinv.rescues
        with CleanupRows() as rec:
            own = ctx.sp.get_control_batch(ctx.params, bank, ctx.weights, ctx.cfg,
                                           ctx.x0[rows], ctx.x_ref, ctx.u_ref, prev.shards[i])
        rescues.append(newton_kinv.rescues - n0)
        cleaned += [int(r) + i * per for idx in rec.rows for r in idx]
        for name in ("u_phys", "wrench"):
            d = float((getattr(shard, name) - getattr(own, name)).abs().max())
            err[name] = max(err[name], d)
        for a, b in zip(shard.warm, own.warm):
            if a is not None:
                err["warm"] = max(err["warm"], float((a - b).abs().max()))
    return {"max_abs_diff": err, "cleanup_rows": sorted(cleaned), "rescues": rescues}


def metrics_of(out) -> dict:
    """The JAX package's reductions of a sharded output: the mean of the
    shards' means, the maxima of r_prim and term_gap."""
    infos = [o.info for o in out.shards]
    return {"mean_cost": float(torch.stack([i.cost.mean() for i in infos]).mean()),
            "max_r_prim": max(float(i.r_prim.max()) for i in infos),
            "max_term_gap": max(float(i.term_gap.max()) for i in infos)}


def check_sharded(label: str, res: dict, out, metrics, check) -> None:
    got = {"mean_cost": float(metrics.mean_cost), "max_r_prim": float(metrics.max_r_prim),
           "max_term_gap": float(metrics.max_term_gap)}
    want = metrics_of(out)
    log(f"{label}: StepMetrics {got}, reductions of the outputs {want}")
    check(abs(got["mean_cost"] - want["mean_cost"]) <= 1e-6 * abs(want["mean_cost"])
          and got["max_r_prim"] == want["max_r_prim"]
          and got["max_term_gap"] == want["max_term_gap"],
          f"{label}: StepMetrics {got} are not the reductions of the outputs {want}")
    check(res["launches"] == res["launches_expected"],
          f"{label}: launches {res['launches']}, expected {res['launches_expected']} "
          "(3 / 5 / 1 a step per shard and each shard's warm start condensing)")
    u = metrics.u_phys.gather()
    check(bool(torch.isfinite(u).all()) and u.shape == (res["B"], 16),
          f"{label}: u_phys {tuple(u.shape)} not finite")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_launches(cmds: list, timeout: float) -> list:
    """Start every command (from the checkout's root), wait for each; kill
    what is left on a timeout.  Returns (rc, stdout, stderr) per command."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    res = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n(killed after {timeout} s)"
            res.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def launch_phase(check, tmp: Path) -> dict:
    """9c: `python -m ft_mpc_torch.parallel.launch` in subprocesses (the
    kernels are built already, in build/): (i) a NCCL world of one with two
    shards of BATCH / 2 rows on the card, (ii) two processes on the one card
    over gloo, BATCH / 2 rows each, (iii) a NCCL world of one with one shard
    of BATCH; each --reps LAUNCH_REPS --dump.  (ii)'s gathered outputs equal
    (i)'s."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"launch: compute mode {mode!r} (two processes on one card need 'Default')")
    base = [sys.executable, "-m", "ft_mpc_torch.parallel.launch", "--reps",
            str(LAUNCH_REPS)]
    half = BATCH // 2
    world = lambda port, n, i: ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                                str(n), "--process-id", str(i)]
    runs = {
        "i": [base + ["--backend", "nccl", "--per-device", str(half), "--devices",
                      "cuda:0,cuda:0", "--dump", str(tmp / "i.npz"),
                      *world(free_port(), 1, 0)]],
        "ii": (lambda port: [base + ["--backend", "gloo", "--per-device", str(half),
                                     "--devices", "cuda:0", "--dump", str(tmp / "ii.npz"),
                                     *world(port, 2, i)] for i in (0, 1)])(free_port()),
        "iii": [base + ["--backend", "nccl", "--per-device", str(BATCH), "--dump",
                        str(tmp / "iii.npz"), *world(free_port(), 1, 0)]],
    }
    lines = {}
    for name, cmds in runs.items():
        t0 = time.perf_counter()
        results = run_launches(cmds, LAUNCH_TIMEOUT)
        wall = time.perf_counter() - t0
        bad = [(rc, err[-3000:]) for rc, _, err in results if rc != 0]
        check(not bad, f"launch ({name}) failed (compute mode {mode!r}): {bad}")
        js = [ln for ln in results[0][1].splitlines() if ln.startswith("{")]
        if not bad and js:
            lines[name] = json.loads(js[-1])
            log(f"launch ({name}), {len(cmds)} process(es), {wall:.1f} s wall: {js[-1]}")
    want = {"i": (1, 2, BATCH), "ii": (2, 2, BATCH), "iii": (1, 1, BATCH)}
    for name, line in lines.items():
        got = (line["processes"], line["devices"], line["global_batch"])
        check(got == want[name] and line["max_term_gap"] <= GAP_GATE,
              f"launch ({name}): (processes, devices, global_batch) {got}, expected "
              f"{want[name]}; max_term_gap {line['max_term_gap']}")
    if "i" in lines and "ii" in lines:
        a, b = np.load(tmp / "i.npz"), np.load(tmp / "ii.npz")
        du = float(np.abs(a["u_phys"] - b["u_phys"]).max())
        dw = float(np.abs(a["wrench"] - b["wrench"]).max())
        rel = {k: abs(float(a[k]) - float(b[k])) / max(abs(float(a[k])), 1e-30)
               for k in ("mean_cost", "max_r_prim", "max_term_gap")}
        log(f"launch: 2 processes (gloo) against 1 (NCCL) on the same 2 shards: max |du| "
            f"{du:.3e}, |dwrench| {dw:.3e} N (tol {TOL_PROCS}); metrics rel {rel}")
        check(a["u_phys"].shape == b["u_phys"].shape == (BATCH, 16)
              and du <= TOL_PROCS and dw <= TOL_PROCS
              and all(v <= TOL_PROCS for v in rel.values()),
              f"launch: 2 processes differ from 1: {du}, {dw}, {rel}")
    return lines


def planar_x0(B: int) -> np.ndarray:
    """Seeded planar states: positions in +-1 m and velocities in +-0.3 m/s
    in the plane, a random yaw, yaw rates in +-0.3 rad/s (bench.py's ranges
    with the out-of-plane components at 0)."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), dtype=np.float32)
    x0[:, 0:2] = rng.uniform(-1, 1, (B, 2))
    x0[:, 3:5] = rng.uniform(-0.3, 0.3, (B, 2))
    yaw = rng.uniform(-np.pi, np.pi, B)
    x0[:, 8], x0[:, 9] = np.sin(yaw / 2), np.cos(yaw / 2)
    x0[:, 12] = rng.uniform(-0.3, 0.3, B)
    return x0


def planar_phase(device, card: str, check, tmp: Path) -> list:
    """9e: the planar model family on the card, float32."""
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.controllers import spiraling as sp
    from ft_mpc_torch.geometry.scenario import stack_scenarios
    from ft_mpc_torch.models.planar import planar_body_params, planar_fault
    from ft_mpc_torch.sim import env
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    plant = planar_body_params(0.1, torch.float32, device)
    mass = float(plant.mass)
    scs = []
    for idx in PLANAR_PATTERNS:
        t0 = time.perf_counter()
        sc = build_scenario_with_terminal(plant, planar_fault([BrokenThruster(i, 1.0)
                                                                for i in idx]),
                                          DEFAULT_TUNING, cache_dir=tmp, device=device)
        sync(device)
        log(f"planar {idx or 'healthy'}: a miss of an empty cache, built in "
            f"{time.perf_counter() - t0:.3f} s host; hull facets F="
            f"{int(sc.hull_mask.sum())} of {sc.hull_mask.shape[0]}, terminal rows "
            f"{int(sc.term_mask.sum())}")
        scs.append(sc)
    bank = stack_scenarios(scs, device=device, dtype=torch.float32).scenarios
    ctx = Ctx(device, torch.float32, BATCH, x0=planar_x0(BATCH), bank=bank, params=plant,
              mass=mass)
    res, warm, out = drive_main_path(ctx, PORT_WARMUP, PORT_STEPS)
    res["max_absent_u"] = float(out.u_phys[:, 8:].abs().max())
    log("planar bank: " + json.dumps(res))
    log(f"planar bank (B={BATCH}, Nt={HORIZON}, {PORT_WARMUP}+{PORT_STEPS} steps): p50 "
        f"{res['p50_ms']:.3f} ms, max_r_prim {res['max_r_prim']:.3e}, max_term_gap "
        f"{res['max_term_gap']:.5f}, thrusters 8-15 at most {res['max_absent_u']:.3e} N; "
        f"card: {card}")
    check(res["finite"], "planar bank: non-finite outputs")
    check(res["max_absent_u"] <= 1e-6,
          f"planar bank: an absent thruster commanded {res['max_absent_u']}")
    check(res["max_term_gap"] <= GAP_GATE,
          f"planar bank: max_term_gap {res['max_term_gap']} > {GAP_GATE}")
    n = PORT_WARMUP + PORT_STEPS
    want = {k: m * n + (k == "condense_lanes") for k, m in LOOP_LAUNCHES.items()}
    want.update(riccati_bwd_lanes=0, riccati_fwd_lanes=0, riccati_prepare_lanes=0)
    check(res["launches"] == want, f"planar bank: launches {res['launches']}, expected {want}")

    rows = [check_condense(ctx, warm),
            check_admm(ctx, admm_inputs(ctx, warm, ctx.weights), ctx.cfg.admm.iters,
                       "planar T=64")]
    rows.append(time_alloc_main(ctx, out, "planar"))
    for r in rows:
        r["shape"] = f"planar bank: {r['shape']}"
        r["launches"] = res["launches"][r["name"]]
        log("kernel: " + json.dumps(with_share(r)))
    for r in rows[:2]:
        ok = (r["max_abs_err"] <= r["tol"]) if "tol" in r else (r["max_rel_err"] <= r["tol_rel"])
        check(ok and np.isfinite(r["max_abs_err"]),
              f"{r['name']} ({r['shape']}) disagrees with its plain version")
    hold_alloc_main(ctx, out, "planar", check)

    small = torch.arange(PLANAR_SMALL, device=device)
    step = card_vs_cpu(device, ctx.x0[small].cpu().numpy(),
                       bank=ctx.sp.take_rows(ctx.bank, small), params=plant, mass=mass)
    log(f"planar bank, whole step card vs CPU port ({step['rows']} rows, float32): "
        f"max |dwrench| {step['wrench_err']:.3e}, max |du_phys| {step['u_err']:.3e} "
        f"(tol {TOL_STEP_U}) on the rows whose allocation took the same branches; "
        f"{step['branch_rows']} rows on a branch threshold")
    check(step["finite"] and step["wrench_err"] <= TOL_STEP_U
          and step["u_err"] <= TOL_STEP_U and step["branch_rows"] <= step["rows"] // 8,
          f"planar bank: card step differs from the CPU port: {step}")
    del ctx, warm, out

    # tests/test_planar.py:56-86 on the card: (6), Nt=12, 2 SQP iterations
    sc6 = scs[PLANAR_PATTERNS.index((6,))]
    traj = generate_trajectory("hover", 0.1, 20)
    xr, ur = prepare_center_trajectory(traj, sc6.omega_des.cpu().numpy(), mass, 0.1, 13)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    x0 = np.zeros(13)
    x0[0:2] = [0.5, -0.3]
    x0[9] = 1.0
    w = sp.MPCWeights.from_diagonals(Q_DIAG, R_DIAG, dtype=torch.float32, device=device)
    zero_counters()
    t0 = time.perf_counter()
    hist = env.rollout(plant, sc6, w, sp.MPCConfig(horizon=12, sqp_iters=2),
                       env.SimConfig(steps=PLANAR_LOOP, noise_mode="none"), t(x0), t(xr),
                       t(ur))
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counters()
    s = hist.state.double()
    err = torch.linalg.vector_norm((hist.c0[:, 0:2] - hist.x_ref0[:, 0:2]).double(), dim=1)
    loop = {"steps": PLANAR_LOOP, "ms_per_step": 1e3 * wall / PLANAR_LOOP,
            "max_abs_z": float(s[:, 2].abs().max()),
            "max_abs_roll_pitch_rate": float(s[:, 10:12].abs().max()),
            "orbit_centre_error_ratio": float(err[-1] / err[0]),
            "max_absent_u": float(hist.u_phys[:, 8:].abs().max()),
            "finite": bool(torch.isfinite(s).all()), "launches": launches}
    log("planar hover (per-scenario rollout, (6), Nt=12, 2 SQP iterations, no noise; "
        "drift and error ratio not gated): " + json.dumps(loop))
    check(loop["finite"] and loop["max_absent_u"] <= 1e-6,
          f"planar hover: absent thrusters commanded {loop['max_absent_u']} (or not finite)")
    return rows


def drive_sharding(device, card: str, check, main_p50: float) -> None:
    """Section 9: the sharded lanes step on one and two shards, the launch
    entry point in subprocesses, the dry run and the planar model family."""
    import tempfile

    from ft_mpc_torch.parallel import mesh as pm
    from ft_mpc_torch.parallel.dryrun import dryrun_multichip
    from ft_mpc_torch.sim import env
    from ft_mpc_torch.solvers.lanes_qp import admm_lanes, newton_kinv

    mesh1 = pm.make_scenario_mesh()
    log(f"9a: make_scenario_mesh() lists {mesh1.size} CUDA device(s): {mesh1.devices}")
    ctx = Ctx(device, torch.float32, BATCH)
    res, prev, out, metrics = sharded_steps(ctx, mesh1, PORT_WARMUP, PORT_STEPS)
    own = shards_vs_own(ctx, prev, out)
    log("9a, one shard per device: " + json.dumps({**res, **own, "cleanup_rows": len(
        own["cleanup_rows"])}))
    log(f"9a: p50 {res['p50_ms']:.3f} ms (section 2's p50 {main_p50:.3f} ms), "
        f"{res['solves_per_s']:.1f} solves/s; against get_control_batch on the same "
        f"inputs: max |diff| {own['max_abs_diff']}; card: {card}")
    check_sharded("9a", res, out, metrics, check)
    check(all(v == 0.0 for v in own["max_abs_diff"].values()),
          f"9a: the sharded step differs from get_control_batch: {own['max_abs_diff']}")
    del prev, out, metrics

    mesh2 = pm.make_scenario_mesh([device, device])
    res, prev, out, metrics = sharded_steps(ctx, mesh2, PORT_WARMUP, PORT_STEPS)
    own = shards_vs_own(ctx, prev, out)
    log("9b, two shards on the one card: " + json.dumps({**res, "max_abs_diff":
                                                          own["max_abs_diff"]}))
    log(f"9b: p50 {res['p50_ms']:.3f} ms (section 2's p50 {main_p50:.3f} ms), "
        f"{res['solves_per_s']:.1f} solves/s; each shard against get_control_batch on "
        f"its own rows: max |diff| {own['max_abs_diff']} (tol {SHARD_TOL} N)")
    check_sharded("9b", res, out, metrics, check)
    check(own["max_abs_diff"]["u_phys"] <= SHARD_TOL
          and own["max_abs_diff"]["wrench"] <= SHARD_TOL,
          f"9b: a shard differs from get_control_batch on its rows: {own['max_abs_diff']}")
    # not gated: the same last step unsharded; the worst-K cleanup is per shard
    n0 = newton_kinv.rescues
    with CleanupRows() as rec:
        whole = ctx.step(prev.gather())
    whole_rescues = newton_kinv.rescues - n0
    one = sorted(int(r) for idx in rec.rows for r in idx)
    du = (whole.u_phys - metrics.u_phys.gather()).abs().amax(dim=1).cpu()
    moved = set(np.flatnonzero(du.numpy() > SHARD_TOL).tolist())
    only = set(one) ^ set(own["cleanup_rows"])
    log(f"9b against the unsharded B={BATCH} step from the same warm start (not gated): "
        f"cleanup took {len(one)} rows unsharded, {len(own['cleanup_rows'])} sharded "
        f"(K={ctx.cfg.cleanup_k} per shard), {len(only)} rows in one and not the other; "
        f"{len(moved)} rows differ by more than {SHARD_TOL} N, {len(moved & only)} of them "
        f"among those; max |du| {float(du.max()):.3e} N; newton_kinv rescues "
        f"{whole_rescues} unsharded, {own['rescues']} per shard")
    del prev, out, metrics, whole

    sim = env.SimConfig(steps=SHARD_ROLLOUT, noise_mode="reference")
    gens = [torch.Generator(device=device).manual_seed(i) for i in range(mesh2.size)]
    zero_counters()
    with StepRecorder("get_control_batch", device) as rec:
        hist = pm.sharded_rollout_lanes(mesh2, ctx.params, ctx.bank, ctx.weights, ctx.cfg,
                                        sim, ctx.x0, ctx.x_ref_full, ctx.u_ref_full,
                                        gens).gather()
    roll = history_stats(hist, rec, ctx.bank.u_ub)
    roll["launches"] = read_counters()
    log("9b, sharded_rollout_lanes (2 shards, one seeded generator each, 'reference' "
        "noise): " + json.dumps(roll))
    check(roll["finite"], "9b rollout: history not finite")
    check(roll["u_below_0"] <= 1e-6 and roll["u_above_ub"] <= 1e-6,
          f"9b rollout: u_phys outside [0, u_ub] by {roll['u_below_0']}, {roll['u_above_ub']}")
    check(roll["max_broken_u"] <= 1e-6,
          f"9b rollout: a broken thruster commanded {roll['max_broken_u']}")
    want = {k: m * SHARD_ROLLOUT * 2 + (k == "condense_lanes") * 2
            for k, m in LOOP_LAUNCHES.items()}
    got = {k: roll["launches"][k] for k in want}
    check(got == want, f"9b rollout: launches {got}, expected {want}")
    del ctx, hist
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        launch_phase(check, Path(d))

    zero_counters()
    t0 = time.perf_counter()
    try:
        dr = dryrun_multichip(2, device="cuda")
    except AssertionError as e:
        dr = None
        check(False, f"9d: dryrun_multichip(2) failed: {e}")
    launches = read_counters()
    log(f"9d: dryrun_multichip(2, cuda) in {time.perf_counter() - t0:.1f} s: {dr}; "
        f"launches {launches}, ADMM by design {admm_lanes.launches_by_design} (the boxed "
        "leg's T=216 runs the cluster design)")
    check(all(launches[k] > 0 for k in CONDENSED_KERNELS),
          f"9d: a kernel of the condensed path never launched: {launches}")

    with tempfile.TemporaryDirectory() as d:
        planar_phase(device, card, check, Path(d))


# ---------------------------------------------------------------------------
# section 10: the condensed step with the state box and rate rows
# ---------------------------------------------------------------------------


def drive_boxed(device, card: str, check) -> dict:
    """Section 10: section 2's condensed configuration at B=2048 with
    `box_weights` (T=596), BOX_WARMUP + BOX_STEPS chained steps with the
    counters zeroed before and read after; launches 3 / 5 / 1 a step with
    every ADMM launch in the cluster design; the ADMM kernel held against its
    plain version on the path's last QP (60 iterations) and on its worst 256
    rows (the cleanup's 600 iterations), each timed beside its bound; the
    allocation kernel on the path's wrenches; one whole step on BOX_SMALL
    rows three ways (BOX_STATES_NOTE).  Returns the cluster design's kernel
    row at T=596."""
    from ft_mpc_torch.solvers.lanes_qp import admm_plan

    ctx = Ctx(device, torch.float32, BATCH, box=True)
    res, warm, out = drive_main_path(ctx, BOX_WARMUP, BOX_STEPS)
    res["box_excess"] = box_excess(out.warm.X)
    F, T = ctx.bank.hull_A.shape[1], out.warm.y_term.shape[1]
    plan = admm_plan(HORIZON, F, T)
    log("10, boxed path: " + json.dumps({**res, "admm_plan": plan}))
    log(f"10, boxed path (B={BATCH}, Nt={HORIZON}, T={T}, {BOX_WARMUP}+{BOX_STEPS} steps): "
        f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
        f"{res['solves_per_s']:.1f} solves/s, max_r_prim {res['max_r_prim']:.3e}, "
        f"max_term_gap {res['max_term_gap']:.5f}, largest planned velocity beyond the "
        f"{BOX_V} m/s box {res['box_excess']:.3e} m/s (none gated); ADMM {plan['design']} "
        f"design, {plan['cluster']} blocks a scenario, {plan['smem_bytes']} B a block, "
        f"{plan['max_active_clusters']} clusters at once; card: {card}")
    check(res["finite"], "10: non-finite outputs")
    check(res["u_shape"] == (BATCH, 16), f"10: u_phys shape {res['u_shape']}")
    check(T == 596, f"10: {T} dense rows, expected 64 + 2*13*14 + 2*6*14 = 596")
    n = BOX_WARMUP + BOX_STEPS
    want = {k: m * n + (k == "condense_lanes") for k, m in LOOP_LAUNCHES.items()}
    want.update(riccati_bwd_lanes=0, riccati_fwd_lanes=0, riccati_prepare_lanes=0)
    check(res["launches"] == want, f"10: launches {res['launches']}, expected {want} "
          "(3 / 5 / 1 a step and the warm start's condensing)")
    by = res["admm_launches_by_design"]
    check(by["cluster"] == 5 * n and sum(by.values()) == 5 * n,
          f"10: ADMM launches by design {by}, expected all {5 * n} in 'cluster'")

    c = ctx.cfg
    K = min(c.cleanup_k, BATCH)
    krows = [check_admm(ctx, admm_inputs(ctx, warm, ctx.weights), c.admm.iters,
                        "boxed path T=596", reps=3),
             check_admm(ctx, admm_inputs(ctx, warm, ctx.weights,
                                         rows=torch.topk(out.info.r_prim, K).indices),
                        c.cleanup_iters, f"boxed cleanup K={K}", reps=3)]
    for r in krows:
        r["design"], r["cluster"] = plan["design"], plan["cluster"]
        log("kernel: " + json.dumps(with_share(r)))
        check(r["max_rel_err"] <= r["tol_rel"] and np.isfinite(r["max_abs_err"]),
              f"admm_lanes ({r['shape']}) disagrees with its plain version")
    hold_alloc_main(ctx, out, "boxed", check)

    # the whole step, three ways: the kernels against their plain versions on
    # the card and the card against the CPU port from the path's own states,
    # the card against the CPU port near the terminal sets (as section 2)
    path_x0 = ctx.x0[:BOX_SMALL].cpu().numpy()
    for label, x0, plain in (
            ("the path's states, kernels vs their plain versions on the card", path_x0, True),
            ("the path's states, card vs CPU port", path_x0, False),
            ("states near the terminal sets, card vs CPU port", gentle_x0(BOX_SMALL), False)):
        step = card_vs_cpu(device, x0, box=True, plain_on_card=plain, decisions=True,
                           f64=not plain)
        log(f"10, whole boxed step, {label} ({step['rows']} rows, float32): max "
            f"|dwrench| {step['wrench_err']:.3e} on every row, {step['wrench_err_kept']:.3e} "
            f"on the rows whose decisions agreed; max |du_phys| {step['u_err_kept']:.3e} "
            f"there on the same allocation branches (tol {TOL_STEP_U}); rows whose ADMM "
            f"rho freeze or step length went differently {step['split_rows']}, "
            f"{step['branch_rows']} on an allocation branch, {step['off_rows']} on a "
            f"threshold in all; rows beyond the tolerance {step['rows_beyond_tol']}; "
            f"velocity beyond the box {step['box_excess_card_cpu']} m/s; max |dwrench| "
            f"from the CPU port in float64 {step.get('wrench_err_vs_f64', '-')}")
        log("10, " + label + ": " + json.dumps(step))
        check(step["finite"], f"10: card step is not finite ({label})")
        check(step["wrench_err_kept"] <= TOL_STEP_U and step["u_err_kept"] <= TOL_STEP_U
              and step["off_rows"] <= step["rows"] // 4,
              f"10: boxed card step differs ({label}): {step}")
    log("10: " + BOX_STATES_NOTE)
    row = dict(krows[0])
    row["name"] = "admm_lanes (cluster design, T=596)"
    row["launches"] = by["cluster"]
    return row


def drive_stagewise(device, card: str, check, profiles: list | None = None) -> list:
    """Section 5: the stagewise path, its Riccati sweeps and allocation
    kernels held, two chained steps card vs CPU; returns the kernel rows of
    the main run's line (the sweeps and their preparation at B=512 and at the
    cleanup's B)."""
    sw = Ctx(device, torch.float32, SW_BATCH, stagewise_horizon=SW_HORIZON)
    sw_res, sw_warm, sw_out = drive_main_path(sw, SW_WARMUP, SW_STEPS)
    log("stagewise path: " + json.dumps(sw_res))
    log(f"stagewise path (B={SW_BATCH}, Nt={SW_HORIZON}): p50 {sw_res['p50_ms']:.3f} ms, "
        f"p99 {sw_res['p99_ms']:.3f} ms, {sw_res['solves_per_s']:.1f} solves/s, "
        f"max_r_prim {sw_res['max_r_prim']:.3e}, max_term_gap {sw_res['max_term_gap']:.3e}, "
        f"launches per step {sw_res['launches_per_step']} (not gated on time); card: {card}")
    check(sw_res["finite"], "stagewise path produced non-finite outputs")
    check(sw_res["u_shape"] == (SW_BATCH, 16), f"stagewise u_phys shape {sw_res['u_shape']}")
    check(sw_res["max_r_prim"] <= SW_R_PRIM_GATE,  # NaN fails the comparison too
          f"stagewise max_r_prim {sw_res['max_r_prim']} > {SW_R_PRIM_GATE}")
    check(sw_res["max_term_gap"] <= GAP_GATE,
          f"stagewise max_term_gap {sw_res['max_term_gap']} > {GAP_GATE}")
    zero = [k for k in STAGEWISE_KERNELS if sw_res["launches"][k] <= 0]
    check(not zero, f"kernels never launched on the stagewise path: {zero}")
    check(sw_res["launches"]["condense_lanes"] == 0 and sw_res["launches"]["admm_lanes"] == 0,
          "the stagewise path launched a kernel of the condensed path")
    hold_alloc_main(sw, sw_out, "stagewise", check)
    log("kernel: " + json.dumps(with_share(time_alloc_main(sw, sw_out, "stagewise path"))))
    if profiles is not None:
        profiles.append(profile_steps(sw, sw_warm, f"stagewise B={SW_BATCH} Nt={SW_HORIZON}", n=1))

    # the sweeps' launches: one backward and one forward sweep a re-solve,
    # both in one launch; one preparation a phase
    c = sw.cfg
    n_steps = SW_WARMUP + SW_STEPS
    phases = c.sqp_iters * c.stagewise.phases + c.cleanup_rounds * c.cleanup_phases
    resolves = (c.sqp_iters * c.stagewise.phases * c.stagewise.iters
                + c.cleanup_rounds * c.cleanup_phases * c.cleanup_iters)
    by = sw_res["riccati_launches_by_design"]
    kernel_launches = sum(by.values())
    sweeps = {
        "resolves_per_step": resolves, "phases_per_step": phases,
        "bwd_per_step": sw_res["launches"]["riccati_bwd_lanes"] / n_steps,
        "fwd_per_step": sw_res["launches"]["riccati_fwd_lanes"] / n_steps,
        "prepare_per_step": sw_res["launches"]["riccati_prepare_lanes"] / n_steps,
        "kernel_launches_per_resolve": kernel_launches / (resolves * n_steps),
        "by_design": by,
    }
    log("stagewise path, Riccati launches: " + json.dumps(sweeps))
    check(sw_res["launches"]["riccati_bwd_lanes"] == resolves * n_steps
          and sw_res["launches"]["riccati_fwd_lanes"] == resolves * n_steps
          and kernel_launches == resolves * n_steps,
          f"stagewise path: {resolves} re-solves a step, sweeps launched {sweeps}")
    check(sweeps["kernel_launches_per_resolve"] <= 2
          and sw_res["launches"]["riccati_prepare_lanes"] <= phases * n_steps,
          f"stagewise path: more than 2 launches a re-solve or 1 preparation a phase: {sweeps}")

    captured = capture_riccati(sw, sw_warm)
    check(sorted(captured) == sorted({SW_BATCH, sw.cfg.cleanup_k}),
          f"riccati sweeps ran at batch sizes {sorted(captured)}")
    K_cap = sw.cfg.cleanup_k
    shapes = [(SW_BATCH, "stagewise path"), (K_cap, "cleanup"),
              (RICCATI_SMALL, f"the cleanup's first {RICCATI_SMALL} rows")]
    sw_rows, sw_small = [], []
    for B_cap, label in shapes:
        args = captured.get(B_cap if B_cap != RICCATI_SMALL else K_cap)
        if args is None:
            continue
        if B_cap == RICCATI_SMALL:
            args = (type(args[0])(*(t[:B_cap] for t in args[0])),
                    *(t[:B_cap] for t in args[1:]))
        got = check_riccati(sw, *args, label)
        log(f"riccati plan at B={B_cap} Nt={SW_HORIZON}: {json.dumps(got[0]['plan'])}")
        (sw_small if B_cap == RICCATI_SMALL else sw_rows).extend(got)
    for r in sw_rows + sw_small:
        log("kernel: " + json.dumps(with_share(r)))
        check(r["max_rel_err"] <= r["tol_rel"] and np.isfinite(r["max_abs_err"])
              and r.get("pair_rel_err", 0.0) <= r["tol_rel"]
              and r.get("rel_err_vs_f64", 0.0) <= r.get("tol_rel_f64", 0.0),
              f"{r['name']} ({r['shape']}) disagrees with its plain version")
    for r in sw_rows:  # every launch on the path runs both sweeps (checked above)
        r["launches"] = (by[r["design"]] if r["name"] != "riccati_prepare_lanes"
                         else sw_res["launches"][r["name"]])
    del captured, sw_warm, sw_out

    B_small, Nt_small = SW_SMALL
    step = card_vs_cpu(device, long_horizon_x0(B_small), stagewise_horizon=Nt_small,
                       steps=SW_SMALL_STEPS)
    log(f"{SW_SMALL_STEPS} chained stagewise steps, card vs CPU port ({B_small} rows, "
        f"Nt={Nt_small}, float32): max |dwrench| {step['wrench_err']:.3e} (per step "
        f"{step['wrench_err_per_step']}), max |du_phys| {step['u_err']:.3e} "
        f"(tol {TOL_STEP_U}) on the rows whose allocation took the same branches; "
        f"at most {step['branch_rows']} rows on a branch threshold")
    check(step["finite"], "stagewise card step is not finite")
    check(step["wrench_err"] <= TOL_STEP_U and step["u_err"] <= TOL_STEP_U
          and step["branch_rows"] <= step["rows"] // 8,
          f"stagewise card step differs from the CPU port: {step}")

    return sw_rows


# ---------------------------------------------------------------------------
# section 11: the bench entry and the measuring scripts (ft_mpc_torch/benchmarks)
# ---------------------------------------------------------------------------


def launches_off(launches_per_step: dict, want: dict) -> dict:
    """{kernel: launches a step} of the kernels whose count is not `want`'s
    (0 where `want` does not name it)."""
    return {k: v for k, v in launches_per_step.items() if v != want.get(k, 0)}


def drive_bench_scripts(device, card: str, check) -> None:
    """Section 11: the bench entry, the envelope's two points, the 'scan'
    backend and the component profile as smoke runs, each record printed
    and gated.  Each script zeroes the launch counters just before its
    windows and reads them just after."""
    from ft_mpc_torch.benchmarks import bench, envelope, long_horizon, profile_step

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else None
    card = card if name else None  # the records' nvidia-smi line, None on the CPU
    rec = bench.main(device=device, windows=BENCH_WINDOWS)
    log("section 11, bench: " + json.dumps(rec))
    log(f"11a: bench (B={rec['batch']}, 1 + {rec['latency_windows']} windows of "
        f"{rec['steps_per_window']} chained steps): p50 {rec['latency_p50_ms']:.3f} ms, p99 "
        f"{rec['latency_p99_ms']:.3f} ms, {rec['value']:.1f} solves/s, meets the control "
        f"period: {rec['meets_control_period']}; gap rows {rec['gap_rows']}; card: {card}")
    missing = [k for k in BENCH_FIELDS if k not in rec]
    check(not missing, f"bench record lacks {missing}")
    check(not rec["failed_gates"], f"bench gates failed: {rec['failed_gates']}")
    check(rec["batch"] == BATCH and rec["latency_windows"] == BENCH_WINDOWS
          and rec["steps_per_window"] == 10 and rec["warmup_windows"] == 1
          and len(rec["latency_samples_ms"]) == BENCH_WINDOWS,
          f"bench ran {rec['batch']} rows, {rec['latency_windows']} windows")
    check(rec["card"] == name and rec["nvidia_smi"] == card and rec["device"] == str(device),
          f"bench record names {rec['card']!r} / {rec['nvidia_smi']!r}, not {name!r} / {card!r}")
    check(rec["finite"] and rec["u_shape"] == [BATCH, 16], "bench outputs not finite")
    check(rec["max_term_gap"] <= GAP_GATE, f"bench max_term_gap {rec['max_term_gap']}")
    check(set(rec["gap_rows"]) <= REFERENCE_GAP_ROWS,
          f"bench gap rows {rec['gap_rows']} outside {sorted(REFERENCE_GAP_ROWS)}")
    check(rec["meets_control_period"] == (rec["latency_p50_ms"] <= PERIOD_MS),
          "bench: meets_control_period disagrees with its p50")
    off = launches_off(rec["launches_per_step"], LOOP_LAUNCHES)
    check(not off, f"bench: launches a step other than 3 / 5 / 1: {off}")

    env = envelope.main(points=ENVELOPE_POINTS, reps=ENVELOPE_REPS, device=device)
    log("section 11, envelope: " + json.dumps(env))
    check(env["card"] == name and env["nvidia_smi"] == card, "envelope record: card")
    resolves = 2 * 60 + 300 * 2  # sqp_iters * iters + cleanup * 2 phases
    for row in env["points"]:
        label = f"envelope Nt={row['Nt']} {row['backend']} B={row['B']}"
        log(f"11b: {label}: {row['ms_per_step']:.3f} ms a step, {row['solves_per_s']:.1f} "
            f"solves/s, max_r_prim {row['max_r_prim']:.3e}, max_term_gap "
            f"{row['max_term_gap']:.3e}, meets 100 ms: {row['meets_100ms']}; card: {card}")
        check(row["max_r_prim"] <= SW_R_PRIM_GATE and row["max_term_gap"] <= GAP_GATE,
              f"{label}: max_r_prim {row['max_r_prim']}, max_term_gap {row['max_term_gap']}")
        per = row["launches_per_step"]
        if row["backend"] == "stagewise-lanes":
            by = sum(row["riccati_launches_by_design"].values()) / row["counted_steps"]
            check(per["riccati_bwd_lanes"] == per["riccati_fwd_lanes"] == by == resolves
                  and per["riccati_prepare_lanes"] == 4,
                  f"{label}: {by} re-solve launches and {per['riccati_prepare_lanes']} "
                  f"preparations a step, not {resolves} and 4: {per}")
            off = launches_off(per, {"riccati_bwd_lanes": resolves, "riccati_fwd_lanes":
                                     resolves, "riccati_prepare_lanes": 4,
                                     "allocate_thrusters_lanes": 1})
        else:  # long_horizon's cleanup runs 2 phases: one ADMM launch each
            off = launches_off(per, {"condense_lanes": 3, "admm_lanes": 4,
                                     "allocate_thrusters_lanes": 1})
        check(not off, f"{label}: launches a step {off}")

    # the 'scan' backend and stagewise-lanes run the same solver (the JAX
    # script's two backends read the same max_r_prim); after 1 + 1 steps from
    # the warm start the residual has not yet reached section 5's 1e-2 class
    # (both read 1.394e-2 on the CPU and on an H100 here), so the first is
    # held to the second, as tests/test_torch_spiraling.py holds r_prim
    nt, b = SCAN_POINT
    small = SimpleNamespace(sqp_iters=2, iters=60, cleanup=300, reps=1)
    scan = long_horizon.run(nt, "stagewise", b, small, device)
    lanes = long_horizon.run(nt, "stagewise-lanes", b, small, device)
    log("section 11, long_horizon 'scan': " + json.dumps(scan))
    log(f"11c: long_horizon.run Nt={nt} stagewise (mode 'scan') B={b}: "
        f"{scan['ms_per_step']:.3f} ms a step, max_r_prim {scan['max_r_prim']:.3e} "
        f"(stagewise-lanes {lanes['max_r_prim']:.3e}, {lanes['ms_per_step']:.3f} ms a "
        f"step), max_term_gap {scan['max_term_gap']:.3e}; card: {card}")
    check(abs(scan["max_r_prim"] - lanes["max_r_prim"])
          <= 1e-3 + 5e-2 * abs(lanes["max_r_prim"]) and scan["max_term_gap"] <= GAP_GATE,
          f"'scan' backend: max_r_prim {scan['max_r_prim']} (stagewise-lanes "
          f"{lanes['max_r_prim']}), max_term_gap {scan['max_term_gap']}")
    off = launches_off(scan["launches_per_step"], {"allocate_thrusters_lanes": 1})
    check(not off, f"'scan' backend: launches a step {off}")

    prof = profile_step.main(B=BATCH, reps=1, sweep=PROFILE_SWEEP, device=device)
    log("section 11, profile_step: " + json.dumps(prof))
    rows = prof["components"]
    bad = [k for k, v in rows.items() if k != "cleanup (b - b0)" and not all(
        (v[t] or 0) > 0 for t in ("host_ms", "event_ms"))]
    check(not bad, f"profile_step: components without host or event time: {bad}")
    # the full step's device time and peak memory; a component of a few ms
    # read no kernel time once in four profiler sessions on an H100
    full = {k: v for k, v in rows.items() if k.startswith(("(a)", "(h)"))}
    check(len(full) == 1 + len(PROFILE_SWEEP) and all(
        (v["device_busy_ms"] or 0) > 0 and v.get("peak_mem_bytes", 0) > 0
        for v in full.values()), f"profile_step: the full step's device time or peak "
          f"memory missing: {full}")
    check(prof["card"] == name and prof["nvidia_smi"] == card, "profile_step record: card")
    log(f"11d: profile_step's medians contradict: {prof['unresolved']}" if prof["unresolved"]
        else "11d: profile_step: every part reads at most what contains it")
    ms = lambda x: "not measured" if x is None else f"{x:.3f} ms"
    for k, v in rows.items():
        log(f"11d: {k}: host {ms(v['host_ms'])}, events {ms(v['event_ms'])}, device busy "
            f"{ms(v['device_busy_ms'])}, dispatch {ms(v['dispatch_ms'])}; card: {card}")


# ---------------------------------------------------------------------------
# section 12: the sanitizer, the census cache build and the scaling sweeps
# ---------------------------------------------------------------------------


def kernel_agrees(r: dict) -> bool:
    """A kernel row within its tolerance of its plain version."""
    tol = r.get("tol")
    ok = (r["max_abs_err"] <= tol) if tol is not None else (r["max_rel_err"] <= r["tol_rel"])
    return bool(ok and np.isfinite(r["max_abs_err"]) and r.get("branches_equal", True))


def sanitizer_phase(device, card: str, check) -> list:
    """12a: the sanitizer over the census (B=137, 4 windows of 50 steps, then
    the per-scenario rollout), its gates and launches; kernels 1-3 held and
    timed on the last batched step's inputs (and ADMM on its cleanup's
    rows at 300 iterations).  Returns the kernel rows."""
    from ft_mpc_torch.benchmarks import sanitizer

    s = sanitizer.inputs(device)
    try:
        rec = sanitizer.run(s)
    except sanitizer.NonFiniteError as e:
        check(False, f"sanitizer: {e}")
        return []
    log("section 12, sanitizer: " + json.dumps(rec))
    log(f"12a: sanitizer (B={rec['batch']}, {rec['steps']} steps): every history field "
        f"finite; contracting {rec['n_contracting_200_steps']} in 200 steps, "
        f"{rec['n_contracting_50_steps']} in 50; ratio min / median / max "
        f"{rec['contraction_200_min_med_max']}; max_term_gap_final "
        f"{rec['max_term_gap_final']:.3e}; a step p50 {rec['step_ms_p50']:.3f} ms, p99 "
        f"{rec['step_ms_p99']:.3f} ms; {rec['lanes_rollout_s']:.1f} s for the 200 steps, "
        f"{rec['per_scenario_rollout_s']:.1f} s for the per-scenario "
        f"{rec['per_scenario_steps']}; {rec['newton_rescues']} newton_kinv rescues "
        f"({rec['newton_rescues_nonfinite']} with a non-finite residual); "
        f"launches a step {rec['launches_per_step']}; card: {card}")
    check(not rec["failed_gates"], f"sanitizer gates failed: {rec['failed_gates']}")
    check(rec["batch"] == 137 and rec["steps"] == 200 and rec["all_finite"],
          f"sanitizer ran {rec['batch']} rows, {rec['steps']} steps")
    off = {k: v for k, v in rec["launches"].items() if v != rec["launches_expected"].get(k, 0)}
    check(not off, f"sanitizer: launches {off}, expected {rec['launches_expected']}")
    check(not any(rec["per_scenario_launches"].values()),
          f"sanitizer: the per-scenario rollout launched {rec['per_scenario_launches']}")
    check(rec["uncertified_patterns"] == UNCERTIFIED,
          f"sanitizer: uncertified patterns {rec['uncertified_patterns']}")

    last = s.last_step
    ctx = Ctx(device, torch.float32, rec["batch"], x0=last.x0.cpu().numpy(), bank=s.bank)
    ctx.cfg, ctx.x_ref, ctx.u_ref = s.cfg, last.x_ref, last.u_ref
    out = ctx.step(last.warm)  # the last step again, for its wrenches and residuals
    sync(device)
    k = s.cfg.cleanup_k
    rows = [check_condense(ctx, last.warm),
            check_admm(ctx, admm_inputs(ctx, last.warm, ctx.weights), s.cfg.admm.iters,
                       f"census B={rec['batch']} T=64"),
            check_admm(ctx, admm_inputs(ctx, last.warm, ctx.weights,
                                        rows=torch.topk(out.info.r_prim, k).indices),
                       s.cfg.cleanup_iters, f"census cleanup K={k}", reps=3),
            time_alloc_main(ctx, out, "census")]
    am = hold_alloc_main(ctx, out, "census", check)
    rows[-1].update(max_abs_err=am["u_err"], tol=TOL_ALLOC_MAIN)
    for r in rows:
        r["shape"] = f"sanitizer's last step: {r['shape']}"
        r["launches"] = rec["launches"][r["name"]]  # both ADMM shapes share the count
        log("kernel: " + json.dumps(with_share(r)))
        check(kernel_agrees(r), f"{r['name']} ({r['shape']}) disagrees with its plain version")
    return rows


def census_build_phase(device, card: str, check, tmp: Path) -> dict:
    """12b: the census cache build on CENSUS_BUILD into a temporary
    directory, every row against the committed entry; the committed cache
    untouched."""
    from ft_mpc_torch.api import TERMINAL_CACHE
    from ft_mpc_torch.benchmarks import build_terminal_cache
    from ft_mpc_torch.utils.faults import BrokenThruster

    before = {p.name: p.stat().st_mtime_ns for p in TERMINAL_CACHE.iterdir()}
    rec = build_terminal_cache.main(
        out_dir=tmp / "census_cache", device=device,
        patterns=[[BrokenThruster(i, 1.0) for i in p] for p in CENSUS_BUILD])
    log("section 12, census cache build: " + json.dumps(rec))
    for row in rec["rows"]:
        c = row["vs_committed"]
        log(f"12b: {row['pattern']}: {row['secs']:.3f} s on the host; certified "
            f"{row['certified']}, default orbit {row['orbit_default']}; committed entry "
            f"{'equal' if c['ok'] else 'DIFFERS'}; points decided otherwise "
            f"{c.get('grid_points_decided_otherwise')}; own fit {c['own_fit_rel_diff']:.3e}, "
            f"fit on the JAX run's points {c.get('fit_on_jax_points_rel_diff')}; card: {card}")
    check(not rec["failed_rows"], f"census cache build: rows differ from the committed "
          f"entries: {rec['failed_rows']}")
    counts = (rec["certified_default_orbit"], rec["certified_searched_orbit"],
              rec["uncertifiable"])
    check(counts == CENSUS_BUILD_COUNTS, f"census cache build: counts {counts}")
    check(rec["n_compared_with_jax_points"] == 3,
          f"census cache build: {rec['n_compared_with_jax_points']} grids against JAX's")
    check({p.name: p.stat().st_mtime_ns for p in TERMINAL_CACHE.iterdir()} == before,
          "census cache build: the committed cache changed")
    return rec


def scaling_phase(device, card: str, check) -> dict:
    """12c: the batch sweep at SWEEP_BATCHES with SWEEP_WINDOWS windows and
    the device sweep on 1 and 2 shards of the card, SWEEP_REPS steps each."""
    from ft_mpc_torch.benchmarks import scaling

    rec = scaling.main(batches=SWEEP_BATCHES, reps=SWEEP_REPS, windows=SWEEP_WINDOWS,
                       device=device)
    log("section 12, scaling: " + json.dumps(rec))
    for B, r in rec["batch_sweep"].items():
        log(f"12c: batch sweep B={B}: {r['solves_per_s']:.1f} solves/s, p50 "
            f"{r['ms_per_step']:.3f} ms, p99 {r['latency_p99_ms']:.3f} ms, max_r_prim "
            f"{r['max_r_prim']:.3e}; card: {card}")
        check(not r["failed_gates"], f"scaling B={B}: bench gates failed {r['failed_gates']}")
        off = launches_off(r["launches_per_step"], LOOP_LAUNCHES)
        check(not off, f"scaling B={B}: launches a step other than 3 / 5 / 1: {off}")
    rows = rec["device_sweep"]["results"]
    check([r["devices"] for r in rows][:1] == [["cuda:0"]]
          and ["cuda:0", "cuda:0"] in [r["devices"] for r in rows],
          f"scaling: meshes {[r['devices'] for r in rows]}")
    for r in rows:
        log(f"12c: device sweep {r['devices']}: {r['solves_per_s']:.1f} solves/s, "
            f"{r['ms_per_step']:.3f} ms a step, efficiency {r['efficiency']:.4f}, max_r_prim "
            f"{r['max_r_prim']:.3e}; card: {card}")
        n = r["shards"]
        want = {"condense_lanes": 2 * n, "admm_lanes": 2 * n, "allocate_thrusters_lanes": n}
        off = launches_off(r["launches_per_step"], want)
        check(not off and np.isfinite(r["max_r_prim"]),
              f"scaling {r['devices']}: launches a step {off}, max_r_prim {r['max_r_prim']}")
    return rec


def drive_census_scripts(device, card: str, check) -> list:
    """Section 12; returns the sanitizer's kernel rows."""
    import tempfile

    rows = sanitizer_phase(device, card, check)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        census_build_phase(device, card, check, Path(tmp))
    scaling_phase(device, card, check)
    return rows


# ---------------------------------------------------------------------------
# section 13: pareto, the diagnostics, the ablation and the single-scenario entry
# ---------------------------------------------------------------------------


def kernel_row_on(device, s, cfg, warm, rows, iters: int, label: str,
                  launches: int) -> dict:
    """The ADMM kernel held against its plain version and timed on a
    script's inputs `s` (`bench.inputs`) at its last step: the QP of
    `warm` on `rows` (all when None) at `iters` iterations."""
    ctx = Ctx(device, torch.float32, len(s.x0), x0=s.x0.cpu().numpy(), bank=s.bank)
    ctx.cfg = cfg
    r = check_admm(ctx, admm_inputs(ctx, warm, ctx.weights, rows=rows), iters, label, reps=3)
    r["launches"] = launches
    return r


def pareto_phase(device, card: str, check) -> None:
    """13a: two points of the frontier in turns."""
    from ft_mpc_torch.benchmarks import pareto

    rec = pareto.main(B=BATCH, configs=PARETO_POINTS, rounds=PARETO_ROUNDS, device=device)
    log("section 13, pareto: " + json.dumps(rec))
    for line in rec["frontier_md"]:
        log(f"13a: {line}")
    check(rec["card"] == torch.cuda.get_device_name(device) and rec["nvidia_smi"] == card,
          f"pareto record names {rec['card']!r} / {rec['nvidia_smi']!r}")
    want = ({"condense_lanes": 2, "admm_lanes": 2, "allocate_thrusters_lanes": 1},
            LOOP_LAUNCHES)
    for r, w in zip(rec["points"], want):
        log(f"13a: {r['label']}: p50 {r['latency_p50_ms']:.3f} ms, p99 "
            f"{r['latency_p99_ms']:.3f} ms, {r['solves_per_s']:.1f} solves/s, max_r_prim "
            f"{r['max_r_prim']:.3e}, {r['newton_rescues']} rescues, "
            f"{r['vs_deployed_same_round']:.3f} of the deployed point's window; card: {card}")
        check(len(r["latency_samples_ms"]) == PARETO_ROUNDS and r["counted_steps"]
              == (1 + PARETO_ROUNDS) * pareto.STEPS_PER_WINDOW,
              f"pareto {r['label']}: {len(r['latency_samples_ms'])} samples, "
              f"{r['counted_steps']} steps")
        off = launches_off(r["launches_per_step"], w)
        check(not off, f"pareto {r['label']}: launches a step {off}, not {w}")
    log(f"13a: fastest at max_r_prim <= 1e-3: {rec['fastest_at_r_prim_1e-3']}")


def diag_phase(device, card: str, check) -> list:
    """13b-13d: the cleanup run at K=512, the residual pair and the
    stagewise leg, the stub; returns the two ADMM kernel rows."""
    from ft_mpc_torch.benchmarks import bench, diag_cleanup, diag_residual, diag_stub

    s = bench.inputs(BATCH, device)
    rec, out = diag_cleanup.run(s, CLEANUP_RUN, DIAG_STEPS)
    log("section 13, diag_cleanup: " + json.dumps(rec))
    log(f"13b: {diag_cleanup.line(rec)}; launches a step {rec['launches_per_step']}; "
        f"card: {card}")
    off = launches_off(rec["launches_per_step"], {"condense_lanes": 3, "admm_lanes": 3,
                                                  "allocate_thrusters_lanes": 1})
    check(not off, f"diag_cleanup: launches a step {off}")
    k = CLEANUP_RUN[2]
    rows = [kernel_row_on(device, s, diag_cleanup.run_config(CLEANUP_RUN), out.warm,
                          torch.topk(out.info.r_prim, k).indices, CLEANUP_RUN[1],
                          f"diag_cleanup's cleanup K={k}", rec["launches"]["admm_lanes"])]
    del s, out

    s = bench.inputs(RESIDUAL_BATCH, device)
    for spec in RESIDUAL_PAIR:
        rec, out = diag_residual.run(s, spec, DIAG_STEPS)
        log("section 13, diag_residual: " + json.dumps(rec))
        log(f"13c: {diag_residual.lines(rec)}; launches a step {rec['launches_per_step']}; "
            f"card: {card}")
        want = ({"condense_lanes": 2, "admm_lanes": 4, "allocate_thrusters_lanes": 1}
                if spec[0] == "lanes" else {})
        off = launches_off(rec["launches_per_step"], want)
        check(not off, f"diag_residual {rec['label']}: launches a step {off}")
        if spec[0] == "lanes":
            rows.append(kernel_row_on(device, s, diag_residual.run_config(spec), out.warm,
                                      None, spec[2], f"diag_residual B={RESIDUAL_BATCH}"
                                      f" {spec[2]}x{spec[3]}", rec["launches"]["admm_lanes"]))
    sw = diag_residual.stagewise_inputs(diag_residual.STAGEWISE["batch"], device)
    rec, _ = diag_residual.run_stagewise(sw, STAGEWISE_STEPS)
    log("section 13, diag_residual stagewise: " + json.dumps(rec))
    log(f"13c: {diag_residual.lines(rec)}; card: {card}")
    resolves = 2 * 60 + 300 * 2  # sqp_iters * iters + cleanup * 2 phases
    per = rec["launches_per_step"]
    by = sum(rec["riccati_launches_by_design"].values()) / rec["steps"]
    off = launches_off(per, {"riccati_bwd_lanes": resolves, "riccati_fwd_lanes": resolves,
                             "riccati_prepare_lanes": 4, "allocate_thrusters_lanes": 1})
    check(not off and by == resolves, f"diag_residual stagewise: {by} re-solve launches a "
          f"step, launches a step {off}")
    del sw

    rec = diag_stub.main(B=BATCH, steps=DIAG_STEPS, rhos=(50.0,), budgets=((300, 1),),
                         device=device)
    log("section 13, diag_stub: " + json.dumps(rec))
    w = rec["worst_row"]
    log(f"13d: worst row {w['index']} (geometry {w['geometry']}, pattern {w['pattern']}): "
        f"r_prim {w['r_prim']:.3e}, r_dual {w['r_dual']:.3e}, rho {w['rho']:.3g}; h_term "
        f"min {rec['h_term']['min']:.3e}, {rec['h_term']['n_negative']} negative of "
        f"{rec['h_term']['active_rows']}; probe {rec['probes']}; card: {card}")
    check(len(rec["probes"]) == 1 and rec["probes"][0]["finite"]
          and np.isfinite(rec["probes"][0]["r_prim"]) and w["geometry"] == w["index"] % 32,
          f"diag_stub: probe {rec['probes']}, worst row {w}")
    return rows


def ablate_phase(device, card: str, check) -> None:
    """13e-13f: two ablation variants in turns and the single-scenario entry."""
    from ft_mpc_torch.benchmarks import ablate
    from ft_mpc_torch.parallel.dryrun import entry

    rec = ablate.main(B=BATCH, reps=ABLATE_REPS, names=ABLATE_VARIANTS, device=device)
    log("section 13, ablate: " + json.dumps(rec))
    for r in rec["rows"]:
        log(f"13e: {r['label']} (admm {r['config']['admm_iters']}x"
            f"{r['config']['admm_phases']}, sqp {r['config']['sqp_iters']}): "
            f"{r['ms_per_batch_step']:.3f} ms a batch step, {r['solves_per_s']:.1f} "
            f"solves/s; card: {card}")
    check([r["label"] for r in rec["rows"]] == list(ABLATE_VARIANTS)
          and not any(rec["launches"].values()),
          f"ablate: rows {[r['label'] for r in rec['rows']]}, launches {rec['launches']}")

    zero_counters()
    fn, args = entry(device)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    launched = read_counters()
    log(f"13f: entry(): {[list(o.shape) for o in out]} in {ms:.3f} ms, cost "
        f"{float(out[2]):.6f}; card: {card}")
    check([tuple(o.shape) for o in out] == [(16,), (6,), ()]
          and all(bool(torch.isfinite(o).all()) for o in out) and not any(launched.values()),
          f"entry(): shapes {[tuple(o.shape) for o in out]}, launches {launched}")


# ---------------------------------------------------------------------------
# section 14: the linearization kernel (ft_mpc_torch/csrc/linearize.cu)
# ---------------------------------------------------------------------------


def linearize_inputs(device, B: int, Nt: int, dtype=torch.float32) -> tuple:
    """(params, bank, X, U, u_ref) of the path at horizon Nt on B rows: the
    warm-start trajectory from its states and seeded inputs of +-0.2 N."""
    ctx = Ctx(device, dtype, B, stagewise_horizon=0 if Nt == HORIZON else Nt)
    c0 = ctx.sp.robot_to_center(ctx.bank.r, ctx.x0)
    warm = ctx.sp.init_warmstart(ctx.params, ctx.bank, ctx.cfg, c0)
    U = np.random.default_rng(B + Nt).uniform(-0.2, 0.2, (B, Nt, 6))
    return (ctx.params, ctx.bank, warm.X, torch.as_tensor(U, dtype=dtype, device=device),
            ctx.u_ref)


def lin_gap(got, ref, X) -> float:
    """The largest distance of the linearization's outputs (A, B, defects)
    from the reference's, A and B over the reference output's largest entry,
    the defects over the states' (a defect is the difference of two states,
    so its rounding scales with theirs)."""
    scales = (ref[0].abs().max(), ref[1].abs().max(), X.abs().max())
    return max(float((g.double() - r.double()).abs().max() / s)
               for g, r, s in zip(got, ref, scales))


def linearize_bound(args, out) -> tuple[float, str]:
    """`bound_ms` of one linearization: each input read once (u_ref's Nt
    rows) and the outputs written once; forward mode's flops."""
    params, bank, X, U, u_ref = args
    B, Nt = U.shape[:2]
    read = (X, U, u_ref[:Nt], bank.faulty_force_gen, bank.r, bank.u_comp,
            params.mass, params.inertia, params.inertia_inv, params.dt)
    return bound_ms(nbytes(*read, *out), B * Nt * (LIN_PRIMAL_FLOPS + 19 * LIN_TANGENT_FLOPS))


def linearize_row(device, B: int, Nt: int) -> dict:
    """The kernel at one shape: held in float32 and float64, timed."""
    from ft_mpc_torch.ops import linearize as lin

    args = linearize_inputs(device, B, Nt)
    params, bank, X, U, u_ref = args
    n0, p0 = lin.linearize_lanes.launches, lin.linearize_lanes.plain_calls
    got = lin.linearize_lanes(*args, Nt)
    sync(device)
    calls = (lin.linearize_lanes.launches - n0, lin.linearize_lanes.plain_calls - p0)
    ref = lin.linearize_plain(*args, Nt)
    f64 = (tree_to(params, device, torch.float64), tree_to(bank, device, torch.float64),
           X.double(), U.double(), u_ref.double())
    got64 = lin.linearize_lanes(*f64, Nt)
    ref64 = lin.linearize_plain(*f64, Nt)
    b_ms, b_by = linearize_bound(args, got)
    row = {
        "name": "linearize_lanes", "route": "cuda",
        "source": "ft_mpc_torch/csrc/linearize.cu",
        "replaces": "none (XLA fused jax.jacfwd under jit)",
        "shape": f"B={B} Nt={Nt}", "calls": calls,
        "max_abs_err": max(float((g - r).abs().max()) for g, r in zip(got, ref)),
        "max_rel_err": lin_gap(got, ref, X), "tol": None, "tol_rel": TOL_LINEARIZE,
        "max_rel_err_f64": lin_gap(got64, ref64, X),
        "kernel_vs_f64": lin_gap(got, ref64, X), "plain_vs_f64": lin_gap(ref, ref64, X),
        "contiguous": all(t.is_contiguous() for t in got),
        "ms": time_ms(lambda: lin.linearize_lanes(*args, Nt), 20, device, device_only=True),
        "call_ms": time_ms(lambda: lin.linearize_lanes(*args, Nt), 20, device),
        "plain_ms": time_ms(lambda: lin.linearize_plain(*args, Nt), 3, device),
        "ms_f64": time_ms(lambda: lin.linearize_lanes(*f64, Nt), 20, device, device_only=True),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    return with_share(row)


def linearize_launches(device) -> dict:
    """Launches and plain calls of the linearization in `init` and in
    LIN_STEPS chained steps of the condensed and the stagewise path."""
    from ft_mpc_torch.ops import linearize as lin

    out = {}
    for label, B, Nt in (("condensed", BATCH, 0), ("stagewise", SW_BATCH, SW_HORIZON)):
        ctx = Ctx(device, torch.float32, B, stagewise_horizon=Nt)
        n0, p0 = lin.linearize_lanes.launches, lin.linearize_lanes.plain_calls
        warm = ctx.init()
        sync(device)
        n_init = lin.linearize_lanes.launches - n0
        for _ in range(LIN_STEPS):
            warm = ctx.step(warm).warm
        sync(device)
        out[label] = {"init": n_init,
                      "per_step": (lin.linearize_lanes.launches - n0 - n_init) / LIN_STEPS,
                      "plain_calls": lin.linearize_lanes.plain_calls - p0}
        del ctx, warm
        torch.cuda.empty_cache()
    return out


def drive_linearize(device, card: str, check) -> list:
    """Section 14 (module docstring); returns the kernel rows."""
    rows = []
    for B, Nt in LIN_SHAPES:
        r = linearize_row(device, B, Nt)
        log("kernel: " + json.dumps(r))
        check(r["calls"] == (1, 0), f"linearize_lanes at {r['shape']}: (launches, plain "
              f"calls) {r['calls']}, not (1, 0)")
        check(kernel_agrees(r) and r["contiguous"],
              f"linearize_lanes ({r['shape']}) disagrees with its plain version: {r}")
        check(r["max_rel_err_f64"] <= TOL_LINEARIZE_F64,
              f"linearize_lanes ({r['shape']}) float64 off its plain version by "
              f"{r['max_rel_err_f64']:.3e}")
        rows.append(r)
        torch.cuda.empty_cache()
    counted = linearize_launches(device)
    log(f"linearize launches: {json.dumps(counted)}; card: {card}")
    want = {"condensed": {"init": 1, "per_step": 3, "plain_calls": 0},
            "stagewise": {"init": 0, "per_step": 3, "plain_calls": 0}}
    check(counted == want, f"linearize launches {counted}, not {want}")
    for r in rows:
        r["launches"] = counted["condensed" if r["shape"] == f"B={BATCH} Nt={HORIZON}"
                                else "stagewise"]["per_step"]
    return rows


# ---------------------------------------------------------------------------
# section 15: the terminal kernel (ft_mpc_torch/csrc/terminal.cu)
# ---------------------------------------------------------------------------


def terminal_inputs(device, B: int, Nt: int) -> dict:
    """{derivs: (term, e)} of one step of the path (condensed for Nt = 0,
    else stagewise at horizon Nt) on B rows after its warm start: the first
    call with derivs (an assembly's, e (B, 9)) and without (the line
    search's, e (3, B, 9)), captured as the controller makes them."""
    from ft_mpc_torch.controllers import spiraling as sp

    ctx = Ctx(device, torch.float32, B, stagewise_horizon=Nt)
    warm = ctx.init()
    seen, real = {}, sp.terminal_lanes

    def capture(term, e, derivs=False):
        seen.setdefault(derivs, (term, e.clone()))
        return real(term, e, derivs=derivs)

    sp.terminal_lanes = capture
    try:
        ctx.step(warm)
    finally:
        sp.terminal_lanes = real
    sync(device)
    return seen


def terminal_gaps(got, ref) -> dict:
    """Distances of the outputs (V, or V, gradient, Hessian) from the
    reference's over each reference output's largest entry (at least 1),
    the Hessian's omega diagonal (where the PSD shift lands) apart."""
    got, ref = (got,) if torch.is_tensor(got) else got, (ref,) if torch.is_tensor(ref) else ref
    gaps = {}
    for name, g, r in zip(("V", "g", "H"), got, ref):
        d = (g.double() - r.double()).abs()
        s = max(1.0, float(r.abs().max()))
        if name == "H":
            diag = torch.zeros(9, 9, dtype=torch.bool, device=d.device)
            diag[6:, 6:] = torch.eye(3, dtype=torch.bool, device=d.device)
            gaps["H_diag"] = float(d[..., diag].max()) / s
            d = d[..., ~diag]
        gaps[name] = float(d.max()) / s
    return gaps


def terminal_bound(term, e, out, derivs: bool) -> tuple[float, str]:
    """`bound_ms` of one call: e and the tables read once, the outputs
    written once; TERM_FLOPS a row."""
    out = (out,) if torch.is_tensor(out) else out
    base, k1, k2 = TERM_FLOPS[derivs]
    n = e.numel() // 9
    flops = n * (base + k1 * term.poly_c.shape[-1] + k2 * term.sqrt_c.shape[-1])
    return bound_ms(nbytes(e, *term, *out), flops)


def terminal_row(device, label: str, term, e, derivs: bool) -> dict:
    """The kernel on one captured call: held in float32 and float64, timed."""
    from ft_mpc_torch.ops import terminal as ot

    n0, p0 = ot.terminal_lanes.launches, ot.terminal_lanes.plain_calls
    got = ot.terminal_lanes(term, e, derivs)
    sync(device)
    calls = (ot.terminal_lanes.launches - n0, ot.terminal_lanes.plain_calls - p0)
    ref = ot.terminal_plain(term, e, derivs)
    term64, e64 = tree_to(term, device, torch.float64), e.double()
    got64 = ot.terminal_lanes(term64, e64, derivs)
    ref64 = ot.terminal_plain(term64, e64, derivs)
    gaps, gaps64 = terminal_gaps(got, ref), terminal_gaps(got64, ref64)
    vs64, plain_vs64 = terminal_gaps(got, ref64), terminal_gaps(ref, ref64)
    off = max(v for k, v in gaps.items() if k != "H_diag")
    agrees = off <= TOL_TERMINAL_F32 and (
        not derivs
        or vs64["H_diag"] <= max(TOL_TERMINAL_SHIFT_F32, 4 * plain_vs64["H_diag"]))
    b_ms, b_by = terminal_bound(term, e, got, derivs)
    outs = (got,) if torch.is_tensor(got) else got
    row = {
        "name": "terminal_lanes", "route": "cuda", "source": "ft_mpc_torch/csrc/terminal.cu",
        "replaces": "none (XLA fused jax.vmap of jax.grad / jax.hessian)",
        "shape": f"{label} e={tuple(e.shape)} derivs={derivs}", "calls": calls,
        "max_abs_err": max(float((g.double() - r.double()).abs().max())
                           for g, r in zip(outs, (ref,) if torch.is_tensor(ref) else ref)),
        "gaps": gaps, "gaps_f64": gaps64, "kernel_vs_f64": vs64, "plain_vs_f64": plain_vs64,
        "max_rel_err": off, "tol": None, "tol_rel": TOL_TERMINAL_F32, "agrees": agrees,
        "finite": all(bool(torch.isfinite(o).all()) for o in outs),
        "contiguous": all(o.is_contiguous() for o in outs),
        "ms": time_ms(lambda: ot.terminal_lanes(term, e, derivs), 20, device,
                      device_only=True),
        "call_ms": time_ms(lambda: ot.terminal_lanes(term, e, derivs), 20, device),
        "plain_ms": time_ms(lambda: ot.terminal_plain(term, e, derivs), 3, device),
        "ms_f64": time_ms(lambda: ot.terminal_lanes(term64, e64, derivs), 20, device,
                          device_only=True),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    return with_share(row)


def terminal_launches(device) -> dict:
    """Launches and plain calls of the terminal terms in `init` and in
    TERM_STEPS chained steps of the condensed and the stagewise path."""
    from ft_mpc_torch.ops import terminal as ot

    out = {}
    for label, B, Nt in (("condensed", BATCH, 0), ("stagewise", SW_BATCH, SW_HORIZON)):
        ctx = Ctx(device, torch.float32, B, stagewise_horizon=Nt)
        n0, p0 = ot.terminal_lanes.launches, ot.terminal_lanes.plain_calls
        warm = ctx.init()
        sync(device)
        n_init = ot.terminal_lanes.launches - n0
        for _ in range(TERM_STEPS):
            warm = ctx.step(warm).warm
        sync(device)
        out[label] = {"init": n_init,
                      "per_step": (ot.terminal_lanes.launches - n0 - n_init) / TERM_STEPS,
                      "plain_calls": ot.terminal_lanes.plain_calls - p0}
        del ctx, warm
        torch.cuda.empty_cache()
    return out


def drive_terminal(device, card: str, check) -> list:
    """Section 15 (module docstring); returns the kernel rows."""
    rows = []
    for B, Nt in TERM_BATCHES:
        label = f"B={B} " + ("stagewise" if Nt else "condensed")
        for derivs, (term, e) in sorted(terminal_inputs(device, B, Nt).items()):
            r = terminal_row(device, label, term, e, derivs)
            log("kernel: " + json.dumps(r))
            check(r["calls"] == (1, 0), f"terminal_lanes at {r['shape']}: (launches, plain "
                  f"calls) {r['calls']}, not (1, 0)")
            check(r["agrees"] and r["finite"] and r["contiguous"],
                  f"terminal_lanes ({r['shape']}) disagrees with its plain version: {r}")
            check(max(r["gaps_f64"].values()) <= TOL_TERMINAL_F64,
                  f"terminal_lanes ({r['shape']}) float64 off its plain version by "
                  f"{r['gaps_f64']}")
            rows.append(r)
        torch.cuda.empty_cache()
    counted = terminal_launches(device)
    log(f"terminal launches: {json.dumps(counted)}; card: {card}")
    want = {"condensed": {"init": 1, "per_step": 7, "plain_calls": 0},
            "stagewise": {"init": 0, "per_step": 7, "plain_calls": 0}}
    check(counted == want, f"terminal launches {counted}, not {want}")
    for r in rows:
        r["launches"] = counted["stagewise" if "stagewise" in r["shape"]
                                else "condensed"]["per_step"]
    return rows


def drive_last_scripts(device, card: str, check) -> list:
    """Section 13; returns its two ADMM kernel rows."""
    pareto_phase(device, card, check)
    torch.cuda.empty_cache()
    rows = diag_phase(device, card, check)
    for r in rows:
        log("kernel: " + json.dumps(with_share(r)))
        check(kernel_agrees(r), f"{r['name']} ({r['shape']}) disagrees with its plain version")
    torch.cuda.empty_cache()
    ablate_phase(device, card, check)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, metavar="FILE",
                    help="trace two condensed steps, one stagewise step and three "
                         "steps of the demo's rollout with torch.profiler; write the "
                         "tables to FILE")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "ft_mpc_torch" / "csrc").is_dir():
        print(f"chip_smoke: ft_mpc_torch/ not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import ft_mpc_torch

    t_start = time.perf_counter()
    ft_mpc_torch.pin_fp32_matmuls()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 must be off for the matmuls that feed K^-1")

    build_s = build_kernels()
    log(f"build: {build_s:.1f} s (nvcc, one process per source, sm_90a)")

    # every check below is read and printed; the run fails at the end if any failed
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            log(f"chip_smoke: check failed: {msg}")

    ctx = Ctx(device, torch.float32, BATCH)
    main_res, warm, out = drive_main_path(ctx)
    log("main path: " + json.dumps(main_res))
    log(f"main path: p50 {main_res['p50_ms']:.3f} ms vs the {PERIOD_MS:.0f} ms control "
        f"period (not gated); p99 {main_res['p99_ms']:.3f} ms; "
        f"{main_res['solves_per_s']:.1f} solves/s")
    log(f"gap rows {main_res['gap_rows']} vs the reference's pinned set "
        f"{sorted(REFERENCE_GAP_ROWS)}")
    check(main_res["finite"], "main path produced non-finite outputs")
    check(main_res["u_shape"] == (BATCH, 16), f"u_phys shape {main_res['u_shape']}")
    check(main_res["max_term_gap"] <= GAP_GATE,
          f"max_term_gap {main_res['max_term_gap']} > {GAP_GATE}")
    zero = [k for k in CONDENSED_KERNELS if main_res["launches"][k] <= 0]
    check(not zero, f"kernels never launched on the condensed path: {zero}")

    profiles = []
    if args.profile:
        profiles.append(profile_steps(ctx, warm, "condensed B=2048 Nt=15"))

    rows = []
    rows.append(check_condense(ctx, warm))
    adm = check_admm(ctx, admm_inputs(ctx, warm, ctx.weights), ctx.cfg.admm.iters,
                     "main path T=64")
    rows.append(adm)
    x_lb, x_ub = np.full(13, -1e8), np.full(13, 1e8)
    x_lb[3:6], x_ub[3:6] = -1.0, 1.0  # velocity box and wrench-rate rows
    boxed = ctx.sp.MPCWeights.from_diagonals(
        Q_DIAG, R_DIAG, x_lb=x_lb, x_ub=x_ub, du_max=np.full(6, 0.5),
        dtype=torch.float32, device=device,
    )
    extra = [
        check_admm(ctx, admm_inputs(ctx, warm, boxed), ctx.cfg.admm.iters,
                   "box and rate rows T>64", reps=3),
        check_admm(ctx, admm_inputs(ctx, warm, ctx.weights,
                                    rows=torch.topk(out.info.r_prim, 256).indices),
                   ctx.cfg.cleanup_iters, "cleanup K=256", reps=3),
    ]
    rows.append(check_alloc(ctx))
    for r in rows + extra:
        log("kernel: " + json.dumps(with_share(r)))
    for r in rows + extra:
        check(kernel_agrees(r), f"{r['name']} ({r['shape']}) disagrees with its plain version")
    for r in rows:
        r["launches"] = main_res["launches"][r["name"]]

    facets = check_alloc_facets(ctx)
    log("alloc at the hull test's threshold (demands 2 error bounds either side): "
        + json.dumps(facets))
    check(facets["wrong_kernel"] == 0 and facets["decisive"] >= 0.9 * facets["rows"]
          and 0 < facets["clipped"] < facets["rows"],
          "allocation kernel decides the hull test wrongly off its threshold")

    hold_alloc_main(ctx, out, "condensed", check)

    for label, x0 in (("states near the terminal sets", gentle_x0(64)),
                      ("bench states", bench_x0(64))):
        step = card_vs_cpu(device, x0)
        log(f"whole step, card vs CPU port ({step['rows']} rows, {label}, float32): "
            f"max |dwrench| {step['wrench_err']:.3e}, max |du_phys| {step['u_err']:.3e} "
            f"(tol {TOL_STEP_U}) on the rows whose allocation took the same branches; "
            f"{step['branch_rows']} rows on a branch threshold")
        check(step["finite"], f"card step on {label} is not finite")
        check(step["wrench_err"] <= TOL_STEP_U and step["u_err"] <= TOL_STEP_U
              and step["branch_rows"] <= step["rows"] // 8,
              f"card step differs from the CPU port on {label}: {step}")

    del ctx, warm, out  # the condensed path's tensors, before the long horizon
    log(f"sections 1-4 in {time.perf_counter() - t_start:.1f} s")
    sections = (
        (5, lambda: rows.extend(drive_stagewise(device, card, check,
                                                profiles if args.profile else None))),
        (6, lambda: drive_closed_loop(device, card, check, profiles if args.profile else None)),
        (7, lambda: rows.append(drive_port_banks(device, card, check))),
        (8, lambda: drive_slice_api(device, card, check)),
        (9, lambda: drive_sharding(device, card, check, main_res["p50_ms"])),
        (10, lambda: rows.append(drive_boxed(device, card, check))),
        (11, lambda: drive_bench_scripts(device, card, check)),
        (12, lambda: rows.extend(drive_census_scripts(device, card, check))),
        (13, lambda: rows.extend(drive_last_scripts(device, card, check))),
        (14, lambda: rows.extend(drive_linearize(device, card, check))),
        (15, lambda: rows.extend(drive_terminal(device, card, check))),
    )
    for n, drive in sections:
        torch.cuda.empty_cache()
        t_section = time.perf_counter()
        drive()
        log(f"section {n} in {time.perf_counter() - t_section:.1f} s")
    log(f"the script in {time.perf_counter() - t_start:.1f} s")
    if args.profile:
        args.profile.parent.mkdir(parents=True, exist_ok=True)
        args.profile.write_text("\n".join(profiles))

    if failures:
        fail("; ".join(failures))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
