"""What the port's measuring scripts share: the card's identity, the window
timer, the chained steps with their finiteness watch, the kernels' launch
counters, and the bench's inputs (the 32-pattern census bank, the hover
references, the seed-0 states of `bench.py` and of
`benchmarks/long_horizon.py`).

Every record a script writes names the device it ran on; on a card also the
card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them (a card set below 700 W runs slower under
load), so no time, rate or byte figure stands without them.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

DT = 0.1
BENCH_PATTERNS = 32  # bench.py:68: healthy, the 16 singles, the doubles (0, j)
WARMUP_WINDOWS = 1  # bench.py:136-146: one untimed window before the timed ones
# H100 SXM published peak (NVIDIA data sheet), at the full 700 W power limit
H100_HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them; a
    failing nvidia-smi raises."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_identity(device: torch.device) -> dict:
    """The record's device fields: `device`, and on a card `card`
    (`torch.cuda.get_device_name`), `device_count`, `nvidia_smi` (the
    card line) and `power_limit` (its second field); those are None on the
    CPU."""
    if device.type != "cuda":
        return {"device": str(device), "card": None, "device_count": None,
                "nvidia_smi": None, "power_limit": None}
    line = card_line()
    return {"device": str(device), "card": torch.cuda.get_device_name(device),
            "device_count": torch.cuda.device_count(), "nvidia_smi": line,
            "power_limit": line.rsplit(",", 1)[-1].strip()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_windows(step, warm, windows: int, steps_per_window: int, device,
                    clock=time.perf_counter):
    """bench.py's statistic (`bench.py:136-168`) on an eager step.

    `step(warm)` returns an output whose `.warm` the next call takes.
    `WARMUP_WINDOWS` untimed windows, then `windows` timed windows of
    `steps_per_window` chained steps each; a window is timed by `clock` from
    its first call to a device synchronize after its last.  Returns (the
    samples: each window's per-step mean in ms, the last output)."""
    out = None
    for _ in range(WARMUP_WINDOWS * steps_per_window):
        out = step(warm)
        warm = out.warm
    sync(device)
    samples = []
    for _ in range(windows):
        t0 = clock()
        for _ in range(steps_per_window):
            out = step(warm)
            warm = out.warm
        sync(device)
        samples.append(1e3 * (clock() - t0) / steps_per_window)
    return np.asarray(samples, dtype=np.float64), out


class FiniteWatch:
    """Whether every tensor of every output it has seen is finite,
    accumulated on the device, so that watching a step adds no host sync;
    `require` reads it once and raises RuntimeError otherwise."""

    def __init__(self):
        self.ok, self.steps = None, 0

    def see(self, out):
        from torch.utils._pytree import tree_leaves

        ok = torch.stack([torch.isfinite(t).all() for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)]).all()
        self.ok = ok if self.ok is None else self.ok & ok
        self.steps += 1
        return out

    def require(self, what: str) -> None:
        if self.ok is not None and not bool(self.ok):
            raise RuntimeError(f"{what}: a non-finite output in {self.steps} steps")


def chained_steps(step, warm, steps: int, watch: FiniteWatch | None = None):
    """`steps` calls of `step(warm)`, each taking the previous output's
    warm start (the JAX scripts' `fori_loop`); the last output."""
    out = None
    for _ in range(steps):
        out = step(warm)
        if watch is not None:
            watch.see(out)
        warm = out.warm
    return out


def drive_chain(step, warm, steps: int, device, what: str) -> tuple[dict, object]:
    """`chained_steps` with the launch counters zeroed before and read after
    and every output watched: (the ms a step by the host clock to a device
    synchronize, the launches and rescues, the last output); raises
    RuntimeError naming `what` on a non-finite output."""
    watch = FiniteWatch()
    zero_counters()
    sync(device)
    t0 = time.perf_counter()
    out = chained_steps(step, warm, steps, watch)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    counted = read_launches(steps)
    watch.require(what)
    return {"steps": steps, "ms_per_step": ms, **counted}, out


def config_record(cfg) -> dict:
    """The fields of an MPCConfig that the measuring scripts vary."""
    return {"sqp_iters": cfg.sqp_iters, "admm_iters": cfg.admm.iters,
            "admm_phases": cfg.admm.phases, "rho": cfg.admm.rho,
            "adapt_clip": cfg.admm.adapt_clip, "newton_iters": cfg.newton_iters,
            "cleanup_iters": cfg.cleanup_iters, "cleanup_k": cfg.cleanup_k,
            "cleanup_phases": cfg.cleanup_phases, "ls_alphas": list(cfg.ls_alphas),
            "qp_backend": cfg.qp_backend}


def pattern_name(pattern) -> list[int]:
    """A fault pattern as the indices of its broken thrusters."""
    return [f.index for f in pattern]


def counters() -> dict:
    """The kernel wrappers, each of which counts its launches in `.launches`."""
    from ft_mpc_torch.solvers import lanes_alloc, lanes_condense, lanes_qp, lanes_riccati

    return {
        "condense_lanes": lanes_condense.condense_lanes,
        "admm_lanes": lanes_qp.admm_lanes,
        "allocate_thrusters_lanes": lanes_alloc.allocate_thrusters_lanes,
        "riccati_bwd_lanes": lanes_riccati.riccati_bwd_lanes,
        "riccati_fwd_lanes": lanes_riccati.riccati_fwd_lanes,
        "riccati_prepare_lanes": lanes_riccati.riccati_prepare_lanes,
    }


def zero_counters() -> None:
    """Every launch counter to 0, the by-design ones and the whole-batch
    exact refactors of `newton_kinv` too."""
    from ft_mpc_torch.solvers.lanes_qp import admm_lanes, newton_kinv
    from ft_mpc_torch.solvers.lanes_riccati import riccati_split_lanes

    for fn in counters().values():
        fn.launches = 0
    for fn in (admm_lanes, riccati_split_lanes):
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)
    newton_kinv.rescues = 0
    newton_kinv.rescues_nonfinite = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def read_launches(steps: int) -> dict:
    """The counters since `zero_counters`, over `steps` steps: launches,
    launches a step, by design, and `newton_kinv` rescues (all, and those
    taken with a non-finite residual)."""
    from ft_mpc_torch.solvers.lanes_qp import admm_lanes, newton_kinv
    from ft_mpc_torch.solvers.lanes_riccati import riccati_split_lanes

    launches = read_counters()
    return {
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "admm_launches_by_design": dict(admm_lanes.launches_by_design),
        "riccati_launches_by_design": dict(riccati_split_lanes.launches_by_design),
        "newton_rescues": newton_kinv.rescues,
        "newton_rescues_nonfinite": newton_kinv.rescues_nonfinite,
    }


def bench_patterns() -> list:
    """bench.py:59-68: the first 32 of the census (healthy, the 16 single
    faults, the doubles (0, j))."""
    from ft_mpc_torch.geometry.scenario import default_fault_pool

    return default_fault_pool()[:BENCH_PATTERNS]


def build_scenarios(patterns=None) -> list:
    """The scenarios of `patterns` (default `bench_patterns`), built on the
    host by `build_scenario_with_terminal` with DEFAULT_TUNING for the
    float32 plant, whose terminal ingredients the committed cache holds."""
    from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal
    from ft_mpc_torch.ops.dynamics import BodyParams

    cpu = torch.device("cpu")
    plant = BodyParams.default(DT, dtype=torch.float32, device=cpu)
    return [build_scenario_with_terminal(plant, f, DEFAULT_TUNING, device=cpu)
            for f in (bench_patterns() if patterns is None else patterns)]


def tiled_bank(scenarios, B: int, device, dtype=torch.float32):
    """The scenarios stacked and tiled in order to B rows (the last tile
    cut), float leaves of `dtype` on `device`."""
    from ft_mpc_torch.geometry.scenario import stack_scenarios, take_rows, tile_bank

    bank = stack_scenarios(scenarios, device=device, dtype=dtype).scenarios
    bank = tile_bank(bank, -(-B // len(scenarios)))
    return take_rows(bank, torch.arange(B, device=device))


def build_bench_bank(B: int, device):
    """(the bench's bank of B rows on `device`, host seconds of the build and
    the copy)."""
    t0 = time.perf_counter()
    bank = tiled_bank(build_scenarios(), B, device)
    sync(device)
    return bank, time.perf_counter() - t0


def hover_refs(horizon: int, duration: float, device, dtype=torch.float32,
               mass: float = 16.8):
    """The hover reference windows (x_ref (Nt+1, 9), u_ref (Nt+1, 6)) of
    `generate_trajectory("hover", DT, duration)` about the orbit rate
    (0, 0, 0.6), as bench.py:106-111 and long_horizon.py:89-94 make them."""
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    traj = generate_trajectory("hover", DT, duration)
    x_ref, u_ref = prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), mass, DT,
                                             horizon + 1)
    t = lambda a: torch.as_tensor(a[: horizon + 1], dtype=dtype, device=device)
    return t(x_ref), t(u_ref)


def bench_x0(B: int) -> np.ndarray:
    """bench.py:113-120 exactly: seeded tumbling robot states, float32."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.3, 0.3, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-0.3, 0.3, (B, 3))
    return x0


def long_horizon_x0(B: int) -> np.ndarray:
    """benchmarks/long_horizon.py:97-100: seeded positions, identity attitude,
    at rest."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    x0[:, 9] = 1.0
    return x0


def write_record(record: dict, out: str | Path | None) -> None:
    """The record as indented JSON at `out` (nothing when None)."""
    if out is None:
        return
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1) + "\n")
