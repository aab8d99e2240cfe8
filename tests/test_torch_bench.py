"""The port's bench (`ft_mpc_torch.benchmarks.bench`, `cli.bench_main`) on
the CPU, against the JAX package and bench.py's recipes.

- The bench's inputs: the hover references against the JAX package's
  `utils.trajectory` in float64 at 1e-10; the seed-0 states against
  bench.py's and long_horizon.py's recipes (copied below) exactly; the
  32-pattern bank the bench builds, leaf for leaf against
  `ft_mpc_torch/data/bench_bank32.npz` at 1e-12 (chip_smoke.TOL_BANK).
- The whole bench on the CPU at B=8 (1 warm-up and 1 timed window of 2
  steps): the record's fields at the deployed configuration; and, with the
  worst-K cleanup on every row (K=256 >= B) cut to 20 iterations a phase
  through bench.py's own FT_MPC_BENCH_CLEANUP override on both sides, its
  final outputs against the JAX package's `get_control_batch` chained the
  same way from the bench's warm start: u_phys within 2e-2 N on the rows
  whose allocation took the same branches (C1; `tests/test_lanes.py:174-178`),
  max_r_prim rtol 5e-2 and max_term_gap atol 1e-3 as
  `test_torch_spiraling.py::test_control_step_matches_jax` holds them.
  `init_warmstart_batch` itself is held against the JAX package there.
- The gates on synthetic records, `cli`'s exit code, the window statistic
  on a fake step whose host times are known, and the entry point.
"""

from __future__ import annotations

import json
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.benchmarks import bench, common
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.geometry.scenario import BENCH_BANK, stack_scenarios
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from ft_mpc_tpu.utils import trajectory as jtraj
from torch_parity import jax_bank, load_flat

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
B_CPU = 8
CLEANUP_CPU = 20  # cleanup iterations a phase in the JAX comparison


def bench_py_x0(B):
    """bench.py:113-120, copied."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.3, 0.3, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-0.3, 0.3, (B, 3))
    return x0


def long_horizon_py_x0(B):
    """benchmarks/long_horizon.py:97-100, copied."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    x0[:, 9] = 1.0
    return x0


@pytest.mark.parametrize("horizon,duration", [(15, 5.0), (60, 30.0)])
def test_hover_refs_match_jax(horizon, duration):
    traj = jtraj.generate_trajectory("hover", 0.1, duration)
    x_ref, u_ref = jtraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   0.1, horizon + 1)
    tx, tu = common.hover_refs(horizon, duration, "cpu", dtype=torch.float64)
    assert tx.shape == (horizon + 1, 9) and tu.shape == (horizon + 1, 6)
    np.testing.assert_allclose(tx.numpy(), x_ref[: horizon + 1], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tu.numpy(), u_ref[: horizon + 1], rtol=1e-10, atol=1e-10)


def test_states_match_the_recipes():
    np.testing.assert_array_equal(common.bench_x0(2048), bench_py_x0(2048))
    np.testing.assert_array_equal(common.long_horizon_x0(512), long_horizon_py_x0(512))
    assert common.bench_x0(7).dtype == np.float32


def test_bench_bank_matches_snapshot():
    """The 32 rows the bench builds (float32 plant, DEFAULT_TUNING, the
    committed cache), held as chip_smoke section 7 holds them; tiled in
    order and cut to B."""
    scs = common.build_scenarios()
    assert len(scs) == common.BENCH_PATTERNS
    got = flatten_namedtuple(stack_scenarios(scs, device="cpu", dtype=torch.float64).scenarios)
    with np.load(BENCH_BANK) as z:
        snap = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(snap)
    for k in snap:
        np.testing.assert_allclose(got[k], snap[k], rtol=0, atol=1e-12, err_msg=k)
    bank = common.tiled_bank(scs, 40, "cpu")
    assert bank.r.shape[0] == 40
    np.testing.assert_array_equal(bank.hull_A[32:].numpy(), bank.hull_A[:8].numpy())


def _recording(monkeypatch):
    """Keep the bench's warm start and last output (the record holds no
    tensors)."""
    seen = {}
    real = common.chained_windows

    def chained(step, warm, *args, **kw):
        samples, out = real(step, warm, *args, **kw)
        seen.update(warm=warm, out=out)
        return samples, out

    monkeypatch.setattr(common, "chained_windows", chained)
    return seen


def test_bench_record_on_cpu():
    """The deployed configuration at B=8: every field of the record."""
    rec = bench.main(B=B_CPU, device="cpu", windows=1, steps_per_window=2)
    for key in ("metric", "value", "unit", "batch", "per_step_latency_ms", "latency_p50_ms",
                "latency_p99_ms", "latency_windows", "max_r_prim", "max_term_gap",
                "n_restoration_gap", "gap_rows", "gap_patterns", "steps_per_window",
                "warmup_windows", "init_ms", "bank_build_s", "meets_control_period",
                "newton_rescues", "launches_per_step", "failed_gates"):
        assert key in rec, key
    assert "vs_baseline" not in rec
    assert rec["device"] == "cpu" and rec["card"] is None and rec["power_limit"] is None
    assert rec["batch"] == B_CPU and rec["latency_windows"] == 1
    assert rec["steps_per_window"] == 2 and rec["warmup_windows"] == 1
    assert rec["config"] == {"sqp_iters": 2, "admm_iters": 60, "admm_phases": 1, "rho": 50.0,
                             "adapt_clip": 1.5, "newton_iters": 3, "cleanup_iters": 600,
                             "cleanup_k": 256, "cleanup_phases": 3}
    assert rec["latency_p50_ms"] == np.percentile(rec["latency_samples_ms"], 50)
    assert rec["value"] == pytest.approx(B_CPU * 1e3 / rec["latency_p50_ms"])
    assert rec["meets_control_period"] == (rec["latency_p50_ms"] <= 100.0)
    assert rec["finite"] and rec["u_shape"] == [B_CPU, 16]
    assert rec["pinned_gap_rows"] is None and rec["failed_gates"] == []
    # on the CPU every wrapper runs its plain version: no launch is counted
    assert all(v == 0 for v in rec["launches_per_step"].values())
    json.dumps(rec)


def test_bench_matches_jax(monkeypatch):
    monkeypatch.setenv("FT_MPC_BENCH_CLEANUP", str(CLEANUP_CPU))
    seen = _recording(monkeypatch)
    rec = bench.main(B=B_CPU, device="cpu", windows=1, steps_per_window=2)
    assert rec["config"]["cleanup_iters"] == CLEANUP_CPU

    flat = load_flat(np.arange(B_CPU) % common.BENCH_PATTERNS)
    traj = jtraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = jtraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   0.1, 16)
    cfg = jsp.MPCConfig(horizon=15, sqp_iters=2,
                        admm=JCfg(iters=60, phases=1, rho=50.0, adapt_clip=1.5),
                        newton_iters=3, cleanup_iters=CLEANUP_CPU, cleanup_k=256,
                        cleanup_phases=3)
    args = (JBodyParams.default(0.1), jax_bank(flat),
            jsp.MPCWeights.from_diagonals([1, 1, 1, 1, 1, 1, 2, 2, 2],
                                          [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]), cfg)
    tw = seen["warm"]
    warm = jsp.WarmStart(*(jnp.asarray(v.double().numpy()) for v in tw[:5]),
                         kinv=jnp.asarray(tw.kinv.numpy()))
    step = jax.jit(jsp.get_control_batch, static_argnums=(3,))
    x0 = jnp.asarray(bench_py_x0(B_CPU).astype(np.float64))
    for _ in range(2 * 2):  # the warm-up window and the timed one, chained
        j = step(*args, x0, jnp.asarray(x_ref[:16]), jnp.asarray(u_ref[:16]), warm)
        warm = j.warm

    t = seen["out"]
    branch = lambda a: np.stack([np.asarray(a.was_clipped), np.asarray(a.used_fallback)], 1)
    same = (branch(j.alloc) == branch(t.alloc)).all(1)
    assert same.sum() >= B_CPU - 1
    np.testing.assert_allclose(t.u_phys.double().numpy()[same], np.asarray(j.u_phys)[same],
                               atol=2e-2)
    np.testing.assert_allclose(rec["max_r_prim"], float(jnp.max(j.info.r_prim)), rtol=5e-2,
                               atol=1e-3)
    np.testing.assert_allclose(rec["max_term_gap"], float(jnp.nanmax(j.info.term_gap)),
                               atol=1e-3)


def _record(**kw):
    rec = {"finite": True, "max_term_gap": 0.3, "gap_gate": 0.4, "gap_rows": [209, 1713],
           "pinned_gap_rows": list(bench.PINNED_GAP_ROWS)}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("kw,fails", [
    ({}, 0),
    ({"finite": False}, 1),
    ({"max_term_gap": 0.41}, 1),
    ({"max_term_gap": float("nan")}, 1),
    ({"gap_rows": [209, 210]}, 1),
    ({"gap_rows": [210], "pinned_gap_rows": None}, 0),
    ({"finite": False, "max_term_gap": 0.5, "gap_rows": [7]}, 3),
])
def test_gates(kw, fails):
    failed = bench.gates(_record(**kw))
    assert len(failed) == fails, failed
    if kw.get("gap_rows") == [209, 210]:
        assert "[210]" in failed[0] and "patterns [18]" in failed[0]


@pytest.mark.parametrize("failed,code", [([], 0), (["max_term_gap 0.5 > 0.4"], 1)])
def test_cli_exit_code(monkeypatch, capsys, failed, code):
    monkeypatch.setattr(bench, "main", lambda **kw: {"value": 1.0, "failed_gates": failed})
    assert bench.cli([]) == code
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["failed_gates"] == failed


def test_chained_windows_on_a_fake_step():
    """Host times known per call: the warm-up window is not timed, each
    sample is its window's per-step mean, and each call takes the previous
    output's warm start."""
    now = [0.0]
    durations = iter([9.0, 9.0, 1.0, 3.0, 2.0, 2.0, 10.0, 20.0])  # s, per call
    seen = []

    class Out:
        def __init__(self, warm):
            self.warm = warm

    def step(warm):
        seen.append(warm)
        now[0] += next(durations)
        return Out(warm + 1)

    samples, out = common.chained_windows(step, 0, 3, 2, torch.device("cpu"),
                                          clock=lambda: now[0])
    np.testing.assert_allclose(samples, [2000.0, 2000.0, 15000.0])
    assert seen == list(range(8)) and out.warm == 8
    assert np.percentile(samples, 50) == 2000.0


def test_entry_point():
    from ft_mpc_torch import cli

    assert callable(cli.bench_main)
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["ft-mpc-torch-bench"] == "ft_mpc_torch.cli:bench_main"
