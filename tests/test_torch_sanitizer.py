"""The port's closed-loop NaN sanitizer (`ft_mpc_torch.benchmarks.sanitizer`)
against the JAX package's recipe (`benchmarks/sanitizer_onchip.py`).

That script arms `jax_debug_nans` when it is imported, so nothing here
imports it; its recipe is restated and held against the port's inputs:
  * the census order, the uncertified patterns read from the committed
    entries' meta (the four of SANITIZER_r04.json), the seed-7 states and
    the hover references: exact, float32;
  * one window of 3 steps at B=4 (healthy, (3), (10, 11), (12, 13)) at
    the sanitizer's configuration, noise 'none', through the JAX package's
    `batched_rollout_lanes` in float32 (its Pallas kernels in interpret
    mode) and the port's on the CPU: wrench and u_phys (on rows whose
    allocation took the same branches) within 2e-2, state within 2e-3, the
    classes of tests/test_torch_sim.py;
  * a NaN planted in a history is reported with its window, step, field,
    rows and patterns;
  * `main` on the CPU at a tiny depth, and without a card it refuses to
    run unless the CPU is asked for.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.benchmarks import common, sanitizer
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.sim.env import RolloutHistory
from torch_parity import jax_bank, np_

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = ([], [3], [10, 11], [12, 13])  # the window's four patterns


def jax_census():
    """`sanitizer_onchip.py:59-65`."""
    from ft_mpc_tpu.utils.faults import BrokenThruster

    patterns = [[]]
    patterns += [[BrokenThruster(i, 1.0)] for i in range(16)]
    patterns += [[BrokenThruster(i, 1.0), BrokenThruster(j, 1.0)]
                 for i in range(16) for j in range(i + 1, 16)]
    return patterns


def jax_x0(B: int) -> np.ndarray:
    """`sanitizer_onchip.py:93-99`."""
    rng = np.random.default_rng(7)
    x0 = np.zeros((B, 13), np.float32)
    x0[:, 0:3] = rng.uniform(-0.5, 0.5, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.2, 0.2, (B, 3))
    x0[:, 6:10] = [0, 0, 0, 1]
    x0[:, 10:13] = rng.uniform(-0.3, 0.3, (B, 3))
    return x0


class float32_jax:
    """64-bit mode off, as the JAX script runs."""

    def __enter__(self):
        self.x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.x64)


def test_census_order_and_uncertified_patterns():
    port = [[(f.index, f.intensity) for f in p] for p in sanitizer.census()]
    ref = [[(f.index, f.intensity) for f in p] for p in jax_census()]
    assert port == ref and len(port) == 137

    from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
    from ft_mpc_tpu.terminal.pipeline import (
        cache_key,
        load_terminal_ingredients,
        plant_fingerprint,
    )

    cdir = REPO / "ft_mpc_tpu" / "config" / "terminal_cache"
    with float32_jax():
        fp = plant_fingerprint(JBodyParams.default(0.1))
    want = [i for i, f in enumerate(jax_census()) if "fallback" in load_terminal_ingredients(
        cdir / f"{cache_key(f, _jax_tuning(), fp)}.npz").meta]
    rows = sanitizer.uncertified(sanitizer.census())
    assert rows == want
    committed = json.loads((REPO / "SANITIZER_r04.json").read_text())
    assert [sanitizer.pattern_indices(sanitizer.census()[i]) for i in rows] == \
        committed["uncertified_patterns"] == [[12, 13], [12, 15], [13, 14], [14, 15]]


def _jax_tuning():
    from ft_mpc_tpu.api import DEFAULT_TUNING

    return DEFAULT_TUNING


def test_states_and_references_match_the_recipe(tmp_path):
    np.testing.assert_array_equal(sanitizer.x0_states(137), jax_x0(137))
    assert sanitizer.x0_states(137).dtype == np.float32

    from ft_mpc_tpu.api import _build_scenario_with_terminal
    from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
    from ft_mpc_tpu.utils.trajectory import generate_trajectory, prepare_center_trajectory

    cache = tmp_path / "terminal_cache"  # a copy: the committed cache is never written
    shutil.copytree(REPO / "ft_mpc_tpu" / "config" / "terminal_cache", cache)
    with float32_jax():
        healthy = _build_scenario_with_terminal(JBodyParams.default(0.1), [], _jax_tuning(),
                                                cache_dir=str(cache))
        omega = np.asarray(healthy.omega_des)
        x_ref, u_ref = prepare_center_trajectory(generate_trajectory("hover", 0.1, 10),
                                                 omega, 16.8, 0.1, 16)
        x_ref = np.asarray(jnp.asarray(x_ref, jnp.float32))
        u_ref = np.asarray(jnp.asarray(u_ref, jnp.float32))
    port_omega = common.build_scenarios([[]])[0].omega_des.numpy()
    np.testing.assert_array_equal(port_omega, omega)
    px, pu = sanitizer.references(port_omega)
    assert px.dtype == pu.dtype == np.float32
    np.testing.assert_array_equal(px, x_ref)
    np.testing.assert_array_equal(pu, u_ref)


def test_config_is_the_scripts():
    c = sanitizer.config()
    assert (c.horizon, c.sqp_iters, c.admm.iters, c.admm.phases, c.admm.rho,
            c.admm.adapt_clip) == (15, 2, 60, 1, 50.0, 1.5)
    assert (c.cleanup_iters, c.cleanup_k, c.cleanup_phases) == (300, 16, 2)
    assert c.newton_iters == 3


def test_window_matches_jax_float32():
    """One 3-step window of the sanitizer's closed loop at B=4, noise 'none'."""
    from ft_mpc_torch.utils.faults import BrokenThruster
    from ft_mpc_tpu.controllers import spiraling as jsp
    from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
    from ft_mpc_tpu.sim import env as jenv
    from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg

    patterns = [[BrokenThruster(i, 1.0) for i in p] for p in SMALL]
    rows = [[sanitizer.pattern_indices(f) for f in sanitizer.census()].index(p)
            for p in SMALL]
    s = sanitizer.inputs(torch.device("cpu"), patterns)
    s.x0 = torch.as_tensor(sanitizer.x0_states(137)[rows])
    sim = dict(steps=3, noise_mode="none")
    flat = flatten_namedtuple(s.bank)
    c = s.cfg
    with float32_jax():
        jcfg = jsp.MPCConfig(
            horizon=c.horizon, sqp_iters=c.sqp_iters,
            admm=JCfg(iters=c.admm.iters, phases=c.admm.phases, rho=c.admm.rho,
                      adapt_clip=c.admm.adapt_clip),
            cleanup_iters=c.cleanup_iters, cleanup_k=c.cleanup_k,
            cleanup_phases=c.cleanup_phases)
        ref = jenv.batched_rollout_lanes(
            JBodyParams.default(0.1), jax_bank(flat),
            jsp.MPCWeights.from_diagonals(*(_jax_tuning()[k] for k in ("Q", "R"))), jcfg,
            jenv.SimConfig(**sim), jnp.asarray(np_(s.x0)), jnp.asarray(np_(s.x_ref)),
            jnp.asarray(np_(s.u_ref)), jax.random.split(jax.random.key(0), len(rows)))
        ref = type(ref)(*(np.asarray(x) for x in ref))
    from ft_mpc_torch.sim.env import SimConfig, batched_rollout_lanes

    out = batched_rollout_lanes(s.params, s.bank, s.weights, s.cfg, SimConfig(**sim), s.x0,
                                s.x_ref, s.u_ref)
    sanitizer.check_finite(out, 0, patterns)
    assert ref.state.dtype == np.float32 and out.state.dtype == torch.float32
    np.testing.assert_allclose(np_(out.wrench), ref.wrench, rtol=0, atol=2e-2)
    same = np_(out.was_clipped) == ref.was_clipped
    assert same.sum() >= same.size - 2
    np.testing.assert_allclose(np_(out.u_phys)[same], ref.u_phys[same], rtol=0, atol=2e-2)
    np.testing.assert_allclose(np_(out.state), ref.state, rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_(out.x_ref0), ref.x_ref0, rtol=0, atol=1e-7)


RESCUE_STEPS = 6


def _rescue_resid(K: np.ndarray, X0: np.ndarray) -> np.ndarray:
    """`newton_kinv`'s 3-step power-iteration estimate of rho(I - s K X0),
    per scenario, in numpy at the arrays' precision."""
    n = K.shape[-1]
    Y = K @ X0
    s = np.trace(Y, axis1=-2, axis2=-1) / np.maximum((Y * Y).sum((-2, -1)), 1e-30)
    R = s[:, None, None] * Y - np.eye(n, dtype=K.dtype)
    v = np.broadcast_to(np.sin(1.0 + np.arange(n, dtype=K.dtype))[None, :, None] / np.sqrt(n),
                        (K.shape[0], n, 1))
    for _ in range(3):
        v = R @ v
        v = v / (np.linalg.norm(v, axis=-2, keepdims=True) + 1e-30)
    return np.linalg.norm((R @ v)[..., 0], axis=-1)


def test_rescues_match_jax_on_the_census(monkeypatch):
    """`newton_kinv`'s whole-batch rescue on the census closed loop (B=137,
    the sanitizer's configuration and states, noise 'none', RESCUE_STEPS
    steps), float32: the JAX package (interpret mode) and the port take it
    on the same refreshes (the rule evaluated on each side's K and carried
    K^-1), none of them on a non-finite residual, and the port's counters
    agree.  Both take it on every refresh but the first:
    the rule fires on the census' transients in both packages alike."""
    import ft_mpc_torch.solvers.lanes_qp as tq
    import ft_mpc_tpu.solvers.lanes_qp as jq
    from ft_mpc_torch.sim.env import SimConfig, batched_rollout_lanes
    from ft_mpc_tpu.controllers import spiraling as jsp
    from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
    from ft_mpc_tpu.sim import env as jenv
    from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg

    seen = {"jax": [], "port": []}

    def record(side, K, X0, iters):
        r = _rescue_resid(np.asarray(K), np.asarray(X0))
        fin = np.isfinite(r)
        seen[side].append((bool((r[fin] >= 0.01 ** (1.0 / 2 ** iters)).any()),
                           bool((~fin).any())))

    port_newton, jax_newton = tq.newton_kinv, jq.newton_kinv

    def port_wrapped(K, X0, iters):
        record("port", K.numpy(), X0.numpy(), iters)
        return port_newton(K, X0, iters)

    def jax_wrapped(K, X0, iters):
        jax.debug.callback(lambda K, X0: record("jax", K, X0, iters), K, X0, ordered=True)
        return jax_newton(K, X0, iters)

    monkeypatch.setattr(tq, "newton_kinv", port_wrapped)
    monkeypatch.setattr(jq, "newton_kinv", jax_wrapped)
    s = sanitizer.inputs(torch.device("cpu"))
    sim = dict(steps=RESCUE_STEPS, noise_mode="none")
    common.zero_counters()
    batched_rollout_lanes(s.params, s.bank, s.weights, s.cfg, SimConfig(**sim), s.x0, s.x_ref,
                          s.u_ref)
    counted = common.read_launches(RESCUE_STEPS)
    c = s.cfg
    try:
        with float32_jax():
            jcfg = jsp.MPCConfig(
                horizon=c.horizon, sqp_iters=c.sqp_iters,
                admm=JCfg(iters=c.admm.iters, phases=c.admm.phases, rho=c.admm.rho,
                          adapt_clip=c.admm.adapt_clip),
                cleanup_iters=c.cleanup_iters, cleanup_k=c.cleanup_k,
                cleanup_phases=c.cleanup_phases)
            ref = jenv.batched_rollout_lanes(
                JBodyParams.default(0.1), jax_bank(flatten_namedtuple(s.bank)),
                jsp.MPCWeights.from_diagonals(*(_jax_tuning()[k] for k in ("Q", "R"))), jcfg,
                jenv.SimConfig(**sim), jnp.asarray(np_(s.x0)), jnp.asarray(np_(s.x_ref)),
                jnp.asarray(np_(s.u_ref)), jax.random.split(jax.random.key(0), len(s.patterns)))
            jax.block_until_ready(ref)
            jax.effects_barrier()
    finally:
        jax.clear_caches()  # no trace keeps the wrapped newton_kinv
    assert len(s.patterns) == 137
    assert len(seen["port"]) == len(seen["jax"]) == 2 * RESCUE_STEPS  # one a SQP iteration
    assert seen["port"] == seen["jax"]
    assert not any(nonfinite for _, nonfinite in seen["port"] + seen["jax"])
    assert [rescue for rescue, _ in seen["port"]] == [False] + [True] * (2 * RESCUE_STEPS - 1)
    assert counted["newton_rescues"] == 2 * RESCUE_STEPS - 1
    assert counted["newton_rescues_nonfinite"] == 0


def _history(B=3, T=5) -> RolloutHistory:
    return RolloutHistory(*(torch.zeros((B, T) + shape) for shape in
                            ((), (13,), (13,), (16,), (6,), (9,), (), (), (), (), (), ())))


def test_planted_nan_is_named():
    patterns = sanitizer.census()[:3]
    h = _history()
    sanitizer.check_finite(h, 0, patterns)  # all finite: nothing raised
    h.u_phys[2, 3, 5] = float("nan")
    h.wrench[1, 2, 0] = float("inf")
    h.term_gap[0, 2] = float("nan")
    # the earliest step wins; at that step the first field in the history's order
    with pytest.raises(sanitizer.NonFiniteError,
                       match=r"non-finite wrench in window 2, step 2, rows \[1\] "
                             r"\(patterns \[\[0\]\]\)"):
        sanitizer.check_finite(h, 2, patterns)
    h.state[0, 2, 4] = float("nan")
    h.state[2, 2, 0] = float("nan")
    with pytest.raises(sanitizer.NonFiniteError,
                       match=r"non-finite state in window 'x', step 2, rows \[0, 2\] "
                             r"\(patterns \[\[\], \[1\]\]\)"):
        sanitizer.check_finite(h, "'x'", patterns)


def test_main_on_cpu(monkeypatch, tmp_path):
    """Control flow at a tiny depth: 4 patterns, 2 windows of 2 steps, a
    short cleanup; the record's fields, launches and gates."""
    from ft_mpc_torch.utils.faults import BrokenThruster

    monkeypatch.setattr(sanitizer, "census", lambda: [[BrokenThruster(i, 1.0) for i in p]
                                                      for p in SMALL])
    monkeypatch.setattr(sanitizer, "WINDOWS", 2)
    monkeypatch.setattr(sanitizer, "WINDOW_STEPS", 2)
    monkeypatch.setattr(sanitizer, "SCENARIO_STEPS", 2)
    small = sanitizer.config()._replace(cleanup_iters=20)
    monkeypatch.setattr(sanitizer, "config", lambda: small)
    rec = sanitizer.main(device="cpu", out=tmp_path / "san.json")
    assert json.loads((tmp_path / "san.json").read_text()) == rec
    assert rec["batch"] == 4 and rec["steps"] == 4 and rec["all_finite"]
    assert rec["uncertified_patterns"] == [[12, 13]]
    assert rec["per_scenario_pattern"] == [10, 11]
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["step_ms_p50"] > 0 and rec["step_ms_p99"] >= rec["step_ms_p50"]
    assert rec["launches_expected"] == {"condense_lanes": 3 * 4 + 2, "admm_lanes": 16,
                                        "allocate_thrusters_lanes": 4}
    assert all(v == 0 for v in rec["launches"].values())  # the CPU runs plain versions
    assert all(v == 0 for v in rec["per_scenario_launches"].values())
    lo, med, hi = rec["contraction_200_min_med_max"]
    assert 0 <= lo <= med <= hi
    assert rec["n_contracting_200_steps"] + len(rec["not_contracting"]) == 4
    assert rec["failed_gates"] == sanitizer.gates(rec)


def test_gates():
    ok = {"max_term_gap_final": 0.0, "not_contracting": [], "steps": 200}
    assert sanitizer.gates(ok) == []
    assert len(sanitizer.gates({**ok, "max_term_gap_final": 2e-3})) == 1
    assert len(sanitizer.gates({**ok, "max_term_gap_final": float("nan")})) == 1
    bad = [{"pattern": [12, 13], "ratio_200": 0.7, "uncertified_terminal": True}]
    assert "[12, 13]" in sanitizer.gates({**ok, "not_contracting": bad})[0]


def test_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sanitizer.main()
