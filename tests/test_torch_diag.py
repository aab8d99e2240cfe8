"""The port's residual diagnostics (`ft_mpc_torch.benchmarks.diag_cleanup`,
`diag_residual`, `diag_stub`) on the CPU, against the JAX package and the
JAX scripts' recipes (rebuilt here from `ft_mpc_tpu`; the scripts
themselves set JAX's matmul precision globally and are never imported).

- Recipes: the runs, configurations, bank patterns and states equal the
  scripts' (`diag_cleanup.py:37-81, 104-108`, `diag_residual.py:44-89,
  118-129`, `diag_stub.py:41-77, 117-125`, copied below); the port's
  "condensed" runs keep qp_backend 'condensed' and call `get_control_rows`.
- Statistics: the tail (sorted r_prim at the ranks, the counts above 1e-3
  and 1e-2) and the per-geometry grouping (row maxima over the 32-pattern
  tile, the five worst) equal the scripts' formulas on equal arrays.
- One run at a cut depth through both packages, float32 on the port's
  side (the kernels' plain versions), the JAX package as its own suite runs
  it (x64 around its float32 Pallas kernels, in interpret mode, jitted):
  B=32, 2 chained steps from the same states, ADMM 10x1 and the cleanup
  20x1 at K=8: u_phys within 2e-2 N on the rows whose allocation took
  the same branches and max_r_prim at rtol 5e-2, atol 1e-3
  (`test_torch_bench.py::test_bench_matches_jax`'s classes); the tail,
  diag_residual's breakdown (each geometry's maximum, max and p95) at the
  same tolerance, and diag_stub's worst row on that run.  (diag_residual's
  runs call the same `get_control_batch` through the same chain.)
- diag_stub's QP and probe on one row in float64: the row's QP (assembled
  as `row_qp` assembles it, the condensing in float64 on both sides: the
  per-scenario assembly) and `solve_mpc_qp` on it at
  `test_torch_control.py::test_solve_mpc_qp_matches_jax`'s tolerance.
- Each `main` at a tiny depth on the CPU, and none without a card.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.benchmarks import bench, common, diag_cleanup, diag_residual, diag_stub
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.geometry.scenario import load_bank_snapshot
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.solvers import mpc_qp as tmq
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.solvers import mpc_qp as jmq
from ft_mpc_tpu.utils import trajectory as jtraj
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import jax_bank, load_flat, np_, t64

torch.set_num_threads(1)

B_CPU = 32
STEPS_CPU = 2
CUT = (10, 20, 8, 1)  # diag_cleanup's (admm iters, cleanup iters, K, phases), cut


def plain(t):
    if hasattr(t, "_asdict"):
        return {k: plain(v) for k, v in t._asdict().items()}
    return t


def script_patterns():
    """diag_cleanup.py:37-47 (and diag_residual.py:44-55, diag_stub.py:41-51)."""
    fault_patterns = [[]]
    fault_patterns += [[JBroken(i, 1.0)] for i in range(16)]
    fault_patterns += [[JBroken(i, 1.0), JBroken(j, 1.0)]
                       for i in range(16) for j in range(i + 1, 16)]
    return fault_patterns[:32]


def script_x0(B):
    """diag_cleanup.py:60-67 (diag_residual.py:69-76, diag_stub.py:64-71)."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), dtype=np.float32)
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.3, 0.3, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-0.3, 0.3, (B, 3))
    return x0


def jax_cleanup_config(iters, cl_iters, cl_k, cl_ph):
    """diag_cleanup.py:72-81 and diag_stub.py:73-77."""
    return jsp.MPCConfig(horizon=15, sqp_iters=2,
                         admm=jmq.StructuredADMMConfig(iters=iters, phases=1, rho=50.0,
                                                       adapt_clip=1.5),
                         newton_iters=3, cleanup_iters=cl_iters, cleanup_k=cl_k,
                         cleanup_phases=cl_ph)


def jax_residual_config(backend, sqp, iters, phases, newton, rho=50.0, clip=1.5):
    """diag_residual.py:79-89."""
    return jsp.MPCConfig(horizon=15, sqp_iters=sqp,
                         admm=jmq.StructuredADMMConfig(iters=iters, phases=phases, rho=rho,
                                                       adapt_clip=clip),
                         newton_iters=newton, qp_backend=backend)


# ---------------------------------------------------------------------------
# recipes
# ---------------------------------------------------------------------------


def test_bank_patterns_and_states_are_the_scripts():
    got = [[(f.index, f.intensity) for f in p] for p in common.bench_patterns()]
    assert got == [[(f.index, f.intensity) for f in p] for p in script_patterns()]
    np.testing.assert_array_equal(common.bench_x0(2048), script_x0(2048))
    assert diag_cleanup.BATCH == diag_stub.BATCH == 2048 and diag_residual.BATCH == 128
    assert diag_cleanup.STEPS == diag_residual.STEPS == diag_stub.STEPS == 10


def test_cleanup_runs_are_the_scripts():
    # diag_cleanup.py:104-108
    assert diag_cleanup.RUNS == ((60, 0, 0, 1), (60, 300, 256, 1), (60, 300, 256, 2),
                                 (60, 300, 512, 1), (80, 400, 512, 1))
    assert diag_cleanup.RANKS == (0, 1, 4, 16, 64, 255, 511)  # :96-97
    for run in diag_cleanup.RUNS + (diag_stub.RUN,):
        assert plain(diag_cleanup.run_config(run)) == plain(jax_cleanup_config(*run))
    assert diag_stub.RUN == (60, 300, 256, 1)  # diag_stub.py:73-77


@pytest.mark.parametrize("spec", diag_residual.RUNS)
def test_residual_runs_are_the_scripts(spec):
    # diag_residual.py:118-129
    script = [("lanes", 2, 40, 1, 3), ("condensed", 2, 40, 1, 3), ("lanes", 2, 160, 1, 3),
              ("condensed", 2, 160, 1, 3), ("lanes", 2, 160, 2, 3),
              ("condensed", 2, 160, 2, 3), ("lanes", 2, 160, 2, 8),
              ("lanes", 2, 80, 1, 3, 200.0, 5.0), ("condensed", 2, 80, 1, 3, 200.0, 5.0)]
    i = diag_residual.RUNS.index(spec)
    kw = dict(zip(("rho", "clip"), script[i][5:]))
    assert spec[:5] == script[i][:5] and spec[5:] == (kw.get("rho", 50.0), kw.get("clip", 1.5))
    got = plain(diag_residual.run_config(spec))
    want = plain(jax_residual_config(*script[i][:5], **kw))
    # the pair names the path, not the backend: both runs condense
    assert got.pop("qp_backend") == "condensed" and want.pop("qp_backend") == spec[0]
    assert got == want


def test_stagewise_leg_config():
    cfg = diag_residual.stagewise_config(512)
    assert (cfg.horizon, cfg.qp_backend, cfg.stagewise.mode) == (240, "stagewise", "lanes")
    assert (cfg.stagewise.iters, cfg.stagewise.phases, cfg.stagewise.rho) == (60, 1, 50.0)
    assert (cfg.cleanup_iters, cfg.cleanup_phases, cfg.cleanup_k) == (300, 2, 64)


def test_probe_grid_is_the_scripts():
    # diag_stub.py:117-125
    assert diag_stub.RHOS == (1.0, 10.0, 50.0, 250.0, 1000.0)
    assert diag_stub.BUDGETS == ((300, 1), (300, 4), (1000, 4)) and diag_stub.PROBE_CLIP == 5.0


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,seed", [(2048, 0), (128, 1), (512, 2)])
def test_statistics_equal_the_scripts_formulas(B, seed):
    rng = np.random.default_rng(seed)
    rp = np.exp(rng.uniform(np.log(1e-6), np.log(1e-1), B)).astype(np.float32)
    rd = rng.uniform(0, 5, B).astype(np.float32)
    # diag_cleanup.py:93-101
    srt = np.sort(rp)[::-1]
    t = diag_cleanup.tail(rp)
    assert t["max"] == srt[0]
    ranks = [k for k in (0, 1, 4, 16, 64, 255, 511) if k < B]  # all at the script's 2048
    assert list(t["ranked"].values()) == [float(srt[k]) for k in ranks]
    assert t["n_above_1e-3"] == np.sum(srt > 1e-3) and t["n_above_1e-2"] == np.sum(srt > 1e-2)
    # diag_residual.py:103-112
    reps = B // 32
    per_geo = rp.reshape(reps, 32).max(axis=0)
    worst = np.argsort(per_geo)[::-1][:5]
    b = diag_residual.breakdown(rp, rd, common.bench_patterns())
    assert b["max"] == rp.max() and b["p50"] == np.median(rp.astype(np.float64))
    assert b["p95"] == np.percentile(rp.astype(np.float64), 95) and b["r_dual_max"] == rd.max()
    assert [w["geometry"] for w in b["worst_geometries"]] == list(worst)
    assert [w["r_prim"] for w in b["worst_geometries"]] == [float(per_geo[g]) for g in worst]
    assert b["worst_geometries"][0]["pattern"] == common.pattern_name(
        common.bench_patterns()[worst[0]])


def test_tail_at_a_small_batch():
    t = diag_cleanup.tail(np.array([3e-2, 2e-3, 5e-4, 1e-5, 2e-3]))
    assert t["ranked"] == {"0": 3e-2, "1": 2e-3, "4": 1e-5}
    assert (t["n_above_1e-3"], t["n_above_1e-2"]) == (3, 1)


# ---------------------------------------------------------------------------
# one cut run through both packages
# ---------------------------------------------------------------------------


def _record_chains(monkeypatch):
    """Keep each chain's warm start and last output."""
    seen = []
    real = common.chained_steps

    def chained(step, warm, steps, watch=None):
        out = real(step, warm, steps, watch)
        seen.append((warm, out))
        return out

    monkeypatch.setattr(common, "chained_steps", chained)
    return seen


def _jax_chain(cfg, tw, steps):
    """The JAX package's `get_control_batch`, jitted, chained `steps` times
    from the port's warm start on the bench rows and the scripts' states."""
    flat = load_flat(np.arange(B_CPU) % 32)
    traj = jtraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = jtraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   0.1, 16)
    args = (JBodyParams.default(0.1), jax_bank(flat),
            jsp.MPCWeights.from_diagonals([1, 1, 1, 1, 1, 1, 2, 2, 2],
                                          [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]), cfg)
    warm = jsp.WarmStart(*(jnp.asarray(v.double().numpy()) for v in tw[:5]),
                         kinv=jnp.asarray(tw.kinv.numpy()))
    step = jax.jit(jsp.get_control_batch, static_argnums=(3,))
    x0 = jnp.asarray(script_x0(B_CPU).astype(np.float64))
    for _ in range(steps):
        j = step(*args, x0, jnp.asarray(x_ref[:16]), jnp.asarray(u_ref[:16]), warm)
        warm = j.warm
    return j


def _hold(t, j):
    branch = lambda a: np.stack([np.asarray(a.was_clipped), np.asarray(a.used_fallback)], 1)
    same = (branch(j.alloc) == branch(t.alloc)).all(1)
    assert same.sum() >= B_CPU - 2
    np.testing.assert_allclose(t.u_phys.double().numpy()[same], np.asarray(j.u_phys)[same],
                               atol=2e-2)
    rp_t, rp_j = t.info.r_prim.double().numpy(), np.asarray(j.info.r_prim)
    np.testing.assert_allclose(rp_t.max(), rp_j.max(), rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(diag_residual.per_geometry(rp_t, 32),
                               diag_residual.per_geometry(rp_j, 32), rtol=5e-2, atol=1e-3)


def test_cut_run_matches_jax(monkeypatch):
    """diag_cleanup's run at the cut depth against the JAX package's; its
    tail and diag_residual's per-geometry breakdown of both; diag_stub's
    worst row on the same run."""
    seen = _record_chains(monkeypatch)
    s = bench.inputs(B_CPU, torch.device("cpu"))
    rec, out = diag_cleanup.run(s, CUT, STEPS_CPU)
    assert rec["steps"] == STEPS_CPU and rec["config"]["cleanup_k"] == 8
    j = _jax_chain(jax_cleanup_config(*CUT), seen[0][0], STEPS_CPU)
    _hold(out, j)
    t = diag_cleanup.tail(out.info.r_prim.numpy())
    tj = diag_cleanup.tail(np.asarray(j.info.r_prim))
    np.testing.assert_allclose(list(t["ranked"].values()), list(tj["ranked"].values()),
                               rtol=5e-2, atol=1e-3)
    b = diag_residual.breakdown(out.info.r_prim.numpy(), out.info.r_dual.numpy(),
                                common.bench_patterns())
    jb = diag_residual.breakdown(np.asarray(j.info.r_prim), np.asarray(j.info.r_dual),
                                 common.bench_patterns())
    assert b["worst_geometries"][0]["geometry"] in [w["geometry"] for w in
                                                    jb["worst_geometries"][:2]]
    np.testing.assert_allclose([b["max"], b["p95"]], [jb["max"], jb["p95"]], rtol=5e-2,
                               atol=1e-3)

    monkeypatch.setattr(diag_stub, "RUN", CUT)
    stub = diag_stub.main(B=B_CPU, steps=STEPS_CPU, rhos=(50.0,), budgets=((30, 1),),
                          device="cpu")
    rp_j = np.asarray(j.info.r_prim)
    worst = stub["worst_row"]
    assert rp_j[worst["index"]] >= np.sort(rp_j)[-3]  # among the JAX run's worst rows
    assert worst["geometry"] == worst["index"] % 32
    np.testing.assert_allclose(worst["r_prim"], rp_j.max(), rtol=5e-2, atol=1e-3)
    assert len(stub["probes"]) == 1 and np.isfinite(stub["probes"][0]["r_prim"])


# ---------------------------------------------------------------------------
# diag_stub's QP and probe in float64
# ---------------------------------------------------------------------------


def test_stub_qp_and_probe_match_jax():
    """Row 28 ((0, 12)) of the bench bank at a perturbed rolled-out
    iterate: its QP and a probe solve, both packages in float64."""
    rng = np.random.default_rng(3)
    row = 28
    flat = load_flat([row])
    tbank = tsp.take_rows(load_bank_snapshot(device="cpu", dtype=torch.float64),
                          torch.tensor([row]))
    jbank = jax_bank(flat)
    traj = jtraj.generate_trajectory("hover", 0.1, 5)
    x_ref, u_ref = jtraj.prepare_center_trajectory(traj, np.array([0.0, 0.0, 0.6]), 16.8,
                                                   0.1, 16)
    x_ref, u_ref = x_ref[:16], u_ref[:16]
    tcfg = diag_cleanup.run_config(diag_stub.RUN)
    params = TBodyParams.default(0.1, dtype=torch.float64, device="cpu")
    c0 = t_robot_to_center(tbank.r, t64(script_x0(1)))
    warm = tsp.init_warmstart(params, tbank, tcfg, c0)
    warm = warm._replace(U=t64(0.05 * rng.standard_normal((1, 15, 6))))
    s = SimpleNamespace()
    s.bank, s.params, s.cfg, s.x_ref, s.u_ref = tbank, params, tcfg, t64(x_ref), t64(u_ref)
    s.weights = tsp.MPCWeights.from_diagonals([1, 1, 1, 1, 1, 1, 2, 2, 2],
                                              [0.1, 0.1, 0.1, 0.01, 0.01, 0.01],
                                              dtype=torch.float64, device="cpu")
    qp = diag_stub.row_qp(s, warm, 0, assemble=tsp._assemble_condensed)

    jx_ref = np.array(x_ref)
    jx_ref[:, 6:9] = flat["omega_des"][0]  # the per-scenario reference
    sc0 = jax.tree.map(lambda a: a[0], jbank)
    jqp, *_ = jax.jit(jsp._assemble_condensed, static_argnums=(3,))(
        JBodyParams.default(0.1), sc0, jsp.MPCWeights.from_diagonals(
            [1, 1, 1, 1, 1, 1, 2, 2, 2], [0.1, 0.1, 0.1, 0.01, 0.01, 0.01]),
        jax_cleanup_config(*diag_stub.RUN), jnp.asarray(np_(warm.X[0])),
        jnp.asarray(np_(warm.U[0])),
        jnp.asarray(jx_ref), jnp.asarray(u_ref), *jsp._masked_geometry(sc0))
    for name in qp._fields:
        a, b = np_(getattr(qp, name)), np.asarray(getattr(jqp, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * max(1.0, np.abs(b).max()),
                                   err_msg=name)
    c = dict(iters=30, phases=2, rho=50.0, adapt_clip=diag_stub.PROBE_CLIP)
    tsol = tmq.solve_mpc_qp(qp, tmq.StructuredADMMConfig(**c))
    jsol = jax.jit(jmq.solve_mpc_qp, static_argnums=(1,))(jqp, jmq.StructuredADMMConfig(**c))
    for name in tsol._fields:
        b = np.asarray(getattr(jsol, name))
        np.testing.assert_allclose(np_(getattr(tsol, name)), b, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(b).max()), err_msg=name)
    res = diag_stub.probe(qp, rhos=(50.0,), budgets=((30, 2),))
    assert res[0]["r_prim"] == pytest.approx(float(jsol.r_prim), abs=1e-8)


# ---------------------------------------------------------------------------
# the mains
# ---------------------------------------------------------------------------


def test_mains_on_cpu(monkeypatch, tmp_path):
    rec = diag_cleanup.main(B=8, runs=((4, 0, 0, 1), (4, 6, 2, 1)), steps=1, device="cpu",
                            out=tmp_path / "c.json")
    assert [r["cleanup_k"] for r in rec["runs"]] == [0, 2] and rec["card"] is None
    assert list(rec["runs"][0]["r_prim"]["ranked"]) == ["0", "1", "4"]
    assert (tmp_path / "c.json").exists()
    rec = diag_residual.main(B=8, runs=(("lanes", 1, 4, 1, 3, 50.0, 1.5),
                                        ("condensed", 1, 4, 1, 3, 50.0, 1.5)),
                             steps=1, device="cpu")
    assert [r["function"] for r in rec["runs"]] == ["get_control_batch", "get_control_rows"]
    assert all(len(r["worst_geometries"]) == 5 for r in rec["runs"])
    assert all(v == 0 for r in rec["runs"] for v in r["launches"].values())
    monkeypatch.setitem(diag_residual.STAGEWISE, "horizon", 10)
    monkeypatch.setitem(diag_residual.STAGEWISE, "iters", 3)
    monkeypatch.setitem(diag_residual.STAGEWISE, "cleanup", 2)
    rec = diag_residual.main(B=4, steps=1, backend="stagewise", device="cpu")
    (r,) = rec["runs"]
    assert r["config"]["qp_backend"] == "stagewise" and rec["batch"] == 4
    assert sorted(w["pattern"] for w in r["worst_geometries"]) == [[], [10, 11]]
    with pytest.raises(ValueError, match="backend"):
        diag_residual.main(B=4, backend="lanes", device="cpu")


def test_a_non_finite_step_raises(monkeypatch):
    """A NaN anywhere in a step's output stops the run."""
    real = tsp.get_control_batch

    def poisoned(*a):
        out = real(*a)
        return out._replace(wrench=out.wrench * float("nan"))

    monkeypatch.setattr(tsp, "get_control_batch", poisoned)
    with pytest.raises(RuntimeError, match="non-finite"):
        diag_cleanup.main(B=4, runs=((2, 0, 0, 1),), steps=1, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("main", [diag_cleanup.main, diag_residual.main, diag_stub.main])
def test_needs_a_card_unless_asked(main):
    with pytest.raises(RuntimeError, match="CUDA"):
        main()
