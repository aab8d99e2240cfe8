"""The port's ablation timing (`ft_mpc_torch.benchmarks.ablate`) and its
single-scenario entry (`ft_mpc_torch.parallel.dryrun.entry`) on the CPU,
against the JAX package and the JAX recipes (`benchmarks/ablate.py`,
rebuilt here from `ft_mpc_tpu`: the script sets JAX's matmul precision
globally and is never imported; `__graft_entry__.entry`).

- The variants' configurations equal `ablate.py:68-79`'s, field for field;
  the bank is healthy and (10, 11) alternating, the states
  `ablate.py:46-50`'s exactly, the references the hover window.
- `get_control_rows` at B=4 on the ablation's full variant (3 SQP
  iterations, ADMM 30x1) matches the JAX package's `vmap(get_control)` in
  float64 at `test_torch_control.py::test_get_control_matches_jax`'s
  tolerance (1e-6), from one `init_warmstart` on the ablation's states.
  The JAX bank is built as `test_torch_isolation.py` builds its banks:
  with 64-bit mode off (the float32 plant keys the terminal cache) from a
  scratch copy of the cache, then widened to float64.
- The ablation at B=4 with 2 rounds: every row, its configuration and
  times, the in-turns order, `timed_chain`'s perturbed and chained calls,
  no kernel launch.
- `entry()`'s `fn(*example_args)` equals `__graft_entry__.entry()`'s in
  float64 within 1e-6 on u_phys and wrench and 1e-6 of its size on the
  cost (a scalar of about 35; the JAX side's scenario built as above).
- Neither runs without a card unless asked.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.benchmarks import ablate
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.parallel import dryrun
from ft_mpc_tpu.api import DEFAULT_TUNING as J_TUNING
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from ft_mpc_tpu.utils import trajectory as jtraj
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import jax_bank, np_

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TERMINAL_CACHE = REPO / "ft_mpc_tpu" / "config" / "terminal_cache"
F64 = torch.float64


def plain(t):
    if hasattr(t, "_asdict"):
        return {k: plain(v) for k, v in t._asdict().items()}
    return t


def script_x0(B):
    """ablate.py:46-50, copied."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((B, 13), np.float32)
    x0[:, 9] = 1.0
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3))
    return x0


def jax_flat(patterns, tmp_path) -> dict:
    """The JAX package's scenarios of `patterns` (DEFAULT_TUNING), built
    with 64-bit mode off from a scratch copy of the terminal cache, stacked
    and widened to float64."""
    from ft_mpc_tpu.api import _build_scenario_with_terminal

    cache = tmp_path / "terminal_cache"
    shutil.copytree(TERMINAL_CACHE, cache)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        flats = [flatten_namedtuple(_build_scenario_with_terminal(
            JBodyParams.default(0.1), [JBroken(i, 1.0) for i in p], J_TUNING,
            cache_dir=str(cache))) for p in patterns]
    finally:
        jax.config.update("jax_enable_x64", x64)
    return {k: np.stack([f[k] for f in flats]).astype(np.float64)
            if flats[0][k].dtype.kind == "f" else np.stack([f[k] for f in flats])
            for k in flats[0]}


def test_variants_are_the_scripts():
    want = {
        "full (3 sqp, admm 25x2)": jsp.MPCConfig(horizon=15, sqp_iters=3),
        "sqp=1": jsp.MPCConfig(horizon=15, sqp_iters=1),
        "admm 1x1": jsp.MPCConfig(horizon=15, sqp_iters=3,
                                  admm=JCfg(iters=1, phases=1, rho=1.0)),
        "no line search": jsp.MPCConfig(horizon=15, sqp_iters=3, ls_alphas=(1.0,)),
    }
    got = ablate.variants()
    assert list(got) == list(want)
    for name in want:
        assert plain(got[name]) == plain(want[name]), name
    # the JAX label is stale: the full variant runs ADMM 30x1 at rho 50
    full = got[ablate.FULL].admm
    assert (full.iters, full.phases, full.rho) == (30, 1, 50.0)
    assert ablate.BATCH == 2048 and ablate.REPS == 8 and ablate.PERTURB == 1e-4


def test_setup_is_the_scripts():
    s = ablate.setup(6, torch.device("cpu"))
    np.testing.assert_array_equal(s.x0.numpy(), script_x0(6))
    broken = s.bank.fault.broken.numpy()
    assert broken[0::2].sum() == 0 and (broken[1::2][:, [10, 11]] == 1).all()
    assert broken.sum() == 6
    traj = jtraj.generate_trajectory("hover", 0.1, 5)
    x_ref, _ = jtraj.prepare_center_trajectory(traj, np.array([0, 0, 0.6]), 16.8, 0.1, 16)
    np.testing.assert_allclose(s.x_ref.numpy(), x_ref[:16], rtol=0, atol=1e-6)


def test_get_control_rows_matches_vmap_get_control(tmp_path):
    B = 4
    s = ablate.setup(B, torch.device("cpu"), F64)
    flat = jax_flat([(), (10, 11)], tmp_path)
    tflat = flatten_namedtuple(s.bank)
    for k in flat:  # the port's bank is the JAX build, row for row
        np.testing.assert_allclose(np.asarray(tflat[k])[:2], flat[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    jbank = jax_bank({k: np.tile(v, (B // 2,) + (1,) * (v.ndim - 1)) for k, v in flat.items()})
    cfg_t = ablate.variants()[ablate.FULL]
    cfg_j = jsp.MPCConfig(horizon=15, sqp_iters=3)
    jp = JBodyParams.default(0.1)
    jw = jsp.MPCWeights.from_diagonals(J_TUNING["Q"], J_TUNING["R"])
    x0 = jnp.asarray(np_(s.x0))
    x_ref, u_ref = jnp.asarray(np_(s.x_ref)), jnp.asarray(np_(s.u_ref))
    jwarm = jax.vmap(lambda sc, x: jsp.init_warmstart(jp, sc, cfg_j, j_robot_to_center(sc.r, x)))(
        jbank, x0)
    ref = jax.jit(jax.vmap(lambda sc, x, w: jsp.get_control(jp, sc, jw, cfg_j, x, x_ref,
                                                            u_ref, w)))(jbank, x0, jwarm)
    twarm = tsp.init_warmstart(s.params, s.bank, cfg_t, s.c0)
    out = tsp.get_control_rows(s.params, s.bank, s.weights, cfg_t, s.x0, s.x_ref, s.u_ref,
                               twarm)
    close = lambda a, b, name: np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0,
                                                          atol=1e-6, err_msg=name)
    for name in ("u_phys", "wrench", "c0"):
        close(getattr(out, name), getattr(ref, name), name)
    for name in ("X", "U", "y_hull", "y_term", "rho"):
        close(getattr(out.warm, name), getattr(ref.warm, name), name)
    for name in out.info._fields:
        close(getattr(out.info, name), getattr(ref.info, name), name)


def test_ablate_on_cpu(monkeypatch, tmp_path):
    order = []
    real = ablate.Chain.__call__

    def call(self):
        order.append(self.name)
        real(self)

    real_init = ablate.Chain.__init__

    def init(self, step, x0, warm):
        real_init(self, step, x0, warm)
        self.name = len(names)
        names.append(self)

    names = []
    monkeypatch.setattr(ablate.Chain, "__call__", call)
    monkeypatch.setattr(ablate.Chain, "__init__", init)
    rec = ablate.main(B=4, reps=2, device="cpu", out=tmp_path / "ablate.json")
    # the untimed call of every row, then round 0 in order and round 1 reversed
    assert order == [0, 1, 2, 3, 4] * 2 + [4, 3, 2, 1, 0]
    assert (tmp_path / "ablate.json").exists() and rec["card"] is None
    labels = [r["label"] for r in rec["rows"]]
    assert labels == list(ablate.variants()) + [ablate.SQP_ONLY]
    for r in rec["rows"]:
        assert len(r["ms_rounds"]) == 2 and r["ms_per_batch_step"] > 0
        assert r["ms_per_batch_step"] == pytest.approx(np.median(r["ms_rounds"]))
    assert rec["rows"][0]["config"]["admm_iters"] == 30
    assert rec["rows"][2]["config"]["admm_iters"] == 1
    assert rec["rows"][3]["config"]["ls_alphas"] == [1.0]
    assert rec["rows"][-1]["solves_per_s"] is None and not rec["rows"][-1]["allocation"]
    assert all(v == 0 for v in rec["launches"].values())  # the per-scenario path


def test_chain_is_timed_chains():
    """ablate.py:53-62: the first call on (x0, warm) apart from the chain,
    then x0 + 1e-4 (i + 1) on the previous call's warm start."""
    seen = []

    def step(x, w):
        seen.append((round(float(x), 6), w))
        return torch.zeros(1), w + 1

    c = ablate.Chain(step, torch.tensor(0.0, dtype=F64), 10)
    for _ in range(4):
        c()
    assert seen == [(0.0, 10), (1e-4, 10), (2e-4, 11), (3e-4, 12)]


def test_entry_matches_graft_entry(monkeypatch, tmp_path):
    import __graft_entry__
    import ft_mpc_tpu.api as japi

    flat = jax_flat([(10, 11)], tmp_path)
    scenario = jax.tree.map(lambda a: a[0], jax_bank(flat))
    asked = []

    def built(params, faults, tuning, **kw):
        asked.append(([f.index for f in faults], tuning is J_TUNING))
        return scenario

    monkeypatch.setattr(japi, "_build_scenario_with_terminal", built)
    jfn, jargs = __graft_entry__.entry()
    assert asked == [([10, 11], True)]
    ref = jax.jit(jfn)(*jargs)

    fn, args = dryrun.entry("cpu", F64)
    out = fn(*args)
    assert [tuple(o.shape) for o in out] == [(16,), (6,), ()]
    np.testing.assert_allclose(np_(args[0]), np.asarray(jargs[0]), rtol=0, atol=1e-15)
    for a, b, name in zip(out, ref, ("u_phys", "wrench", "cost")):
        tol = 1e-6 * max(1.0, float(np.abs(np.asarray(b)).max()))  # the cost reads 35
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=tol, err_msg=name)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("fn", [ablate.main, dryrun.entry])
def test_needs_a_card_unless_asked(fn):
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
