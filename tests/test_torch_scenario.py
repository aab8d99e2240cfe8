"""The port builds its own scenario banks, leaf for leaf as the JAX package.

* `cache_key` equals the JAX key for all 137 patterns of the bench's census
  (healthy, 16 singles, 120 doubles) x {DEFAULT_TUNING, the reactive.yaml
  tuning} x {float32, float64 plant}; the 137 float32 DEFAULT_TUNING keys
  all hit the terminal cache, and the port builds every one of them.
* `build_scenario_with_terminal` in modes 'empc' (from the cache: default
  orbits, searched orbits and the quadratic fallbacks), 'quadratic' and
  '<path>.yaml', `build_scenario_bank` and `build_randomized_bank` (bank,
  per-row plant and states from one seed) equal the JAX package's exactly.
* The port's builds equal the committed snapshots `bench_bank32.npz` and
  both rows of `demo_bank.npz`.
* One control step on a 4-row bank that the port built (per-row mass and
  inertia) agrees with the JAX package on the same bank, at the JAX suite's
  own tolerance for two backends of this step (u_phys and wrench atol
  2e-2 N, `tests/test_lanes.py:174-178`).

The JAX side reads a scratch copy of the terminal cache, so neither package
can write the repo's cache; the test also checks the port leaves it as it
found it.
"""

from __future__ import annotations

import shutil
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch import api as tapi
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.geometry import scenario as tsc
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.ops.dynamics import robot_to_center as t_robot_to_center
from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig as TCfg
from ft_mpc_torch.terminal import pipeline as tpipe
from ft_mpc_torch.terminal.poly import assemble_terminal_poly
from ft_mpc_torch.utils.config import load_config as t_load_config
from ft_mpc_torch.utils.faults import BrokenThruster as TBroken
from ft_mpc_tpu import api as japi
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.geometry import scenario as jsc
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg
from ft_mpc_tpu.terminal import pipeline as jpipe
from ft_mpc_tpu.utils.config import load_config as j_load_config
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import F64, gentle_states, jax_bank, np_, t64

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "ft_mpc_tpu" / "config" / "terminal_cache"
F32 = torch.float32


@contextmanager
def jax_x64(flag: bool):
    """The JAX package's scenario dtype follows jax_enable_x64 (float32 off)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", flag)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A scratch copy of the terminal cache for the JAX side."""
    cache = tmp_path_factory.mktemp("cache") / "terminal_cache"
    shutil.copytree(CACHE, cache)
    return cache


def census(cls=TBroken):
    """The 137 patterns of bench.py's census, in its order."""
    pats = [[]]
    pats += [[cls(i, 1.0)] for i in range(16)]
    pats += [[cls(i, 1.0), cls(j, 1.0)] for i in range(16) for j in range(i + 1, 16)]
    return pats


def as_jax(pattern):
    return [JBroken(f.index, f.intensity) for f in pattern]


def tunings():
    reactive = {**japi.DEFAULT_TUNING, **j_load_config(None).tuning}
    assert reactive == {**tapi.DEFAULT_TUNING, **t_load_config(None).tuning}
    return {"default": japi.DEFAULT_TUNING, "reactive": reactive}


def params_pair(x64: bool):
    """The JAX plant (float32 with x64 off) and the port's of the same dtype."""
    with jax_x64(x64):
        jp = JBodyParams.default(0.1)
    return jp, TBodyParams.default(0.1, dtype=F64 if x64 else F32, device="cpu")


def assert_same_leaves(port, ref):
    """Every leaf equal.  The JAX package keeps the fault mask float64 in
    either mode, the port casts every float leaf to its dtype: the JAX leaf
    is rounded to the port's dtype first (a no-op for every other leaf)."""
    a, b = flatten_namedtuple(port), flatten_namedtuple(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        want = b[k].astype(a[k].dtype) if a[k].dtype.kind == "f" else b[k]
        np.testing.assert_array_equal(a[k], want, err_msg=k)


@pytest.mark.parametrize("tuning", ["default", "reactive"])
@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_cache_keys_match_jax(tuning, x64):
    tun = tunings()[tuning]
    jp, tp = params_pair(x64)
    jfp, tfp = jpipe.plant_fingerprint(jp), tpipe.plant_fingerprint(tp)
    assert tfp == jfp
    for pat in census():
        assert tpipe.cache_key(pat, tun, tfp) == jpipe.cache_key(as_jax(pat), tun, jfp)


def test_port_builds_every_default_tuning_class(tmp_path, monkeypatch):
    """All 137 float32 DEFAULT_TUNING keys hit the cache: 81 searched orbits
    and 4 quadratic fallbacks among them.  A miss (the float64 plant's key
    of a single fault) is computed by the offline pipeline into the port's
    own cache, here a temporary directory, and the committed cache is left
    as it was."""
    before = sorted((p.name, p.stat().st_mtime_ns) for p in CACHE.iterdir())
    tp = TBodyParams.default(0.1, dtype=F32, device="cpu")
    metas = [tpipe.load_terminal_ingredients(
        tapi.terminal_cache_path(tp, pat, tapi.DEFAULT_TUNING)).meta for pat in census()]
    searched = [m for m in metas if "fallback" not in m and not m["orbit"]["is_default"]]
    assert len(searched) == 81 and sum("fallback" in m for m in metas) == 4
    bank = tsc.stack_scenarios(
        [tapi.build_scenario_with_terminal(tp, pat, tapi.DEFAULT_TUNING, device="cpu")
         for pat in census()], device="cpu")
    assert bank.size == 137 and bank.scenarios.hull_A.shape == (137, 32, 6)
    for k, v in flatten_namedtuple(bank.scenarios).items():
        assert np.isfinite(v).all(), k
    tp64 = TBodyParams.default(0.1, dtype=F64, device="cpu")
    monkeypatch.setattr(tapi, "PORT_TERMINAL_CACHE", tmp_path)
    miss = census()[12]  # thruster 11: certified at the default orbit
    assert tapi.cached_terminal_path(tp64, miss, tapi.DEFAULT_TUNING) is None
    sc = tapi.build_scenario_with_terminal(tp64, miss, tapi.DEFAULT_TUNING, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [
        tapi.terminal_cache_path(tp64, miss, tapi.DEFAULT_TUNING).name]
    assert bool(torch.isfinite(sc.term.P).all()) and float(sc.term_mask.sum()) > 0
    assert sorted((p.name, p.stat().st_mtime_ns) for p in CACHE.iterdir()) == before


def _empc_rows():
    """Healthy, a single, a double on the default orbit, two searched
    orbits, two quadratic fallbacks."""
    return [0, 5, 17, 9, 40, 131, 136]


@pytest.mark.parametrize("row", _empc_rows())
def test_build_with_terminal_empc_matches_jax(jax_cache, row):
    pat = census()[row]
    jp, tp = params_pair(False)
    with jax_x64(False):
        ref = japi._build_scenario_with_terminal(jp, as_jax(pat), japi.DEFAULT_TUNING,
                                                 cache_dir=str(jax_cache))
    got = tapi.build_scenario_with_terminal(tp, pat, tapi.DEFAULT_TUNING, device="cpu",
                                            dtype=F32)
    assert got.hull_A.dtype == F32
    assert_same_leaves(got, ref)


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_build_with_terminal_quadratic_matches_jax(x64):
    jp, tp = params_pair(x64)
    for pat in (census()[0], census()[3], census()[60]):
        with jax_x64(x64):
            ref = japi._build_scenario_with_terminal(jp, as_jax(pat), japi.DEFAULT_TUNING,
                                                     terminal_mode="quadratic")
        got = tapi.build_scenario_with_terminal(tp, pat, tapi.DEFAULT_TUNING,
                                                terminal_mode="quadratic", device="cpu",
                                                dtype=F64 if x64 else F32)
        assert_same_leaves(got, ref)


def write_reference_yaml(path: Path) -> None:
    """A terminal.yaml in the reference's format: the cost as a lambdify
    string over the nine error symbols, the terminal set as JSON."""
    import json

    import sympy as sp
    import yaml

    from ft_mpc_torch.controllers.spiral_params import SpiralParameters

    spp = SpiralParameters.compute(16.8, np.diag([0.2, 0.3, 0.25]), np.zeros(6))
    rng = np.random.default_rng(5)
    P = rng.standard_normal((9, 9))
    term = assemble_terminal_poly(P @ P.T, rng.standard_normal(9), 0.25, 16.8,
                                  np.diag([0.2, 0.3, 0.25]), spp.r, spp.omega_des,
                                  np.eye(9), np.ones(3), 0.8, 0.3)
    syms = sp.symbols("ep1 ep2 ep3 ev1 ev2 ev3 eo1 eo2 eo3")
    e = sp.Matrix(syms)
    expr = (e.T * sp.Matrix(term.P) * e)[0] + sum(float(a) * s for a, s in zip(term.p, syms))
    expr += float(term.c)
    eo = syms[6:9]
    mono = lambda pw: sp.Mul(*[v ** int(k) for v, k in zip(eo, pw)])
    for c, pw in zip(term.poly_c, term.poly_pow):
        if c:
            expr += float(c) * mono(pw)
    for c, pw in zip(term.sqrt_c, term.sqrt_pow):
        if c:
            expr += float(c) * (mono(pw) + sp.Float(1e-6)) ** sp.Float(0.25)
    cost = f"lambdify(({', '.join(map(str, syms))}), {expr}, modules='numpy')"
    A = np.vstack([np.eye(9), -np.eye(9)])
    ts = json.dumps({"A": A.tolist(), "b": np.full(18, 0.5).tolist()})
    path.write_text(yaml.safe_dump({"cost": cost, "term_set": ts}))


def test_build_with_terminal_yaml_matches_jax(tmp_path):
    path = tmp_path / "terminal.yaml"
    write_reference_yaml(path)
    jp, tp = params_pair(True)
    pat = census()[20]
    ref = japi._build_scenario_with_terminal(jp, as_jax(pat), japi.DEFAULT_TUNING,
                                             terminal_mode=str(path))
    got = tapi.build_scenario_with_terminal(tp, pat, tapi.DEFAULT_TUNING,
                                            terminal_mode=str(path), device="cpu", dtype=F64)
    assert float(got.term.sqrt_c.abs().sum()) > 0 and float(got.term_mask.sum()) == 18
    assert_same_leaves(got, ref)
    with pytest.raises(ValueError):
        tapi.build_scenario_with_terminal(tp, pat, tapi.DEFAULT_TUNING,
                                          terminal_mode="lqr", device="cpu")


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_build_scenario_bank_matches_jax(x64):
    pats = [census()[i] for i in (0, 2, 30, 100)] + [[TBroken(4, 0.35)]]
    jp, tp = params_pair(x64)
    with jax_x64(x64):
        ref = jsc.build_scenario_bank(jp, [as_jax(p) for p in pats])
    got = tsc.build_scenario_bank(tp, pats, device="cpu", dtype=F64 if x64 else F32)
    assert got.size == ref.size == len(pats)
    assert_same_leaves(got.scenarios, ref.scenarios)
    assert_same_leaves(got[2], ref[2])


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_randomized_bank_matches_jax(x64):
    jp, tp = params_pair(x64)
    with jax_x64(x64):
        jbank, jparams, jx0 = jsc.build_randomized_bank(jp, 8, seed=3)
    bank, params, x0 = tsc.build_randomized_bank(tp, 8, seed=3, device="cpu",
                                                 dtype=F64 if x64 else F32)
    assert_same_leaves(bank.scenarios, jbank.scenarios)
    assert params.mass.shape == (8,) and params.inertia.shape == (8, 3, 3)
    for a, b in zip(params, jparams):
        assert a.dtype == (F64 if x64 else F32)
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    np.testing.assert_array_equal(np_(x0), jx0)


def test_port_builds_equal_committed_snapshots():
    tp = TBodyParams.default(0.1, dtype=F32, device="cpu")
    bench = tsc.stack_scenarios(
        [tapi.build_scenario_with_terminal(tp, pat, tapi.DEFAULT_TUNING, device="cpu")
         for pat in census()[:32]], device="cpu", dtype=F64)
    demo_tuning = {**tapi.DEFAULT_TUNING, **t_load_config(None).tuning}
    demo = tsc.stack_scenarios(
        [tapi.build_scenario_with_terminal(tp, [TBroken(10, 1.0), TBroken(11, 1.0)],
                                           demo_tuning, terminal_mode=mode, device="cpu")
         for mode in tsc.DEMO_TERMINAL_MODES], device="cpu", dtype=F64)
    for bank, path in ((bench, tsc.BENCH_BANK), (demo, tsc.DEMO_BANK)):
        with np.load(path) as z:
            snap = {k: z[k] for k in z.files}
        got = flatten_namedtuple(bank.scenarios)
        assert sorted(got) == sorted(snap)
        for k in snap:
            assert got[k].dtype == snap[k].dtype, k
            np.testing.assert_array_equal(got[k], snap[k], err_msg=k)


def test_control_step_on_port_built_bank_matches_jax():
    """A randomized bank built by the port (4 rows, float64, per-row mass
    and inertia), one cold init and one step through both packages, as
    `tests/test_torch_spiraling.py` runs it on the snapshot."""
    B, NT = 4, 8
    tp = TBodyParams.default(0.1, dtype=F64, device="cpu")
    bank, params, _ = tsc.build_randomized_bank(tp, B, seed=5, device="cpu", dtype=F64)
    flat = flatten_namedtuple(bank.scenarios)
    jbank = jax_bank(flat)
    jparams = JBodyParams(*(jnp.asarray(np_(x)) for x in params))
    Q, R = japi.DEFAULT_TUNING["Q"], japi.DEFAULT_TUNING["R"]
    jw = jsp.MPCWeights.from_diagonals(Q, R)
    tw = tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu")
    kw = dict(horizon=NT, sqp_iters=2, newton_iters=3, cleanup_iters=40, cleanup_k=2,
              cleanup_phases=2)
    admm = dict(iters=30, phases=1, rho=50.0, adapt_clip=1.5)
    jcfg, tcfg = jsp.MPCConfig(admm=JCfg(**admm), **kw), tsp.MPCConfig(admm=TCfg(**admm), **kw)
    from ft_mpc_torch.utils.trajectory import generate_trajectory, prepare_center_trajectory

    x_ref, u_ref = prepare_center_trajectory(generate_trajectory("hover", 0.1, 5),
                                             np.array([0.0, 0.0, 0.6]), 16.8, 0.1, NT + 1)
    x_ref, u_ref = x_ref[: NT + 1], u_ref[: NT + 1]
    x0 = gentle_states(B, seed=2)

    jx0 = jnp.asarray(x0)
    jc0 = jax.vmap(j_robot_to_center)(jbank.r, jx0)
    jargs = (jparams, jbank, jw, jcfg)
    jwarm = jax.jit(jsp.init_warmstart_batch, static_argnums=(3,))(
        *jargs, jc0, jnp.asarray(x_ref), jnp.asarray(u_ref))
    ref = jax.jit(jsp.get_control_batch, static_argnums=(3,))(
        *jargs, jx0, jnp.asarray(x_ref), jnp.asarray(u_ref), jwarm)

    tx0 = t64(x0)
    targs = (params, bank.scenarios, tw, tcfg)
    twarm = tsp.init_warmstart_batch(*targs, t_robot_to_center(bank.scenarios.r, tx0),
                                     t64(x_ref), t64(u_ref))
    out = tsp.get_control_batch(*targs, tx0, t64(x_ref), t64(u_ref), twarm)
    assert torch.isfinite(out.u_phys).all()
    np.testing.assert_allclose(np_(out.c0), np.asarray(ref.c0), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np_(out.wrench), np.asarray(ref.wrench), atol=2e-2)
    np.testing.assert_allclose(np_(out.u_phys), np.asarray(ref.u_phys), atol=2e-2)
    np.testing.assert_array_equal(np_(out.alloc.was_clipped), np.asarray(ref.alloc.was_clipped))
