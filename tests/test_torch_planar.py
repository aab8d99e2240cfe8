"""The planar model family of ft_mpc_torch (`models/planar.py`) against the
JAX package (`ft_mpc_tpu/models/planar.py`, `tests/test_planar.py`).

The same numpy inputs go through both packages on the CPU (float64, x64):
  * `build_thruster_matrix_2d`, `planar_body_params` (float64 and float32)
    and `planar_fault` equal the JAX ones exactly;
  * the degenerate-zonotope `contains` cases of `tests/test_planar.py:31-53`
    through each package's zonotope and `Polytope`;
  * the (6) stuck-on planar scenario, built in float64 from the committed
    terminal cache (`430452967a573a9e.npz`, read from a scratch copy) by
    each package, equal leaf for leaf;
  * the JAX test's planar hover (`tests/test_planar.py:56-86`: (6), horizon
    12, 2 SQP iterations, no noise) on the per-scenario path: the port's
    `rollout` follows the JAX one at 1e-6 for the first steps, and both keep
    the JAX test's invariance (z, roll and pitch rates) and never command
    the absent thrusters.
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.api import DEFAULT_TUNING, TERMINAL_CACHE, build_scenario_with_terminal
from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import flatten_namedtuple
from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope as t_wrench
from ft_mpc_torch.geometry.zonotope import zonotope_halfspaces as t_zono
from ft_mpc_torch.models import planar as tpl
from ft_mpc_torch.ops.dynamics import FaultState, fault_arrays
from ft_mpc_torch.sim import env as tenv
from ft_mpc_torch.utils import trajectory as ttraj
from ft_mpc_torch.utils.faults import BrokenThruster as TBroken
from ft_mpc_tpu.api import _build_scenario_with_terminal as j_build
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.geometry.zonotope import attainable_wrench_polytope as j_wrench
from ft_mpc_tpu.geometry.zonotope import zonotope_halfspaces as j_zono
from ft_mpc_tpu.models import planar as jpl
from ft_mpc_tpu.sim import env as jenv
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import F64, np_, t64

torch.set_num_threads(1)

STEPS = 8  # closed-loop steps of the hover held on both packages
FOLLOW = 4  # steps over which the port's loop follows the JAX loop at 1e-6


def test_planar_matrix_and_params_match_jax(monkeypatch):
    np.testing.assert_array_equal(tpl.build_thruster_matrix_2d(),
                                  jpl.build_thruster_matrix_2d())
    np.testing.assert_array_equal(tpl.build_thruster_matrix_2d(0.2),
                                  jpl.build_thruster_matrix_2d(0.2))
    assert tpl.PLANAR_ABSENT_THRUSTERS == jpl.PLANAR_ABSENT_THRUSTERS == tuple(range(8, 16))
    jp = jpl.planar_body_params(0.1)  # x64: float64 leaves
    for dtype in (torch.float64, torch.float32):
        tp = tpl.planar_body_params(0.1, dtype=dtype, device="cpu")
        assert tp._fields == jp._fields
        for name in tp._fields:
            got = getattr(tp, name)
            want = np.asarray(getattr(jp, name)).astype(np_(got).dtype)
            assert got.dtype == dtype, name
            np.testing.assert_array_equal(np_(got), want, err_msg=name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # the default device is CUDA
        tpl.planar_body_params(0.1)


def test_planar_fault_matches_jax():
    for faults in ([], [(6, 1.0)], [(2, 0.5), (5, 1.0)]):
        t = tpl.planar_fault([TBroken(i, s) for i, s in faults])
        j = jpl.planar_fault([JBroken(i, s) for i, s in faults])
        assert [(f.index, f.intensity) for f in t] == [(f.index, f.intensity) for f in j]
        assert len(t) == len(faults) + 8
    with pytest.raises(ValueError, match="thrusters 0-7"):
        tpl.planar_fault([TBroken(8, 1.0)])


def test_degenerate_zonotope_contains_matches_jax():
    """tests/test_planar.py:31-53 through both packages."""
    D = tpl.build_thruster_matrix_2d()
    broken, intensity = fault_arrays(tpl.planar_fault([]))
    polys = (t_wrench(D, 1.75, broken, intensity), j_wrench(D, 1.75, broken, intensity))
    for x, want in (([0.0] * 6, True), ([0, 0, 0.1, 0, 0, 0], False),
                    ([1.0, 0, 0, 0, 0, 0], True), ([20.0, 0, 0, 0, 0, 0], False)):
        assert [P.contains(np.asarray(x, dtype=float)) for P in polys] == [want, want], x
    np.testing.assert_array_equal(polys[0].A, polys[1].A)
    np.testing.assert_array_equal(polys[0].b, polys[1].b)
    # rank-2 zonotope in 3-d: facets + equality rows
    G = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
    zs = (t_zono(np.zeros(3), G), j_zono(np.zeros(3), G))
    for x, want in (([0.5, 0.5, 0.0], True), ([0.5, 0.5, 0.1], False),
                    ([1.5, 0.5, 0.0], False)):
        assert [Z.contains(x) for Z in zs] == [want, want], x


@pytest.fixture(scope="module")
def cache_copy(tmp_path_factory):
    """A scratch copy of the committed cache; only read (the (6) entry hits)."""
    copy = tmp_path_factory.mktemp("planar") / "terminal_cache"
    shutil.copytree(TERMINAL_CACHE, copy)
    return copy


@pytest.fixture(scope="module")
def stuck6(cache_copy):
    """The (6) planar scenario built by each package in float64."""
    before = sorted(p.name for p in cache_copy.iterdir())
    tp = tpl.planar_body_params(0.1, dtype=F64, device="cpu")
    tsc = build_scenario_with_terminal(tp, tpl.planar_fault([TBroken(6, 1.0)]),
                                       DEFAULT_TUNING, cache_dir=cache_copy, device="cpu",
                                       dtype=F64)
    jp = jpl.planar_body_params(0.1)
    jsc = j_build(jp, jpl.planar_fault([JBroken(6, 1.0)]), DEFAULT_TUNING,
                  cache_dir=str(cache_copy))
    assert sorted(p.name for p in cache_copy.iterdir()) == before  # both hit
    assert "430452967a573a9e.npz" in before
    return tp, tsc, jp, jsc


def test_planar_scenario_from_cache_matches_jax(stuck6):
    _, tsc, _, jsc = stuck6
    got, want = flatten_namedtuple(tsc), flatten_namedtuple(jsc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the planar geometry: absent thrusters dead, a degenerate hull
    np.testing.assert_array_equal(got["fault.broken"][8:], 1.0)
    np.testing.assert_array_equal(got["u_ub"][8:], 0.0)
    assert 0 < got["hull_mask"].sum() < len(got["hull_mask"])


def test_planar_hover_follows_jax(stuck6):
    """tests/test_planar.py:56-86, cut to STEPS steps: the port's rollout
    against the JAX one, and the JAX test's gates on both."""
    tp, tsc, jp, jsc = stuck6
    Q, R = DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"]
    traj = ttraj.generate_trajectory("hover", 0.1, 20)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, np_(tsc.omega_des),
                                                   float(tp.mass), 0.1, 13)
    x0 = np.zeros(13)
    x0[0:2] = [0.5, -0.3]
    x0[9] = 1.0
    jh = jenv.rollout(jp, jsc, jsp.MPCWeights.from_diagonals(Q, R),
                      jsp.MPCConfig(horizon=12, sqp_iters=2),
                      jenv.SimConfig(steps=STEPS, noise_mode="none"), jnp.asarray(x0),
                      jnp.asarray(x_ref), jnp.asarray(u_ref), jax.random.key(0))
    th = tenv.rollout(tp, tsc, tsp.MPCWeights.from_diagonals(Q, R, dtype=F64, device="cpu"),
                      tsp.MPCConfig(horizon=12, sqp_iters=2),
                      tenv.SimConfig(steps=STEPS, noise_mode="none"), t64(x0), t64(x_ref),
                      t64(u_ref))
    for name in ("state", "u_phys", "wrench", "c0"):
        np.testing.assert_allclose(np_(getattr(th, name))[:FOLLOW],
                                   np.asarray(getattr(jh, name))[:FOLLOW], rtol=0,
                                   atol=1e-6, err_msg=name)
    for state, u in ((np_(th.state), np_(th.u_phys)),
                     (np.asarray(jh.state), np.asarray(jh.u_phys))):
        assert np.isfinite(state).all()
        assert np.abs(state[:, 2]).max() < 1e-4  # planar invariance
        assert np.abs(state[:, 10:12]).max() < 1e-5
        assert np.abs(u[:, 8:]).max() < 1e-9  # absent thrusters never commanded


def test_package_exports_and_healthy_fault_match_jax():
    """`ft_mpc_tpu/__init__.py:26-27`'s exports, and `FaultState.healthy`."""
    import ft_mpc_torch
    import ft_mpc_tpu
    from ft_mpc_tpu.ops.dynamics import FaultState as JFaultState

    for name in ("BrokenThruster", "BodyParams", "build_thruster_matrix"):
        assert getattr(ft_mpc_torch, name).__name__ == getattr(ft_mpc_tpu, name).__name__
    np.testing.assert_array_equal(ft_mpc_torch.build_thruster_matrix(),
                                  ft_mpc_tpu.build_thruster_matrix())
    assert ft_mpc_torch.BrokenThruster is TBroken
    h, jh = FaultState.healthy(device="cpu", dtype=F64), JFaultState.healthy()
    for name in ("broken", "intensity"):
        assert getattr(h, name).dtype == F64
        np.testing.assert_array_equal(np_(getattr(h, name)), np.asarray(getattr(jh, name)))
    assert FaultState.healthy(device="cpu").broken.dtype == torch.float32
