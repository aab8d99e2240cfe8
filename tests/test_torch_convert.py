"""`ft_mpc_torch.convert`: the JAX package's containers carried across.

Leaves of the JAX `BodyParams`, `MPCWeights`, `WarmStart` and `Scenario`
go through a flat field-path dict into the port's containers and must
arrive unchanged (float64 here; the terminal power tables stay int32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch import convert
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.ops.dynamics import robot_to_center as j_robot_to_center
from torch_parity import F64, gentle_states, jax_bank, load_flat, np_

torch.set_num_threads(1)


def _same(port_tree, jax_tree):
    for name in jax_tree._fields:
        a, b = getattr(port_tree, name), getattr(jax_tree, name)
        if b is None:
            assert a is None, name
        elif hasattr(b, "_fields"):
            _same(a, b)
        else:
            np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=name)


def test_body_params_and_weights():
    jp = JBodyParams.default(0.1)
    tp = convert.body_params_from_numpy(convert.flatten_namedtuple(jp), "cpu", F64)
    _same(tp, jp)
    x_ub = np.full(13, 1e8)
    x_ub[3] = 0.2
    jw = jsp.MPCWeights.from_diagonals([1] * 9, [0.1] * 6, x_ub=x_ub)
    flat = convert.flatten_namedtuple(jw)
    assert sorted(flat) == ["Q", "R", "x_ub"]  # None leaves are dropped
    tw = convert.weights_from_numpy(flat, "cpu", F64)
    _same(tw, jw)
    assert tw.x_lb is None and tw.du_max is None and tw.has_state_box


def test_scenario_and_warmstart():
    flat = load_flat([0, 17, 31])
    jb = jax_bank(flat)
    tb = convert.scenario_from_numpy(convert.flatten_namedtuple(jb), "cpu", F64)
    _same(tb, jb)
    assert tb.term.poly_pow.dtype == torch.int32
    cfg = jsp.MPCConfig(horizon=4)
    jp = JBodyParams.default(0.1)
    weights = jsp.MPCWeights.from_diagonals([1] * 9, [0.1] * 6)
    x0 = jnp.asarray(gentle_states(3))
    u_ref = jnp.zeros((5, 6))
    x_ref = jnp.zeros((5, 9))
    c0 = jax.vmap(j_robot_to_center)(jb.r, x0)
    jw = jsp.init_warmstart_batch(jp, jb, weights, cfg, c0, x_ref, u_ref)
    tw = convert.warmstart_from_numpy(convert.flatten_namedtuple(jw), "cpu", F64)
    assert tw.kinv.dtype == torch.float32 and tw.X.dtype == F64
    np.testing.assert_array_equal(np_(tw.X), np.asarray(jw.X))
    np.testing.assert_array_equal(np_(tw.kinv), np.asarray(jw.kinv).astype(np.float32))


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flat = convert.flatten_namedtuple(JBodyParams.default(0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.body_params_from_numpy(flat)
