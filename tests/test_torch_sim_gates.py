"""The port's closed loop alone meets the JAX package's own behaviour gates.

`tests/test_mpc.py` gates the JAX package's closed loop; the same gates hold
ft_mpc_torch's `rollout` and `rollout_with_fault_schedule` on the CPU in
float64, noise 'none':
  * hover under the demo's double fault (10, 11), quadratic terminal, from
    the demo's initial state, 160 steps (`test_mpc.py:57-80`): the orbit
    centre settles, the solver stays healthy; its first 30 steps are the run
    of `test_mpc.py:94-105`, whose commands respect the fault and the
    thrust bounds;
  * re-convergence (`benchmarks/accuracy.py`): over the final 5 steps the
    port's commands match the JAX package's run within 1e-3 N, although the
    two loops fork early (the closed loop is chaotic);
  * a fault injected at step 15 of 40 (`test_mpc.py:188-212`): thrusters 10
    and 11 are commanded before and never after.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.convert import scenario_from_numpy
from ft_mpc_torch.sim import env as tenv
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.sim import env as jenv
from test_torch_sim import (
    F64,
    _plants,
    demo_flat,
    demo_initial_state,
    healthy_flat,
    hover_refs,
    stack,
)
from torch_parity import jax_bank, np_, t64, torch_bank

torch.set_num_threads(1)

CFG = dict(horizon=15, sqp_iters=3)


def test_hover_converges_under_double_fault():
    jp, tp, jw, tw = _plants()
    flat = demo_flat("quadratic")
    x_ref, u_ref = hover_refs(flat["omega_des"])
    x0 = demo_initial_state()
    hist = tenv.rollout(tp, scenario_from_numpy(flat, device="cpu", dtype=F64), tw,
                        tsp.MPCConfig(**CFG), tenv.SimConfig(steps=160, noise_mode="none"),
                        t64(x0), t64(x_ref), t64(u_ref))
    c0, ref0 = np_(hist.c0), np_(hist.x_ref0)
    cpos_err = np.linalg.norm(c0[:, 0:3] - ref0[:, 0:3], axis=1)
    omega_err = np.linalg.norm(c0[:, 6:9] - ref0[:, 6:9], axis=1)
    assert cpos_err[0] > 1.0
    assert cpos_err[-1] < 0.05
    assert omega_err[-1] < 0.02
    assert float(hist.r_prim.max()) < 5e-2
    assert float(hist.defect[40:].max()) < 1e-3
    assert not bool(torch.isnan(hist.state).any())
    u = np_(hist.u_phys)
    assert np.abs(u[:30, 10:12]).max() < 1e-6
    assert u[:30].min() > -1e-6 and u[:30].max() < 3.4 + 1e-6

    ref = jenv.rollout(jp, jax_bank(flat), jw, jsp.MPCConfig(**CFG),
                       jenv.SimConfig(steps=160, noise_mode="none"), jnp.asarray(x0),
                       jnp.asarray(x_ref), jnp.asarray(u_ref), jax.random.key(0))
    assert np.abs(u[-5:] - np.asarray(ref.u_phys)[-5:]).max() <= 1e-3


def test_mid_trajectory_fault_switch():
    _, tp, _, tw = _plants()
    flat = stack(healthy_flat(), demo_flat("empc"))
    x_ref, u_ref = hover_refs(flat["omega_des"][0])
    x0 = np.zeros(13)
    x0[0:3] = [0.3, 0.1, -0.2]
    x0[9] = 1.0
    hist = tenv.rollout_with_fault_schedule(
        tp, torch_bank(flat), torch.tensor([0, 15]), tw, tsp.MPCConfig(**CFG),
        tenv.SimConfig(steps=40, noise_mode="none"), t64(x0), t64(x_ref), t64(u_ref))
    u = np_(hist.u_phys)
    assert np.isfinite(np_(hist.state)).all()
    assert u[:15, 10:12].max() > 1e-4
    assert np.abs(u[15:, 10:12]).max() < 1e-6
