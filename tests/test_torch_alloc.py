"""Kernel 3 (thruster allocation) vs the JAX package.

Snapshot rows cover the healthy plant, single faults and double faults
(every fault of the bench bank pins its thruster: u_ub = 0).  Wrench
demands are half small (feasible) and half large (clipped by the FISTA
projection).  Tolerances as the JAX suite's own kernel test
(`tests/test_lanes_alloc.py:69-78`): wrench_clipped atol 2e-5, u_phys and
r_prim atol 2e-3 (fp32 iteration-order noise).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.ops.dynamics import BodyParams
from ft_mpc_torch.solvers import lanes_alloc as tla
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.solvers import lanes_alloc as jla
from torch_parity import jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

ROWS = [0, 1, 5, 10, 11, 16, 17, 22, 30, 31] * 2


def _call(mod, bank, params, wr):
    return mod.allocate_thrusters_lanes(
        wr, params.D, bank.u_ub, bank.faulty_force_gen, bank.hull_A, bank.hull_b,
        bank.hull_mask, bank.gen_G, bank.gen_c, bank.gen_L, params.max_thrust,
    )


def test_allocation_matches_jax(rng):
    flat = load_flat(ROWS)
    B = len(ROWS)
    wr = np.concatenate(
        [rng.uniform(-0.5, 0.5, (B // 2, 6)), rng.uniform(-6, 6, (B - B // 2, 6))]
    )
    ref = _call(jla, jax_bank(flat), JBodyParams.default(0.1), jnp.asarray(wr))
    out = _call(tla, torch_bank(flat),
                BodyParams.default(0.1, dtype=torch.float64, device="cpu"), t64(wr))
    assert out.u_phys.dtype == torch.float64
    was = np_(out.was_clipped)
    assert 0 < was.sum() < B  # both branches of the hull test
    assert (flat["u_ub"] == 0).any(axis=1).sum() >= B // 2  # pinned thrusters
    np.testing.assert_array_equal(was, np.asarray(ref.was_clipped))
    np.testing.assert_array_equal(np_(out.used_fallback), np.asarray(ref.used_fallback))
    np.testing.assert_allclose(np_(out.wrench_clipped), np.asarray(ref.wrench_clipped), atol=2e-5)
    np.testing.assert_allclose(np_(out.u_phys), np.asarray(ref.u_phys), atol=2e-3)
    np.testing.assert_allclose(np_(out.r_prim), np.asarray(ref.r_prim), atol=2e-3)


def test_hull_test_threshold_matches_jax():
    """Demands two float32 error bounds either side of the hull test's margin
    (chip_smoke.facet_demands), on every pattern of the bank: the port and
    the JAX kernel must both give the exact (float64) answer on each row that
    is off the threshold.  The same demands hold the CUDA kernel on the card."""
    from chip_smoke import facet_demands, hull_truth

    flat = load_flat(list(range(32)) * 2)
    bank = torch_bank(flat)
    params = BodyParams.default(0.1, dtype=torch.float64, device="cpu")
    f32 = lambda t: t.float()
    hA = f32(bank.hull_A * bank.hull_mask[:, :, None])
    hb = f32(torch.where(bank.hull_mask > 0.5, bank.hull_b, tla._BIG))
    ff = f32(bank.faulty_force_gen)
    wr = facet_demands(hA, hb, f32(bank.gen_G), f32(bank.gen_c), ff,
                       np.random.default_rng(3)).float()
    clipped, on_thr = hull_truth(hA, hb, wr, ff)
    assert int((~on_thr).sum()) >= 60 and 0 < int(clipped.sum()) < 64
    out = _call(tla, bank, params, wr.double())
    ref = _call(jla, jax_bank(flat), JBodyParams.default(0.1), jnp.asarray(np_(wr.double())))
    off = np_(~on_thr)
    np.testing.assert_array_equal(np_(out.was_clipped)[off], np_(clipped)[off])
    np.testing.assert_array_equal(np.asarray(ref.was_clipped)[off], np_(clipped)[off])


def test_gauss_jordan6_matches_jax(rng):
    M = rng.standard_normal((5, 6, 6))
    W = np.einsum("bij,bkj->bik", M, M) + 0.5 * np.eye(6)
    ref = jla._gauss_jordan6(jnp.moveaxis(jnp.asarray(W), 0, -1))
    out = tla._gauss_jordan6(t64(W))
    np.testing.assert_allclose(np_(out), np.moveaxis(np.asarray(ref), -1, 0), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", W, np_(out)),
                               np.broadcast_to(np.eye(6), W.shape), atol=1e-9)


def test_allocation_rejects_bad_shapes():
    flat = load_flat([0, 1])
    bank = torch_bank(flat)
    params = BodyParams.default(0.1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):
        _call(tla, bank, params, torch.zeros(2, 5, dtype=torch.float64))
