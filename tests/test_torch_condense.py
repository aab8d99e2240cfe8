"""Kernel 1 (condensing) vs the JAX package.

On the CPU `condense_lanes` runs its plain version; it is held against the
JAX `condense_lanes` (Pallas in interpret mode, float32 like the kernel)
and the float64 `_condense` scan.  Tolerance: rtol 1e-5 / atol 1e-6 is the
float32 class for a 15-step recursion of 13-term sums.  The CUDA kernel
itself is compared with the plain version on the card in
`tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.controllers import spiraling as tsp
from ft_mpc_torch.solvers import lanes_condense as tlc
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.solvers.lanes_condense import condense_lanes as jax_condense_lanes
from torch_parity import np_, t64

torch.set_num_threads(1)


def _inputs(rng, B=5, Nt=15):
    A = np.eye(13) + 0.08 * rng.standard_normal((B, Nt, 13, 13))
    Bm = 0.1 * rng.standard_normal((B, Nt, 13, 6))
    d = 0.01 * rng.standard_normal((B, Nt, 13))
    return A, Bm, d


def test_condense_lanes_matches_jax(rng):
    A, Bm, d = _inputs(rng)
    S_ref, phi_ref = jax_condense_lanes(jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(d))
    S, phi = tlc.condense_lanes(t64(A), t64(Bm), t64(d))
    assert S.dtype == torch.float64 and S.shape == (5, 15, 13, 90)
    np.testing.assert_allclose(np_(S), np.asarray(S_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(phi), np.asarray(phi_ref), rtol=1e-5, atol=1e-6)


def test_condense_matches_jax_scan(rng):
    A, Bm, d = _inputs(rng, B=3, Nt=8)
    S_ref, phi_ref = jax.vmap(lambda a, b, c: jsp._condense(a, b, c, 8))(
        jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(d)
    )
    # float64 plain recursion (spiraling._condense) vs the float64 scan
    S64, phi64 = tsp._condense(t64(A), t64(Bm), t64(d), 8)
    np.testing.assert_allclose(np_(S64), np.asarray(S_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np_(phi64), np.asarray(phi_ref), rtol=1e-12, atol=1e-12)
    # float32 wrapper vs the float64 scan
    S, phi = tlc.condense_lanes(t64(A), t64(Bm), t64(d))
    np.testing.assert_allclose(np_(S), np.asarray(S_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(phi), np.asarray(phi_ref), rtol=1e-5, atol=1e-6)


def test_condense_lanes_rejects_bad_shapes():
    A = torch.zeros(2, 4, 13, 13)
    with pytest.raises(ValueError):
        tlc.condense_lanes(A, torch.zeros(2, 4, 13, 5), torch.zeros(2, 4, 13))
