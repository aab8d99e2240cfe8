"""Polynomial terminal cost (device half) vs the JAX package.

Float64 on both sides, on real snapshot rows whose quartic and sqrt-abs
tables are non-zero; `torch.func.grad/hessian` under `vmap` against
`jax.grad/hessian` under `jax.vmap`.  Tolerance 1e-10 relative: both
differentiate the same closed-form expressions exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.terminal import poly as tpoly
from ft_mpc_tpu.terminal import poly as jpoly
from torch_parity import jax_bank, load_flat, np_, t64, torch_bank

torch.set_num_threads(1)

ROWS = [0, 1, 9, 16, 17, 31]


def _errors(rng, B):
    e = rng.standard_normal((B, 9)) * 0.3
    e[0, 6:9] = 0.0  # exactly at the smoothing point of the sqrt-abs terms
    return e


def test_snapshot_tables_are_nontrivial():
    flat = load_flat(ROWS)
    assert (np.abs(flat["term.poly_c"]).sum(axis=1) > 0).all()
    assert (np.abs(flat["term.sqrt_c"]).sum(axis=1) > 0).all()


@pytest.mark.parametrize(
    "name", ["terminal_value", "terminal_gradient", "terminal_hessian_psd"]
)
def test_terminal_functions_match_jax(rng, name):
    flat = load_flat(ROWS)
    e = _errors(rng, len(ROWS))
    ref = jax.vmap(getattr(jpoly, name))(jax_bank(flat).term, jnp.asarray(e))
    out = torch.func.vmap(getattr(tpoly, name))(torch_bank(flat).term, t64(e))
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(np_(out), np.asarray(ref), rtol=1e-10, atol=1e-10 * scale)


def test_hessian_psd_is_psd(rng):
    flat = load_flat(ROWS)
    e = _errors(rng, len(ROWS)) * 5.0
    H = torch.func.vmap(tpoly.terminal_hessian_psd)(torch_bank(flat).term, t64(e))
    eig = np.linalg.eigvalsh(np_(H))
    assert eig.min() > -1e-9 * max(1.0, np.abs(eig).max())


def test_eigmin_sym3(rng):
    A = rng.standard_normal((10, 3, 3))
    A = A + np.swapaxes(A, 1, 2)
    A[0] = 2.5 * np.eye(3)  # degenerate spectrum branch
    out = torch.func.vmap(tpoly._eigmin_sym3)(t64(A))
    ref = jax.vmap(jpoly._eigmin_sym3)(jnp.asarray(A))
    np.testing.assert_allclose(np_(out), np.asarray(ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np_(out), np.linalg.eigvalsh(A)[:, 0], atol=1e-7)
