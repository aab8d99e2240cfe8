"""The terminal terms' wrapper `ops.terminal.terminal_lanes` on the CPU.

On CPU tensors it runs `terminal_plain` (the per-scenario functions under
`torch.func.vmap`, the expressions the controller called before the kernel
`csrc/terminal.cu`), counts a plain call and no launch, and checks every
input before either path runs.  In float64 it matches the JAX package's
`terminal_value` / `terminal_gradient` / `terminal_hessian_psd` under
`jax.vmap` at 1e-10 on committed terminal-cache entries, on rows where the
PSD shift of the omega block is active and rows where it is not.  The
kernel itself is held against `terminal_plain` on the card
(`tests/test_torch_cuda.py`).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_mpc_torch.ops import terminal as ot
from ft_mpc_torch.terminal import poly as tpoly
from ft_mpc_torch.terminal.pipeline import load_terminal_ingredients
from ft_mpc_tpu.terminal import poly as jpoly
from torch_parity import np_

torch.set_num_threads(1)

CACHE = Path(__file__).resolve().parents[1] / "ft_mpc_tpu" / "config" / "terminal_cache"
ROWS = 24  # committed entries, in name order: polynomial and quadratic-only tables
NA = 3  # the line search's candidates


def cache_tables(rows=ROWS) -> tpoly.TerminalPoly:
    """The padded tables of the first `rows` committed cache entries, as numpy
    leaves with a leading row axis."""
    terms = [tpoly.pad_terminal_poly(load_terminal_ingredients(f).term)
             for f in sorted(CACHE.glob("*.npz"))[:rows]]
    return tpoly.TerminalPoly(*[np.stack([np.asarray(getattr(t, k)) for t in terms])
                                for k in tpoly.TerminalPoly._fields])


def torch_tables(tab, dtype=torch.float64) -> tpoly.TerminalPoly:
    return tpoly.TerminalPoly(*[
        torch.as_tensor(v, dtype=torch.int32 if k.endswith("_pow") else dtype)
        for k, v in tab._asdict().items()])


def errors(rng, shape, omega=0.1):
    """Terminal errors: positions and velocities of 0.3, omega errors of
    `omega` (where the sqrt-abs terms' concavity makes the shift active on
    most rows), one row exactly at the smoothing point."""
    e = rng.standard_normal((*shape, 9)) * 0.3
    e[..., 6:9] *= omega / 0.3
    e[..., 0, 6:9] = 0.0
    return e


def shift_active(term, e):
    """Rows whose omega block is shifted: lambda_min of the extra terms'
    Hessian below 0."""
    lam = torch.func.vmap(lambda t, w: tpoly._eigmin_sym3(
        torch.func.hessian(lambda x: tpoly._extra_value(t, x))(w)))
    return lam(term, e[..., 6:9]) < 0


@pytest.fixture(scope="module")
def tab():
    return cache_tables()


@pytest.mark.parametrize("derivs,lead", [(False, ()), (False, (NA,)), (True, ())],
                         ids=["value", "candidates", "derivs"])
def test_terminal_lanes_runs_plain_on_cpu(tab, derivs, lead):
    """CPU tensors take `terminal_plain`, count a plain call and no launch,
    and give exactly what the controller's vmap expressions gave."""
    term = torch_tables(tab)
    e = torch.as_tensor(errors(np.random.default_rng(1), (*lead, ROWS)))
    n_launch, n_plain = ot.terminal_lanes.launches, ot.terminal_lanes.plain_calls
    out = ot.terminal_lanes(term, e, derivs=derivs)
    assert ot.terminal_lanes.plain_calls == n_plain + 1
    assert ot.terminal_lanes.launches == n_launch
    vm = torch.func.vmap
    if not derivs:
        value = vm(tpoly.terminal_value)
        old = value(term, e) if not lead else vm(value, in_dims=(None, 0))(term, e)
        assert out.shape == (*lead, ROWS) and torch.equal(out, old)
        return
    V, g, H = out
    assert torch.equal(V, vm(tpoly.terminal_value)(term, e))
    assert torch.equal(g, vm(tpoly.terminal_gradient)(term, e))
    assert torch.equal(H, vm(tpoly.terminal_hessian_psd)(term, e))


def _bad(case, term, e):
    """The inputs with one of them made wrong as `case` says."""
    if case == "e_width":
        e = e[..., :8].contiguous()
    elif case == "e_rank":
        e = e[0]
    elif case == "e_rows":
        e = e[:-1]
    elif case == "e_strided":
        e = torch.cat([e, e], dim=-1)[..., :9]
    elif case == "e_dtype":
        e = e.float()
    elif case == "e_device":
        e = torch.empty(e.shape, dtype=e.dtype, device="meta")
    elif case == "P_shape":
        term = term._replace(P=term.P[:, :, :8].contiguous())
    elif case == "c_shape":
        term = term._replace(c=term.c[:, None])
    elif case == "app_rows":
        term = term._replace(app=term.app[:-1])
    elif case == "sqrt_pow_width":
        term = term._replace(sqrt_pow=term.sqrt_pow[..., :2].contiguous())
    elif case == "poly_c_rows":
        term = term._replace(poly_c=term.poly_c[1:])
    elif case == "P_strided":
        term = term._replace(P=term.P.transpose(1, 2))
    elif case == "sqrt_c_strided":
        term = term._replace(sqrt_c=torch.cat([term.sqrt_c, term.sqrt_c], 1)[:, ::2])
    elif case == "p_dtype":
        term = term._replace(p=term.p.float())
    elif case == "pow_dtype":
        term = term._replace(poly_pow=term.poly_pow.long())
    elif case == "K1_over":
        k = ot.MAX_TERMS + 1
        term = term._replace(poly_c=term.poly_c.new_zeros(e.shape[-2], k),
                             poly_pow=term.poly_pow.new_zeros(e.shape[-2], k, 3))
    elif case == "K2_over":
        k = ot.MAX_TERMS + 1
        term = term._replace(sqrt_c=term.sqrt_c.new_zeros(e.shape[-2], k),
                             sqrt_pow=term.sqrt_pow.new_zeros(e.shape[-2], k, 3))
    return term, e


@pytest.mark.parametrize("case", [
    "e_width", "e_rank", "e_rows", "e_strided", "e_dtype", "e_device", "P_shape",
    "c_shape", "app_rows", "sqrt_pow_width", "poly_c_rows", "P_strided", "sqrt_c_strided",
    "p_dtype", "pow_dtype", "K1_over", "K2_over",
])
def test_terminal_lanes_refuses_bad_inputs(tab, case):
    """The wrapper checks e and every table before either path runs."""
    term = torch_tables(tab)
    e = torch.as_tensor(errors(np.random.default_rng(2), (ROWS,)))
    term, e = _bad(case, term, e)
    n_plain, n_launch = ot.terminal_lanes.plain_calls, ot.terminal_lanes.launches
    for derivs in (False, True):
        with pytest.raises(ValueError, match="terminal_lanes"):
            ot.terminal_lanes(term, e, derivs=derivs)
    assert (ot.terminal_lanes.plain_calls, ot.terminal_lanes.launches) == (n_plain, n_launch)


def test_terminal_lanes_takes_the_largest_tables(tab):
    """MAX_TERMS terms each (zero-padded) give what the bank's tables give."""
    term = torch_tables(tab)
    e = torch.as_tensor(errors(np.random.default_rng(3), (ROWS,)))
    pad = lambda t, k: torch.nn.functional.pad(t, (0, k)) if t.dim() == 2 else \
        torch.nn.functional.pad(t, (0, 0, 0, k))
    big = term._replace(
        poly_c=pad(term.poly_c, ot.MAX_TERMS - term.poly_c.shape[1]),
        poly_pow=pad(term.poly_pow, ot.MAX_TERMS - term.poly_c.shape[1]),
        sqrt_c=pad(term.sqrt_c, ot.MAX_TERMS - term.sqrt_c.shape[1]),
        sqrt_pow=pad(term.sqrt_pow, ot.MAX_TERMS - term.sqrt_c.shape[1]),
    )
    for a, b in zip(ot.terminal_lanes(big, e, derivs=True),
                    ot.terminal_lanes(term, e, derivs=True)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-13, atol=1e-13)


def test_cache_rows_shift_and_do_not(tab):
    """The errors the JAX comparison takes cover both sides of the shift,
    tables with sqrt-abs terms and purely quadratic ones."""
    term = torch_tables(tab)
    active = shift_active(term, torch.as_tensor(errors(np.random.default_rng(4), (ROWS,))))
    assert 0 < int(active.sum()) < ROWS
    has_sqrt = np.abs(tab.sqrt_c).sum(axis=1) > 0
    assert has_sqrt.any() and not has_sqrt.all()


@pytest.mark.parametrize("name,lead", [
    ("terminal_value", ()), ("terminal_value", (NA,)),
    ("terminal_gradient", ()), ("terminal_hessian_psd", ()),
])
def test_terminal_lanes_matches_jax(tab, name, lead):
    """float64 against the JAX package under jax.vmap (tables shared over
    the candidates' axis), 1e-10 of each output's scale."""
    e = errors(np.random.default_rng(4), (*lead, ROWS))
    out = ot.terminal_lanes(torch_tables(tab), torch.as_tensor(e),
                            derivs=name != "terminal_value")
    if name != "terminal_value":
        out = out[1] if name == "terminal_gradient" else out[2]
    jterm = jpoly.TerminalPoly(*map(jnp.asarray, tab))
    f = jax.vmap(getattr(jpoly, name))
    if lead:
        f = jax.vmap(f, in_axes=(None, 0))
    ref = np.asarray(f(jterm, jnp.asarray(e)))
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np_(out), ref, rtol=1e-10, atol=1e-10 * scale)
