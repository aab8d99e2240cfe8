"""The SQP's terminal terms: the polynomial terminal cost V(e) of every row
of a bank, and where asked its gradient and its Hessian with the omega block
shifted to be positive semidefinite (`terminal/poly.py`).

`terminal_lanes` is what the controller calls.  On a CUDA tensor it
launches the hand-written kernel `csrc/terminal.cu` (one thread a row, in
the caller's dtype); on a CPU tensor it runs `terminal_plain`,
`torch.func.vmap` of the per-scenario `terminal_value`, `terminal_gradient`
and `terminal_hessian_psd`, as the JAX package's `jax.vmap`.

The error e is (..., B, 9) against tables of B rows (`Scenario.term`, every
leaf batch-leading); a row of e reads the tables of its row along the B
axis, so the line search's (candidates, B, 9) errors are one call.
"""

from __future__ import annotations

import ctypes

import torch

from ft_mpc_torch import kernels
from ft_mpc_torch.terminal.poly import (
    N_ERR,
    TerminalPoly,
    terminal_gradient,
    terminal_hessian_psd,
    terminal_value,
)

# K1 and K2 at most: the largest tables the card's tests hold the kernel at
# (the bank's tables have 8 and 12 rows; csrc/terminal.cu:MAX_TERMS)
MAX_TERMS = 32
_LAUNCHERS = {torch.float32: "terminal_f32", torch.float64: "terminal_f64"}
_vmap = torch.func.vmap


def terminal_plain(term: TerminalPoly, e: torch.Tensor, derivs: bool):
    """V (...,B), or (V, dV/de (...,B,9), the PSD-shifted Hessian
    (...,B,9,9)): the per-scenario functions under `vmap`, one more `vmap`
    (tables shared) for each axis of e before the B axis."""
    fns = [terminal_value] + ([terminal_gradient, terminal_hessian_psd] if derivs else [])
    out = []
    for fn in fns:
        f = _vmap(fn)
        for _ in range(e.dim() - 2):
            f = _vmap(f, in_dims=(None, 0))
        out.append(f(term, e))
    return tuple(out) if derivs else out[0]


def _check(term: TerminalPoly, e: torch.Tensor):
    """Shapes, dtypes, device and contiguity of e and the tables; returns
    (B, K1, K2)."""
    if e.dim() < 2 or e.shape[-1] != N_ERR:
        raise ValueError(f"terminal_lanes: e has shape {tuple(e.shape)}, takes (..., B, 9)")
    B = e.shape[-2]
    K1, K2 = term.poly_c.shape[-1], term.sqrt_c.shape[-1]
    want = {"P": (B, N_ERR, N_ERR), "p": (B, N_ERR), "c": (B,), "poly_c": (B, K1),
            "poly_pow": (B, K1, 3), "sqrt_c": (B, K2), "sqrt_pow": (B, K2, 3), "app": (B,)}
    for k, shape in want.items():
        t = getattr(term, k)
        if tuple(t.shape) != shape:
            raise ValueError(f"terminal_lanes: {k} has shape {tuple(t.shape)}, takes "
                             f"{shape} for e of shape {tuple(e.shape)}")
        dtype = torch.int32 if k.endswith("_pow") else e.dtype
        if t.dtype != dtype:
            raise ValueError(f"terminal_lanes: {k} is {t.dtype}, takes {dtype}")
        if t.device != e.device:
            raise ValueError(f"terminal_lanes: {k} on {t.device}, e on {e.device}")
        if not t.is_contiguous():
            raise ValueError(f"terminal_lanes: {k} is not contiguous")
    if not e.is_contiguous():
        raise ValueError("terminal_lanes: e is not contiguous")
    if K1 > MAX_TERMS or K2 > MAX_TERMS:
        raise ValueError(f"terminal_lanes: tables of ({K1}, {K2}) terms, the kernel "
                         f"takes at most {MAX_TERMS} each")
    return B, K1, K2


def _terminal_cuda(term: TerminalPoly, e: torch.Tensor, derivs: bool, B: int, K1: int,
                   K2: int):
    """One launch of `csrc/terminal.cu` on the checked inputs (`_check`)."""
    fn_name = _LAUNCHERS.get(e.dtype)
    if fn_name is None:
        raise ValueError(f"terminal_lanes: dtype {e.dtype}, the kernel takes "
                         f"{sorted(map(str, _LAUNCHERS))}")
    tables = [term.P, term.p, term.c, term.poly_c, term.sqrt_c, term.app]
    kernels.require_cuda("terminal_lanes", e.dtype, e, *tables)
    kernels.require_cuda("terminal_lanes", torch.int32, term.poly_pow, term.sqrt_pow)
    lead = e.shape[:-1]
    V = torch.empty(lead, dtype=e.dtype, device=e.device)
    g = torch.empty((*lead, N_ERR), dtype=e.dtype, device=e.device) if derivs else None
    H = torch.empty((*lead, N_ERR, N_ERR), dtype=e.dtype, device=e.device) if derivs else None
    fn = kernels.function(
        "terminal", fn_name,
        [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
    )
    err = fn(e.data_ptr(), term.P.data_ptr(), term.p.data_ptr(), term.c.data_ptr(),
             term.poly_c.data_ptr(), term.poly_pow.data_ptr(), term.sqrt_c.data_ptr(),
             term.sqrt_pow.data_ptr(), term.app.data_ptr(), V.data_ptr(),
             g.data_ptr() if derivs else None, H.data_ptr() if derivs else None,
             V.numel(), B, K1, K2, int(derivs), kernels.stream_of(e))
    kernels.check("terminal", fn_name, err)
    terminal_lanes.launches += 1
    return (V, g, H) if derivs else V


def terminal_lanes(term: TerminalPoly, e: torch.Tensor, derivs: bool = False):
    """V (...,B) of the errors e (...,B,9), or with `derivs` (V, dV/de
    (...,B,9), the Hessian with its omega block PSD-shifted (...,B,9,9)).

    e and every table must be contiguous, on one device, the tables of B
    rows in e's dtype (the exponents int32), with at most MAX_TERMS terms.
    CUDA tensors launch `csrc/terminal.cu` in their own dtype (float32 or
    float64) on the current stream; CPU tensors run `terminal_plain`.
    """
    B, K1, K2 = _check(term, e)
    if e.device.type == "cpu":
        terminal_lanes.plain_calls += 1
        return terminal_plain(term, e, derivs)
    return _terminal_cuda(term, e, derivs, B, K1, K2)


terminal_lanes.launches = 0
terminal_lanes.plain_calls = 0
