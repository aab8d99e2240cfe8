"""Polynomial terminal cost as data, device half of `ft_mpc_tpu/terminal/poly.py`.

    V(e) = e'Pe + p'e + c
         + sum_k  poly_c[k] * prod_i eo_i^poly_pow[k,i]
         + sum_k  sqrt_c[k] * (prod_i eo_i^sqrt_pow[k,i] + app)^0.25

with eo = e[6:9].  The per-scenario functions take one scenario's tables
(unbatched); the batched callers map them over the bank with
`torch.func.vmap`.  `jax.grad` / `jax.hessian` become `torch.func.grad` /
`torch.func.hessian`.  The host-side table builders stay in the JAX package
until the host tooling is ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_ERR = 9
_MAX_POW = 8  # largest exponent appearing in any table (sqrt bases go to 8)


class TerminalPoly(NamedTuple):
    """Terminal cost V(e) on the 9-d error, as tensors."""

    P: torch.Tensor  # (9, 9)
    p: torch.Tensor  # (9,)
    c: torch.Tensor  # ()
    poly_c: torch.Tensor  # (K1,)
    poly_pow: torch.Tensor  # (K1, 3) int32
    sqrt_c: torch.Tensor  # (K2,)
    sqrt_pow: torch.Tensor  # (K2, 3) int32
    app: torch.Tensor  # ()


def _pow_table(x: torch.Tensor) -> torch.Tensor:
    """[x_i^0, ..., x_i^_MAX_POW] by repeated multiplication: (3, P+1)."""
    acc = torch.ones_like(x)
    rows = [acc]
    for _ in range(_MAX_POW):
        acc = acc * x
        rows.append(acc)
    return torch.stack(rows, dim=0).transpose(0, 1)


def _monomials(pows: torch.Tensor, eo: torch.Tensor) -> torch.Tensor:
    """prod_i eo_i^pows[k,i] for each table row k; smooth in eo everywhere."""
    tab = _pow_table(eo)  # (3, P+1)
    grid = torch.arange(_MAX_POW + 1, device=eo.device)
    onehot = (pows.to(torch.int64)[..., None] == grid).to(eo.dtype)  # (K, 3, P+1)
    factors = torch.einsum("kap,ap->ka", onehot, tab)
    return factors[:, 0] * factors[:, 1] * factors[:, 2]


def _extra_value(term: TerminalPoly, eo: torch.Tensor) -> torch.Tensor:
    """Non-quadratic part of V as a function of the 3-d omega error."""
    v = torch.dot(term.poly_c, _monomials(term.poly_pow, eo))
    base = _monomials(term.sqrt_pow, eo)
    return v + torch.dot(term.sqrt_c, (base + term.app) ** 0.25)


def terminal_value(term: TerminalPoly, e: torch.Tensor) -> torch.Tensor:
    """V(e) for a 9-d terminal error."""
    return e @ term.P @ e + term.p @ e + term.c + _extra_value(term, e[6:9])


def terminal_gradient(term: TerminalPoly, e: torch.Tensor) -> torch.Tensor:
    """dV/de (9,)."""
    g = 2.0 * (term.P @ e) + term.p
    g_eo = torch.func.grad(lambda w: _extra_value(term, w))(e[6:9])
    return torch.cat([g[:6], g[6:9] + g_eo])


def _eigmin_sym3(A: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of a symmetric 3x3, closed form (no iteration)."""
    q = torch.trace(A) / 3.0
    Bm = A - q * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(Bm * Bm) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = torch.linalg.det(Bm / p)
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    eig = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return torch.where(p2 < 1e-24, q, eig)


def terminal_hessian_psd(term: TerminalPoly, e: torch.Tensor) -> torch.Tensor:
    """d2V/de2 (9, 9) with the non-quadratic omega block convexified."""
    H = 2.0 * term.P.to(e.dtype)
    H_eo = torch.func.hessian(lambda w: _extra_value(term, w))(e[6:9])
    H_eo = 0.5 * (H_eo + H_eo.T)
    shift = torch.clamp(-_eigmin_sym3(H_eo), min=0.0)
    H_eo = H_eo + shift * torch.eye(3, dtype=H_eo.dtype, device=H_eo.device)
    top = H[:6]
    bot = torch.cat([H[6:, :6], H[6:, 6:] + H_eo], dim=1)
    return torch.cat([top, bot], dim=0)
