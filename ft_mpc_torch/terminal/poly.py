"""Polynomial terminal cost as data, counterpart of `ft_mpc_tpu/terminal/poly.py`.

    V(e) = e'Pe + p'e + c
         + sum_k  poly_c[k] * prod_i eo_i^poly_pow[k,i]
         + sum_k  sqrt_c[k] * (prod_i eo_i^sqrt_pow[k,i] + app)^0.25

with eo = e[6:9].  The per-scenario functions take one scenario's tables
(unbatched); the batched callers map them over the bank with
`torch.func.vmap`.  `jax.grad` / `jax.hessian` become `torch.func.grad` /
`torch.func.hessian`.

The host half (`quadratic_terminal`, `pad_terminal_poly`,
`cross_term_tables`, `assemble_terminal_poly`) builds the tables in numpy
float64, as the JAX package does; a `TerminalPoly` of numpy leaves becomes
tensors where a scenario is handed to the device
(`ft_mpc_torch.convert.scenario_from_numpy`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

N_ERR = 9
MAX_POLY_TERMS = 8  # default padding for the polynomial (cross_1) table
MAX_SQRT_TERMS = 12  # default padding for the sqrt-abs (cross_2) table
_MAX_POW = 8  # largest exponent appearing in any table (sqrt bases go to 8)
SQRTABS_APP = 1.0e-6  # the reference's smoothing constant of sqrtabs


class TerminalPoly(NamedTuple):
    """Terminal cost V(e) on the 9-d error: tensors on the device, numpy
    arrays where the host-side table functions make it."""

    P: torch.Tensor  # (9, 9)
    p: torch.Tensor  # (9,)
    c: torch.Tensor  # ()
    poly_c: torch.Tensor  # (K1,)
    poly_pow: torch.Tensor  # (K1, 3) int32
    sqrt_c: torch.Tensor  # (K2,)
    sqrt_pow: torch.Tensor  # (K2, 3) int32
    app: torch.Tensor  # ()


def quadratic_terminal(
    P, p, c, n_poly: int = MAX_POLY_TERMS, n_sqrt: int = MAX_SQRT_TERMS
) -> TerminalPoly:
    """Purely quadratic terminal cost, padded to the standard table sizes."""
    return TerminalPoly(
        P=np.asarray(P),
        p=np.asarray(p),
        c=np.asarray(c),
        poly_c=np.zeros(n_poly),
        poly_pow=np.zeros((n_poly, 3), dtype=np.int32),
        sqrt_c=np.zeros(n_sqrt),
        sqrt_pow=np.zeros((n_sqrt, 3), dtype=np.int32),
        app=np.asarray(SQRTABS_APP),
    )


def pad_terminal_poly(
    term: TerminalPoly, n_poly: int = MAX_POLY_TERMS, n_sqrt: int = MAX_SQRT_TERMS
) -> TerminalPoly:
    """Pad the term tables to (n_poly, n_sqrt) rows (host-side numpy)."""
    k1 = len(term.poly_c)
    k2 = len(term.sqrt_c)
    if k1 > n_poly or k2 > n_sqrt:
        raise ValueError(
            f"terminal tables ({k1}, {k2}) exceed padding ({n_poly}, {n_sqrt})"
        )
    return term._replace(
        poly_c=np.pad(np.asarray(term.poly_c, dtype=np.float64), (0, n_poly - k1)),
        poly_pow=np.pad(
            np.asarray(term.poly_pow, dtype=np.int32), ((0, n_poly - k1), (0, 0))
        ),
        sqrt_c=np.pad(np.asarray(term.sqrt_c, dtype=np.float64), (0, n_sqrt - k2)),
        sqrt_pow=np.pad(
            np.asarray(term.sqrt_pow, dtype=np.int32), ((0, n_sqrt - k2), (0, 0))
        ),
    )


# ---------------------------------------------------------------------------
# Evaluation (device tensors; vmap / grad / hessian safe)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Cross-term coefficient tables (host side, numpy float64)
# ---------------------------------------------------------------------------


def _geom_factor(pows: np.ndarray, k_omega: np.ndarray, half: bool) -> float:
    """Geometric-series factor 1 / (1 - prod_i (1-k_i)^(pows_i [/2])).

    Each eo_i contracts by (1-k_i) per closed-loop step of the terminal
    controller, so a monomial with exponents `pows` sums to this factor
    over the infinite tail (the factors multiplying every cross_1/cross_2
    term, `terminal_ingredients.py:354,365`; cross_2 exponents are halved
    because the bound is on sqrt of the monomial).
    """
    expo = np.asarray(pows, dtype=np.float64)
    if half:
        expo = expo / 2.0
    decay = np.prod((1.0 - np.asarray(k_omega, dtype=np.float64)) ** expo)
    return float(1.0 / (1.0 - decay))


def cross_term_tables(
    mass: float,
    inertia: np.ndarray,  # (3, 3) (diagonal; only the diagonal is used)
    r: np.ndarray,  # (3,) orbit-center offset
    omega_des: np.ndarray,  # (3,)
    Q: np.ndarray,  # (9, 9) running state cost (diagonal)
    k_omega: np.ndarray,  # (3,) terminal omega feedback gains
    qu_tilde_abs: float,  # ||Minv' R Minv||_F (`terminal_ingredients.py:314`)
    input_empc_max: float,  # certified eMPC input ball radius r_empc
    prefactor_all: bool = True,
):
    """Coefficient tables of the reference's cross_1/cross_2 terminal terms.

    These are the closed-form bounds on the coupling the per-axis
    double-integrator eMPC ignores (centripetal/Euler/gyroscopic terms of
    the orbit-center dynamics), as polynomials in the omega error --
    transcribed from `terminal_ingredients.py:341-366` in factored form
    (validated coefficient-by-coefficient against the reference's cached
    `config/terminal.yaml` in tests/test_terminal_poly.py).

    `prefactor_all` handles a reference quirk: the deployed expressions
    (`terminal_ingredients.py:353-365`) apply their `2*|Qu_tilde|` /
    `2*input_empc_max` prefactors **only to the first summand** -- the
    multi-line sums are not parenthesized, unlike the fully-parenthesized
    derivation kept in comments at `:341-347`.  With `prefactor_all=False`
    this function reproduces the deployed artifact bit-for-bit (use for
    parity with reference-generated terminal.yaml caches); the default
    True applies the prefactors to every term per the derivation, which is
    the conservative (certificate-preserving) variant our pipeline emits.

    Returns (poly_c (7,), poly_pow (7,3), sqrt_c (12,), sqrt_pow (12,3),
    P_add (3,3), shift): the degree->=3 polynomial table, the sqrt-abs table
    (sqrt_pow rows are the squared-monomial exponents), the degree-2
    cross_1 part as a quadratic omega block to fold into P, and the
    constant shift (sum of the sqrtabs -app^0.25 offsets) to add to c.
    """
    J = np.asarray(inertia, dtype=np.float64)
    j0, j1, j2 = float(J[0, 0]), float(J[1, 1]), float(J[2, 2])
    rN = float(np.linalg.norm(r))
    omd = float(np.linalg.norm(omega_des))
    m = float(mass)
    Qd = np.diag(np.asarray(Q, dtype=np.float64))
    qu1, qu2, qu3, qu4, qu5, qu6 = (float(v) for v in Qd[:6])
    k = np.asarray(k_omega, dtype=np.float64)
    k1, k2, k3 = (float(v) for v in k)

    # --- cross_1: 2*|Qu_tilde| * (inertia-coupling)^2 monomials ------------
    # Per-axis Euler-coupling ratios (the (J_a - J_b)/J_c factors of
    # w x (J w) seen through J^{-1} and the lever arm).
    cA = (j1 - j2) / j0  # drives the eo2^2 family
    cB = (j0 - j2) / j1  # drives the eo1^2 family
    cC = (j0 - j1) / j2  # drives the eo1^2 eo2^2 term
    coeffB = cA * cA + rN * rN * (1.0 + cA) ** 2
    coeffD = cB * cB + 2.0 * rN * rN
    coeffE = cC * cC + rN * rN * (1.0 - cC) ** 2

    pre1 = 2.0 * float(qu_tilde_abs)
    # (exponents on (eo1, eo2, eo3), raw coefficient); degree >= 3 rows.
    # The first row is the first summand of the reference expression
    # (`terminal_ingredients.py:354`) -- the only one its prefactor reaches
    # in quirk mode (see docstring).
    cross1 = [
        ((0, 2, 1), 2.0 * omd * coeffB),
        ((0, 2, 2), coeffB),
        ((2, 0, 1), 2.0 * omd * coeffD),
        ((2, 0, 2), coeffD),
        ((2, 2, 0), coeffE),
        ((0, 0, 4), rN * rN),
        ((0, 0, 3), 4.0 * rN * rN * omd),
    ]
    pre1_row = [pre1] + [pre1 if prefactor_all else 1.0] * (len(cross1) - 1)
    poly_pow = np.array([pw for pw, _ in cross1], dtype=np.int32)
    poly_c = np.array(
        [
            pr * c * _geom_factor(pw, k, half=False)
            for pr, (pw, c) in zip(pre1_row, cross1)
        ]
    )

    # degree-2 cross_1 rows fold into the quadratic omega block exactly
    # (later summands of the same sum: prefactored only in corrected mode).
    pre1_d2 = pre1 if prefactor_all else 1.0
    deg2 = [
        (0, omd * omd * cB * cB),  # eo1^2
        (1, omd * omd * coeffB),  # eo2^2
        (2, 4.0 * rN * rN * omd * omd),  # eo3^2
    ]
    P_add = np.zeros((3, 3))
    for axis, c in deg2:
        pw = np.zeros(3, dtype=np.int32)
        pw[axis] = 2
        P_add[axis, axis] = pre1_d2 * c * _geom_factor(pw, k, half=False)

    # --- cross_2: 2*r_empc * sqrt|quadratic-form coefficient| sqrtabs ------
    # Inner coefficients under the sqrt, in factored form; (exponents of the
    # sqrtabs *argument* monomial, coefficient expression).
    t3 = 2.0 * m**4 * qu2**2 * rN**2 + (j1 * qu5 * (j0 - j2)) ** 2
    t8 = (m * m * qu3 * rN * rN - j0 * qu4 * (j1 - j2)) ** 2 + m**4 * qu3**2 * rN**2
    t6_k1 = 2.0 * k1 * (
        -(m**4) * qu3**2 * rN * rN * (rN * rN + 1.0)
        + j0 * m * m * qu3 * qu4 * rN * rN * (-j0 + j1 - j2)
        + j0**3 * qu4**2 * (j1 - j2)
    )
    t6_k2 = 2.0 * k2 * j1**3 * qu5**2 * (j2 - j0)
    t6_k3 = 2.0 * k3 * (
        m**4 * qu1**2 * rN * rN * (rN * rN + 1.0)
        + j2 * m * m * qu1 * qu6 * rN * rN * (j0 - j1 + j2)
        + j2**3 * qu6**2 * (j0 - j1)
    )
    cross2 = [
        ((0, 0, 4), rN**2 * m**4 * qu2**2),
        (
            (2, 2, 0),
            m**4 * qu1**2 * rN**2 * (rN**2 + 1.0)
            + 2.0 * j2 * m * m * qu1 * qu6 * rN * rN * (j0 - j1)
            + (j2 * qu6 * (j0 - j1)) ** 2,
        ),
        ((2, 0, 2), t3),
        ((2, 0, 1), 2.0 * omd * t3),
        (
            (2, 0, 0),
            k1 * k1 * ((m * m * qu3 * rN * rN + j0 * j0 * qu4) ** 2 + m**4 * qu3**2 * rN**2)
            + (omd * j1 * qu5 * (j0 - j2)) ** 2,
        ),
        ((1, 1, 1), t6_k1 + t6_k2 + t6_k3),
        ((1, 1, 0), omd * (t6_k1 + t6_k2)),
        ((0, 2, 2), t8),
        ((0, 2, 1), 2.0 * omd * t8),
        ((0, 2, 0), omd * omd * t8 + (j1 * j1 * k2 * qu5) ** 2),
        ((0, 0, 3), 4.0 * m**4 * qu2**2 * rN**2 * omd),
        (
            (0, 0, 2),
            k3 * k3 * ((m * m * qu1 * rN * rN + j2 * j2 * qu6) ** 2 + m**4 * qu1**2 * rN**2)
            + 4.0 * m**4 * qu2**2 * rN**2 * omd**2,
        ),
    ]
    # First row = first summand of `terminal_ingredients.py:365` (the only
    # one reached by `2*input_empc_max` in quirk mode).
    pre2 = 2.0 * float(input_empc_max)
    pre2_row = [pre2] + [pre2 if prefactor_all else 1.0] * (len(cross2) - 1)
    sqrt_pow = np.array([2 * np.asarray(pw) for pw, _ in cross2], dtype=np.int32)
    sqrt_c = np.array(
        [
            pr * np.sqrt(abs(c)) * _geom_factor(pw, k, half=True)
            for pr, (pw, c) in zip(pre2_row, cross2)
        ]
    )
    shift = -float(np.sum(sqrt_c)) * SQRTABS_APP**0.25
    return poly_c, poly_pow, sqrt_c, sqrt_pow, P_add, shift


def assemble_terminal_poly(
    P9: np.ndarray,
    p9: np.ndarray,
    c: float,
    mass: float,
    inertia: np.ndarray,
    r: np.ndarray,
    omega_des: np.ndarray,
    Q: np.ndarray,
    k_omega: np.ndarray,
    qu_tilde_abs: float,
    input_empc_max: float,
    n_poly: int = MAX_POLY_TERMS,
    n_sqrt: int = MAX_SQRT_TERMS,
    prefactor_all: bool = True,
) -> TerminalPoly:
    """Quadratic ingredients + cross terms -> padded TerminalPoly.

    Mirrors the assembly `terminal_cost = cost_empc + cost_omega + cross_1
    + cross_2` (`terminal_ingredients.py:369`) with the degree-2 cross_1
    rows folded into P and the sqrtabs shifts folded into c.
    """
    poly_c, poly_pow, sqrt_c, sqrt_pow, P_add, shift = cross_term_tables(
        mass, inertia, r, omega_des, Q, k_omega, qu_tilde_abs, input_empc_max,
        prefactor_all=prefactor_all,
    )
    P9 = np.asarray(P9, dtype=np.float64).copy()
    P9[6:9, 6:9] += P_add
    term = TerminalPoly(
        P=P9,
        p=np.asarray(p9, dtype=np.float64),
        c=np.asarray(float(c) + shift),
        poly_c=poly_c,
        poly_pow=poly_pow,
        sqrt_c=sqrt_c,
        sqrt_pow=sqrt_pow,
        app=np.asarray(SQRTABS_APP),
    )
    return pad_terminal_poly(term, n_poly, n_sqrt)
