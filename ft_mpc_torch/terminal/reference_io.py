"""Import the reference's cached terminal.yaml as data (no eval of code),
counterpart of `ft_mpc_tpu/terminal/reference_io.py` (host numpy; `yaml`
and `sympy` are imported where they are used).

The reference stores its certified terminal cost as a python-code string
(`sp.lambdify(...)`) inside YAML.  This module parses the stored expression
with sympy and lowers it to the `TerminalPoly` tables:

  * monomials of total degree <= 2 (over all nine error symbols) fold into
    the quadratic (P, p, c) part;
  * higher-degree polynomial monomials (the cross_1 terms -- omega error
    only) go to the (poly_c, poly_pow) table;
  * terms of the shape  coeff * (monomial + app)^0.25  (the smoothed
    sqrt-abs cross_2 terms) go to the (sqrt_c, sqrt_pow) table.

The terminal set is plain JSON (A, b).  The parser accepts only this fixed
grammar and raises on anything else.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ft_mpc_torch.terminal.poly import (
    MAX_POLY_TERMS,
    MAX_SQRT_TERMS,
    TerminalPoly,
    pad_terminal_poly,
)

_SYMS = ("ep1", "ep2", "ep3", "ev1", "ev2", "ev3", "eo1", "eo2", "eo3")


def parse_cost_expression(cost_code: str):
    """Extract and sympy-parse the cost expression from the lambdify string.

    Returns (expr, symbols): the expanded sympy expression and the 9 error
    symbols in reference order (`terminal_ingredients.py:300,370`).
    """
    import sympy as sp

    head = cost_code.index("), ") + 3
    tail = cost_code.rindex(", modules=")
    expr_str = cost_code[head:tail]

    syms = sp.symbols(" ".join(_SYMS))
    local = {name: s for name, s in zip(_SYMS, syms)}
    local["Float"] = sp.Float
    expr = sp.parse_expr(expr_str, local_dict=local, evaluate=True)
    return sp.expand(expr), syms


def lower_to_terminal_poly(
    expr,
    syms,
    n_poly: int = MAX_POLY_TERMS,
    n_sqrt: int = MAX_SQRT_TERMS,
) -> TerminalPoly:
    """Lower an expanded sympy terminal-cost expression to TerminalPoly."""
    import sympy as sp

    eo_syms = syms[6:9]
    idx = {s: i for i, s in enumerate(syms)}

    P = np.zeros((9, 9))
    p = np.zeros(9)
    c = 0.0
    poly_rows: list[tuple[np.ndarray, float]] = []
    sqrt_rows: list[tuple[np.ndarray, float]] = []
    app_val = None

    for t in expr.as_ordered_terms():
        if t.is_polynomial(*syms):
            poly_t = sp.Poly(t, *syms)
            for monom, coeff in poly_t.terms():
                monom = np.asarray(monom, dtype=np.int64)
                deg = int(monom.sum())
                cf = float(coeff)
                if deg == 0:
                    c += cf
                elif deg == 1:
                    p[int(np.argmax(monom))] += cf
                elif deg == 2:
                    nz = np.nonzero(monom)[0]
                    if len(nz) == 1:
                        P[nz[0], nz[0]] += cf
                    else:
                        P[nz[0], nz[1]] += cf / 2.0
                        P[nz[1], nz[0]] += cf / 2.0
                else:
                    if monom[:6].any():
                        raise ValueError(
                            f"degree-{deg} monomial involves non-omega errors: {t}"
                        )
                    poly_rows.append((monom[6:9].astype(np.int32), cf))
            continue

        # expected: coeff * (base_monomial + app)**0.25
        coeff, rest = t.as_coeff_Mul()
        if not (isinstance(rest, sp.Pow) and abs(float(rest.exp) - 0.25) < 1e-12):
            raise ValueError(f"unrecognized terminal-cost term: {t}")
        arg = sp.expand(rest.base)
        app, base = arg.as_coeff_Add()
        app = float(app)
        base_poly = sp.Poly(base, *eo_syms)
        terms = base_poly.terms()
        if len(terms) != 1 or abs(float(terms[0][1]) - 1.0) > 1e-12:
            raise ValueError(f"sqrt-abs base is not a unit monomial: {arg}")
        pows = np.asarray(terms[0][0], dtype=np.int32)
        if np.any(pows % 2):
            raise ValueError(f"sqrt-abs base has odd exponents: {arg}")
        if app_val is None:
            app_val = app
        elif abs(app - app_val) > 1e-18:
            raise ValueError("inconsistent sqrt-abs smoothing constants")
        sqrt_rows.append((pows, float(coeff)))

    term = TerminalPoly(
        P=P,
        p=p,
        c=np.asarray(c),
        poly_c=np.array([cf for _, cf in poly_rows]),
        poly_pow=(
            np.stack([pw for pw, _ in poly_rows])
            if poly_rows
            else np.zeros((0, 3), dtype=np.int32)
        ),
        sqrt_c=np.array([cf for _, cf in sqrt_rows]),
        sqrt_pow=(
            np.stack([pw for pw, _ in sqrt_rows])
            if sqrt_rows
            else np.zeros((0, 3), dtype=np.int32)
        ),
        app=np.asarray(app_val if app_val is not None else 1e-6),
    )
    return pad_terminal_poly(term, n_poly, n_sqrt)


def load_reference_terminal_yaml(
    path: str | Path,
    n_poly: int = MAX_POLY_TERMS,
    n_sqrt: int = MAX_SQRT_TERMS,
):
    """Load a reference-format terminal.yaml -> (TerminalPoly, Polytope).

    Drop-in migration for artifacts produced by the reference's
    `store_terminal_ingredients` (`terminal_ingredients.py:444-449`).
    """
    import json

    import yaml

    from ft_mpc_torch.geometry.polytope import Polytope

    raw = yaml.safe_load(Path(path).read_text())
    expr, syms = parse_cost_expression(raw["cost"])
    term = lower_to_terminal_poly(expr, syms, n_poly, n_sqrt)
    ts = json.loads(raw["term_set"])
    term_set = Polytope(np.asarray(ts["A"], dtype=np.float64),
                        np.asarray(ts["b"], dtype=np.float64).reshape(-1))
    return term, term_set
