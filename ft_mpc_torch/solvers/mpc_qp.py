"""Condensed MPC QP containers, counterpart of `ft_mpc_tpu/solvers/mpc_qp.py:35-81`.

    min 1/2 x^T H x + g^T x  s.t.  (I_Nt kron hull_A) x <= h_hull,  G_term x <= h_term

The stage hull block stays implicit (one shared (F, 6) matrix per
scenario); the batched solver is `solvers.lanes_qp.solve_mpc_qp_lanes`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StructuredMPCQP(NamedTuple):
    """Batched condensed QP (leading scenario axis on every leaf)."""

    H: torch.Tensor  # (B, n, n)
    g: torch.Tensor  # (B, n)
    hull_A: torch.Tensor  # (B, F, 6) shared stage block (masked rows zeroed)
    h_hull: torch.Tensor  # (B, Nt, F) per-stage offsets (masked rows large)
    G_term: torch.Tensor  # (B, T, n) dense terminal rows (masked rows zeroed)
    h_term: torch.Tensor  # (B, T)


class StructuredADMMConfig(NamedTuple):
    """ADMM settings; same fields and defaults as the JAX package.

    adapt_clip bounds the per-phase rho change (1.5 on the warm
    Newton-refreshed path, 5.0 on exact-refactor paths).  elastic_y_max > 0
    clamps terminal duals to [0, elastic_y_max] with the exact hinge prox
    (l1 exact-penalty restoration rows); 0 keeps the rows hard.
    """

    iters: int = 50
    phases: int = 4
    rho: float = 1.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    alpha: float = 1.6
    adapt_clip: float = 5.0
    elastic_y_max: float = 1e3
