"""Carry the JAX package's data across: flat numpy dicts <-> port containers.

A flat dict is keyed by field path ("hull_A", "term.P", "fault.broken"), so
the leaves of any NamedTuple tree -- the JAX package's `Scenario`,
`BodyParams`, `MPCWeights`, `WarmStart`, `StagewiseMPCQP`,
`LQRFactorization`, or this port's counterparts, which keep the same field
names and batch-leading shapes -- round-trip through `np.savez` unchanged.
Nothing here imports JAX: `flatten_namedtuple` only reads attributes and
calls `np.asarray` on the leaves.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ft_mpc_torch import resolve_device
from ft_mpc_torch.controllers.spiraling import MPCWeights, WarmStart
from ft_mpc_torch.geometry.scenario import Scenario
from ft_mpc_torch.ops.dynamics import BodyParams, FaultState
from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseMPCQP
from ft_mpc_torch.solvers.riccati import LQRFactorization
from ft_mpc_torch.terminal.poly import TerminalPoly

# NamedTuple fields that are themselves NamedTuples
_NESTED = {
    (Scenario, "fault"): FaultState,
    (Scenario, "term"): TerminalPoly,
}


def flatten_namedtuple(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{field path: numpy leaf} for a NamedTuple tree; None leaves are dropped."""
    flat = {}
    for name in tree._fields:
        leaf = getattr(tree, name)
        if leaf is None:
            continue
        if hasattr(leaf, "_fields"):
            flat.update(flatten_namedtuple(leaf, f"{prefix}{name}."))
        else:
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu()
            flat[f"{prefix}{name}"] = np.asarray(leaf)
    return flat


def unflatten_namedtuple(
    cls,
    flat: Mapping[str, np.ndarray],
    device=None,
    dtype: torch.dtype | None = None,
    prefix: str = "",
):
    """Build `cls` from a flat dict; float leaves cast to `dtype` when given.

    Integer leaves (the terminal power tables) keep their integer type.
    Fields missing from the dict take the NamedTuple's default (None).
    """
    dev = resolve_device(device)
    kwargs = {}
    for name in cls._fields:
        sub = _NESTED.get((cls, name))
        if sub is not None:
            kwargs[name] = unflatten_namedtuple(
                sub, flat, dev, dtype, f"{prefix}{name}."
            )
            continue
        key = f"{prefix}{name}"
        if key not in flat:
            if name not in cls._field_defaults:
                raise KeyError(f"missing leaf {key!r} for {cls.__name__}")
            kwargs[name] = cls._field_defaults[name]
            continue
        # a copy: leaves of JAX arrays are read-only views
        t = torch.as_tensor(np.array(flat[key]), device=dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        kwargs[name] = t
    return cls(**kwargs)


def scenario_from_numpy(flat, device=None, dtype=None) -> Scenario:
    return unflatten_namedtuple(Scenario, flat, device, dtype)


def body_params_from_numpy(flat, device=None, dtype=None) -> BodyParams:
    return unflatten_namedtuple(BodyParams, flat, device, dtype)


def weights_from_numpy(flat, device=None, dtype=None) -> MPCWeights:
    return unflatten_namedtuple(MPCWeights, flat, device, dtype)


def warmstart_from_numpy(flat, device=None, dtype=None) -> WarmStart:
    """Warm start; kinv is always float32 (the metric the kernels consume),
    and stays None for a stagewise warm start, which has none."""
    warm = unflatten_namedtuple(WarmStart, flat, device, dtype)
    if warm.kinv is not None:
        warm = warm._replace(kinv=warm.kinv.to(torch.float32))
    return warm


def stagewise_qp_from_numpy(flat, device=None, dtype=None) -> StagewiseMPCQP:
    return unflatten_namedtuple(StagewiseMPCQP, flat, device, dtype)


def lqr_factorization_from_numpy(flat, device=None, dtype=None) -> LQRFactorization:
    return unflatten_namedtuple(LQRFactorization, flat, device, dtype)
