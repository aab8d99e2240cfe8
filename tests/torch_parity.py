"""Helpers shared by the tests/test_torch_*.py parity tests.

The same numpy inputs go through the JAX package (the reference, run on
the CPU in x64 as its own tests run it) and through ft_mpc_torch on the CPU.
Scenario banks come from the committed snapshot
`ft_mpc_torch/data/bench_bank32.npz` (flat field-path keys, float64).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._pytree import tree_map

from ft_mpc_torch.convert import scenario_from_numpy
from ft_mpc_torch.geometry.scenario import BENCH_BANK
from ft_mpc_tpu.geometry.scenario import Scenario as JaxScenario
from ft_mpc_tpu.ops.dynamics import FaultState as JaxFaultState
from ft_mpc_tpu.terminal.poly import TerminalPoly as JaxTerminalPoly

F64 = torch.float64


def load_flat(rows=None) -> dict[str, np.ndarray]:
    """Snapshot leaves, optionally restricted to bank rows `rows`."""
    with np.load(BENCH_BANK) as z:
        flat = {k: z[k] for k in z.files}
    if rows is not None:
        flat = {k: v[np.asarray(rows)] for k, v in flat.items()}
    return flat


def jax_tree(cls, flat, prefix=""):
    nested = {"fault": JaxFaultState, "term": JaxTerminalPoly}
    kw = {}
    for name in cls._fields:
        if cls is JaxScenario and name in nested:
            kw[name] = jax_tree(nested[name], flat, f"{prefix}{name}.")
        else:
            kw[name] = jnp.asarray(flat[f"{prefix}{name}"])
    return cls(**kw)


def jax_bank(flat) -> JaxScenario:
    return jax_tree(JaxScenario, flat)


def torch_bank(flat):
    return scenario_from_numpy(flat, device="cpu", dtype=F64)


def to_device(tree, device, dtype):
    """Move a tree of tensors; float leaves cast to dtype, int leaves kept."""
    return tree_map(
        lambda x: x.to(device, dtype) if x.is_floating_point() else x.to(device), tree
    )


def t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F64)


def np_(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def gentle_states(B: int, seed: int = 0) -> np.ndarray:
    """Robot states near the certified terminal sets (tests/test_lanes.py
    `_bank_setup`): far outside them the controller is in
    feasibility-restoration mode, where cross-implementation comparison
    is chaotic."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.15, 0.15, (B, 3))
    q = rng.standard_normal((B, 4))
    x0[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x0[:, 10:13] = rng.uniform(-0.15, 0.15, (B, 3))
    return x0
