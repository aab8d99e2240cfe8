"""PyTorch / CUDA port of ft_mpc_tpu for NVIDIA Hopper (H100).

The JAX package `ft_mpc_tpu` is the reference; this package keeps its module
paths and function names so each counterpart is easy to find, takes
batch-leading tensors, and never imports JAX or `ft_mpc_tpu`.

Entry points that create tensors run on `cuda` unless the caller passes
`device="cpu"`; without a CUDA device they raise instead of carrying on
quietly on the CPU (`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ft_mpc_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def pin_fp32_matmuls() -> None:
    """Full fp32 for every matmul that feeds K^{-1} (condition ~1e5).

    TF32 keeps ~3 decimal digits, which stalls the Newton-Schulz refresh and
    produces NaNs downstream (same reason the JAX package pins HIGHEST
    precision, `ft_mpc_tpu/solvers/lanes_qp.py:116-119`).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


pin_fp32_matmuls()

# after resolve_device: ops.dynamics imports it from this package
from ft_mpc_torch.utils.faults import BrokenThruster  # noqa: E402,F401
from ft_mpc_torch.ops.dynamics import BodyParams, build_thruster_matrix  # noqa: E402,F401
