"""The SQP's linearization: the RK4 stage map of the orbit-centre dynamics,
its 13x13 and 13x6 jacobians and the shooting defect, for every stage of a
bank's horizon.

`linearize_lanes` is what the controller calls.  On a CUDA tensor it
launches the hand-written kernel `csrc/linearize.cu` (one warp a stage,
forward mode, in the caller's dtype); on a CPU tensor it runs
`linearize_plain`, `torch.func.vmap(jacfwd)` of `stage_dynamics` over the
flattened (B * Nt) stages, as the JAX package's `jax.jacfwd` under `vmap`.

Plant leaves may carry a leading scenario axis (per-scenario mass and
inertia; `params_batch_axes`) or be shared; the bank's leaves carry it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ft_mpc_torch import kernels
from ft_mpc_torch.ops.dynamics import BodyParams, _matvec, center_step
from ft_mpc_torch.ops.quaternion import rot_full_inv

N_X = 13
N_U = 6
# canonical rank of each BodyParams leaf; one more means a scenario axis
_PARAM_RANKS = BodyParams(mass=0, inertia=2, inertia_inv=2, max_thrust=0, D=2, dt=0)
# the leaves the stage map reads, and their shapes without a scenario axis
_PARAM_SHAPES = {"mass": (), "inertia": (3, 3), "inertia_inv": (3, 3), "dt": ()}
_BANK_SHAPES = {"faulty_force_gen": (N_U,), "r": (3,), "u_comp": (N_U,)}
_LAUNCHERS = {torch.float32: "linearize_f32", torch.float64: "linearize_f64"}


def params_batch_axes(params: BodyParams) -> BodyParams:
    """vmap in_dims for a possibly scenario-batched `BodyParams`.

    A leaf whose ndim exceeds its canonical rank (mass/dt 0, matrices 2)
    carries a leading scenario axis (0); the rest are shared (None).
    """
    return BodyParams(
        *[0 if leaf.dim() > nd else None for leaf, nd in zip(params, _PARAM_RANKS)]
    )


def params_row(params: BodyParams, p_ax: BodyParams, idx) -> BodyParams:
    """Gather rows idx from the batched leaves of params (shared leaves pass)."""
    return BodyParams(
        *[leaf[idx] if ax == 0 else leaf for leaf, ax in zip(params, p_ax)]
    )


class StageData(NamedTuple):
    """The scenario leaves the stage dynamics read (gathered per stage row)."""

    faulty_force_gen: torch.Tensor
    r: torch.Tensor
    u_comp: torch.Tensor


def stage_rows(params, bank, rows):
    """Per-row plant and stage data for flattened rows -> scenario index."""
    p_ax = params_batch_axes(params)
    sd = StageData(bank.faulty_force_gen[rows], bank.r[rows], bank.u_comp[rows])
    return params_row(params, p_ax, rows), p_ax, sd


def stage_dynamics(params: BodyParams, scenario, x, u, u_ref_t):
    """Discrete center dynamics of a stage under deviation input u.

    Total commanded wrench = u + rot(x) u_ref + u_comp; `scenario` is any
    object with faulty_force_gen, r and u_comp (a `Scenario` or `StageData`).
    """
    u_r = _matvec(rot_full_inv(x[..., 9:13]), u_ref_t)
    return center_step(params, scenario.faulty_force_gen, scenario.r, x,
                       u + u_r + scenario.u_comp)


def linearize_plain(params, bank, X, U, u_ref, horizon):
    """vmap(jacfwd) of `stage_dynamics` over the flattened (B * Nt) stages,
    in the input dtype; batched plant leaves are gathered per stage row and
    mapped over axis 0, shared ones are not.

    Returns A (B,Nt,13,13), B (B,Nt,13,6), defects (B,Nt,13).
    """
    B, Nt = X.shape[0], horizon
    rows = torch.arange(B, device=X.device).repeat_interleave(Nt)
    prow, p_ax, sd = stage_rows(params, bank, rows)

    def f(p, s, x, u, ur):
        out = stage_dynamics(p, s, x, u, ur)
        return out, out

    jac = torch.func.jacfwd(f, argnums=(2, 3), has_aux=True)
    (A, Bm), f_vals = torch.func.vmap(jac, in_dims=(p_ax, 0, 0, 0, 0))(
        prow, sd, X[:, :-1].reshape(B * Nt, N_X), U.reshape(B * Nt, N_U),
        u_ref[:Nt].repeat(B, 1),
    )
    defects = f_vals.reshape(B, Nt, N_X) - X[:, 1:]
    # contiguous: vmap(jacfwd) hands back strided views, and the kernels that
    # read the jacobians (condensing once, the Riccati sweeps every ADMM
    # iteration) would otherwise copy them on every call
    return (A.reshape(B, Nt, N_X, N_X).contiguous(),
            Bm.reshape(B, Nt, N_X, N_U).contiguous(), defects)


def _row_stride(name, t, shape, B, shared_ok):
    """Elements between two rows of leaf t: 0 for a shared leaf (`shape`),
    the row's size for a batched one ((B, *shape)); raises otherwise."""
    size = 1
    for n in shape:
        size *= n
    if shared_ok and tuple(t.shape) == shape:
        return 0
    if tuple(t.shape) == (B, *shape):
        return size
    want = f"{shape} or {(B, *shape)}" if shared_ok else f"{(B, *shape)}"
    raise ValueError(f"linearize_lanes: {name} has shape {tuple(t.shape)}, takes {want}")


def _check(params, bank, X, U, u_ref, horizon):
    """Shapes, dtype, device and contiguity of every input the stage map
    reads; returns (B, Nt, the plant leaves' row strides, {name: input} in
    the order of the kernel's arguments)."""
    Nt = horizon
    if X.dim() != 3 or X.shape[1:] != (Nt + 1, N_X):
        raise ValueError(f"linearize_lanes: X has shape {tuple(X.shape)}, "
                         f"takes (B, {Nt + 1}, {N_X}) at horizon {Nt}")
    B = X.shape[0]
    if tuple(U.shape) != (B, Nt, N_U):
        raise ValueError(f"linearize_lanes: U has shape {tuple(U.shape)}, "
                         f"takes {(B, Nt, N_U)}")
    if u_ref.dim() != 2 or u_ref.shape[0] < Nt or u_ref.shape[1] != N_U:
        raise ValueError(f"linearize_lanes: u_ref has shape {tuple(u_ref.shape)}, "
                         f"takes (>= {Nt}, {N_U})")
    strides = [_row_stride(k, getattr(params, k), s, B, True)
               for k, s in _PARAM_SHAPES.items()]
    for k, s in _BANK_SHAPES.items():
        _row_stride(k, getattr(bank, k), s, B, False)
    # in the order of the kernel's arguments
    named = {"X": X, "U": U, "u_ref": u_ref,
             **{k: getattr(bank, k) for k in _BANK_SHAPES},
             **{k: getattr(params, k) for k in _PARAM_SHAPES}}
    for k, t in named.items():
        if t.dtype != X.dtype:
            raise ValueError(f"linearize_lanes: {k} is {t.dtype}, X is {X.dtype}")
        if t.device != X.device:
            raise ValueError(f"linearize_lanes: {k} on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"linearize_lanes: {k} is not contiguous")
    return B, Nt, strides, named


def _linearize_cuda(B, Nt, strides, t):
    """One launch of `csrc/linearize.cu` on the checked inputs `t` (`_check`)."""
    X = t["X"]
    fn_name = _LAUNCHERS.get(X.dtype)
    if fn_name is None:
        raise ValueError(f"linearize_lanes: dtype {X.dtype}, the kernel takes "
                         f"{sorted(map(str, _LAUNCHERS))}")
    kernels.require_cuda("linearize_lanes", X.dtype, *t.values())
    A = torch.empty((B, Nt, N_X, N_X), dtype=X.dtype, device=X.device)
    Bm = torch.empty((B, Nt, N_X, N_U), dtype=X.dtype, device=X.device)
    d = torch.empty((B, Nt, N_X), dtype=X.dtype, device=X.device)
    fn = kernels.function(
        "linearize", fn_name,
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    err = fn(*(v.data_ptr() for v in t.values()), A.data_ptr(), Bm.data_ptr(),
             d.data_ptr(), *strides, B, Nt, kernels.stream_of(X))
    kernels.check("linearize", fn_name, err)
    linearize_lanes.launches += 1
    return A, Bm, d


def linearize_lanes(params, bank, X, U, u_ref, horizon):
    """A (B,Nt,13,13), B (B,Nt,13,6) and defects (B,Nt,13), all contiguous,
    of the stage map along (X (B,Nt+1,13), U (B,Nt,6)) with u_ref[:Nt].

    Every input the stage map reads must be contiguous, in X's dtype and on
    its device.  CUDA tensors launch `csrc/linearize.cu` in their own dtype
    (float32 or float64); CPU tensors run `linearize_plain`.
    """
    B, Nt, strides, named = _check(params, bank, X, U, u_ref, horizon)
    if X.device.type == "cpu":
        linearize_lanes.plain_calls += 1
        return linearize_plain(params, bank, X, U, u_ref, horizon)
    return _linearize_cuda(B, Nt, strides, named)


linearize_lanes.launches = 0
linearize_lanes.plain_calls = 0
