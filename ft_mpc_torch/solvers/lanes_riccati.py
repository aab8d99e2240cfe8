"""Batched LQR re-solve for the stagewise (long-horizon) backend, counterpart
of `ft_mpc_tpu/solvers/lanes_riccati.py`.

The stagewise ADMM's x-update is an LQR re-solve against a fixed Riccati
factorization (`solvers/riccati.py:lqr_resolve`): a backward then a forward
affine sweep of 13-vector recursions over the horizon.  `lqr_resolve_lanes`
keeps the JAX wrapper's name and batch-leading shapes; the port has no lane
layout and no padding.  On CUDA tensors it runs `csrc/riccati.cu`: one
launch a re-solve for both sweeps, the horizon cut into chunks of L stages,
one warp a chunk, chained through each chunk's transfer matrix
(`riccati_split_lanes`).  It reads a per-phase preparation of the
factorization (`riccati_prepare_lanes`, one launch; `prepare_resolve` makes
it once per ADMM phase).  `riccati_plan` picks the chunks by shape: the
'chunked' design (C > 1) at small batches, where one warp a scenario would
leave SMs idle, the 'sequential' one (C = 1) at large ones
(`riccati_design`).  `riccati_bwd_lanes` and `riccati_fwd_lanes` run one
sweep each on an unprepared factorization (two launches each).

On CPU tensors the sweeps run their plain versions,
`riccati.resolve_bwd_plain` and `riccati.resolve_fwd_plain`.  Like the JAX
wrapper it works in float32 and casts back to the input dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ft_mpc_torch import kernels
from ft_mpc_torch.solvers.riccati import (
    LQRFactorization,
    resolve_bwd_plain,
    resolve_fwd_plain,
)
from ft_mpc_torch.utils.logging import span

N_X = 13
N_U = 6


def _check_shapes(name, B, named):
    """named: {argument: (tensor, its shape after the batch axis)}."""
    for key, (t, shape) in named.items():
        if tuple(t.shape) != (B, *shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"the kernel takes {(B, *shape)}")


def riccati_bwd_lanes(F, Bm, K, Quu_inv, PC, q, r, qN):
    """Backward sweep on the card: ks (B, Nt, 6), through a preparation
    (`riccati_prepare_lanes`) and `riccati_split_lanes` with parts 1.
    float32 CUDA tensors only."""
    kernels.require_cuda_f32("riccati_bwd_lanes", F, Bm, K, Quu_inv, PC, q, r, qN)
    B, Nt = F.shape[:2]
    _check_shapes("riccati_bwd_lanes", B, {
        "F": (F, (Nt, N_X, N_X)), "B": (Bm, (Nt, N_X, N_U)), "K": (K, (Nt, N_U, N_X)),
        "Quu_inv": (Quu_inv, (Nt, N_U, N_U)), "PC": (PC, (Nt, N_X)),
        "q": (q, (Nt, N_X)), "r": (r, (Nt, N_U)), "qN": (qN, (N_X,)),
    })
    # the backward passes read no c
    prep = _prepare(F, Bm, K, Quu_inv, PC, torch.zeros_like(PC))
    return riccati_split_lanes(prep, q, r, qN, None, parts=1)


def riccati_fwd_lanes(F, Bm, c, K, ks, x0):
    """Forward sweep on the card: (X (B, Nt+1, 13), U (B, Nt, 6)), through a
    preparation (`riccati_prepare_lanes`) and `riccati_split_lanes` with
    parts 2.  float32 CUDA tensors only."""
    kernels.require_cuda_f32("riccati_fwd_lanes", F, Bm, c, K, ks, x0)
    B, Nt = F.shape[:2]
    _check_shapes("riccati_fwd_lanes", B, {
        "F": (F, (Nt, N_X, N_X)), "B": (Bm, (Nt, N_X, N_U)), "c": (c, (Nt, N_X)),
        "K": (K, (Nt, N_U, N_X)), "ks": (ks, (Nt, N_U)), "x0": (x0, (N_X,)),
    })
    # the forward passes read no Quu_inv and no PC
    prep = _prepare(F, Bm, K, F.new_zeros((B, Nt, N_U, N_U)), torch.zeros_like(c), c)
    return riccati_split_lanes(prep, None, None, None, x0, parts=2, ks=ks)


# sweeps launched: a launch of both sweeps counts one of each
riccati_bwd_lanes.launches = 0
riccati_fwd_lanes.launches = 0


RICCATI_DESIGNS = ("sequential", "chunked")

# The stage record (floats): its sections' offsets in `csrc/riccati.cu`
# (namespace split).
REC = 588
REC_OFFSETS = {"Quu_inv": 0, "BPC": 36, "FPC": 44, "Ft": 60, "K": 232, "Bt": 320, "F": 400,
               "c": 572}


def riccati_plan(B: int, Nt: int) -> dict:
    """The re-solve's plan at (B, Nt), from the built library: the design
    ('chunked' where C > 1, else 'sequential'), stages a chunk (`chunk`, L)
    and `chunks` (C), its `threads` and dynamic shared memory (`smem_bytes`)
    a block, cudaOccupancyMaxActiveBlocksPerMultiprocessor
    (`blocks_per_sm`), and whether the block stages the horizon's linear
    terms in shared memory (`staged`; it does up to Nt of about 2200)."""
    fn = kernels.function("riccati", "riccati_plan",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 7)()
    fn(int(B), int(Nt), out)
    kernels.check("riccati", "riccati_plan", out[6])
    return {"design": RICCATI_DESIGNS[out[1] > 1], "chunk": out[0], "chunks": out[1],
            "threads": out[2], "smem_bytes": out[3], "blocks_per_sm": out[4],
            "staged": bool(out[5])}


def riccati_design(B: int, Nt: int) -> str:
    """Which design `lqr_resolve_lanes` runs at (B, Nt) on the card:
    'chunked' (16 chunks, or sqrt(2 Nt) on short horizons) up to B=320,
    'sequential' (one chunk) beyond.  Asks the built library."""
    return riccati_plan(B, Nt)["design"]


@functools.lru_cache(maxsize=None)
def _staged(Nt: int, chunk: int) -> bool:
    fn = kernels.function("riccati", "riccati_staged", [ctypes.c_int, ctypes.c_int])
    return bool(fn(Nt, chunk))


class RiccatiPrep(NamedTuple):
    """A phase's factorization, ready for `lqr_resolve_lanes`.

    fact: the factorization in float32, contiguous; dtype: the caller's, which
    the re-solve casts back to; design: 'plain' on the CPU, else the
    design (`riccati_design`); chunk: stages a chunk (0 on the CPU); rec
    (B, Nt, REC) and psi (B, C, 13, 13): `riccati_prepare_lanes`'s outputs
    (None on the CPU; psi None when C = 1).
    """

    fact: LQRFactorization
    dtype: torch.dtype
    design: str
    chunk: int
    rec: torch.Tensor | None
    psi: torch.Tensor | None


def riccati_prepare_plain(fact: LQRFactorization, chunk: int):
    """Plain version of kernel `riccati_prepare_f32`: (rec (B, Nt, REC),
    psi (B, C, 13, 13) or None when C = ceil(Nt / chunk) is 1).

    rec holds each stage's Quu_inv, B' PC, F' PC, F', K, B', F and c at
    `REC_OFFSETS` (row-major blocks, zero padding); psi[:, c] is chunk c's
    transfer matrix F_{t1-1} ... F_{t0} over its stages [t0, t1).
    """
    F, Bm, K, Qi, PC, c = fact.F, fact.B, fact.K, fact.Quu_inv, fact.PC, fact.c
    B, Nt = F.shape[:2]
    rec = torch.zeros((B, Nt, REC), dtype=F.dtype, device=F.device)
    sections = {"Quu_inv": Qi, "BPC": (PC.unsqueeze(-2) @ Bm).squeeze(-2),
                "FPC": (PC.unsqueeze(-2) @ F).squeeze(-2), "Ft": F.transpose(-1, -2),
                "Bt": Bm.transpose(-1, -2), "K": K, "F": F, "c": c}
    for name, block in sections.items():
        o = REC_OFFSETS[name]
        rec[..., o:o + block[0, 0].numel()] = block.reshape(B, Nt, -1)
    C = -(-Nt // chunk)
    if C == 1:
        return rec, None
    psi = []
    for t0 in range(0, Nt, chunk):
        P = F[:, t0]
        for t in range(t0 + 1, min(t0 + chunk, Nt)):
            P = F[:, t] @ P
        psi.append(P)
    return rec, torch.stack(psi, dim=1)


def riccati_prepare_lanes(fact: LQRFactorization, chunk: int):
    """The re-solve's per-phase preparation on the card (kernel
    `riccati_prepare_f32`, one launch): (rec, psi) as
    `riccati_prepare_plain`.  float32 contiguous CUDA tensors only."""
    F, Bm, K, Qi, PC, c = fact.F, fact.B, fact.K, fact.Quu_inv, fact.PC, fact.c
    kernels.require_cuda_f32("riccati_prepare_lanes", F, Bm, K, Qi, PC, c)
    B, Nt = F.shape[:2]
    _check_shapes("riccati_prepare_lanes", B, {
        "F": (F, (Nt, N_X, N_X)), "B": (Bm, (Nt, N_X, N_U)), "K": (K, (Nt, N_U, N_X)),
        "Quu_inv": (Qi, (Nt, N_U, N_U)), "PC": (PC, (Nt, N_X)), "c": (c, (Nt, N_X)),
    })
    C = -(-Nt // chunk)
    rec = torch.empty((B, Nt, REC), dtype=torch.float32, device=F.device)
    psi = (torch.empty((B, C, N_X, N_X), dtype=torch.float32, device=F.device)
           if C > 1 else None)
    fn = kernels.function(
        "riccati", "riccati_prepare_f32",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    err = fn(F.data_ptr(), Bm.data_ptr(), K.data_ptr(), Qi.data_ptr(), PC.data_ptr(),
             c.data_ptr(), rec.data_ptr(), 0 if psi is None else psi.data_ptr(),
             B, Nt, int(chunk), kernels.stream_of(F))
    kernels.check("riccati", "riccati_prepare_f32", err)
    riccati_prepare_lanes.launches += 1
    return rec, psi


riccati_prepare_lanes.launches = 0


def riccati_split_lanes(prep: RiccatiPrep, q, r, qN, x0, parts: int = 3, ks=None):
    """A re-solve on the card (kernel `riccati_split_f32`, one launch).

    parts 3: both sweeps, returns (X, U); 1: the backward sweep, returns ks
    (x0 unused, may be None); 2: the forward sweep from `ks`, returns
    (X, U) (q, r, qN unused, may be None).  A launch counts one backward
    and/or one forward sweep, and one launch of its design
    (`riccati_split_lanes.launches_by_design`).  float32 contiguous CUDA
    tensors only.
    """
    f = prep.fact
    B, Nt = f.F.shape[:2]
    if prep.design not in RICCATI_DESIGNS:
        raise ValueError(f"riccati_split_lanes: a {prep.design!r} preparation")
    if parts not in (1, 2, 3):
        raise ValueError(f"riccati_split_lanes: parts {parts} is not 1, 2 or 3")
    if parts == 2 and ks is None:
        raise ValueError("riccati_split_lanes: the forward sweep alone reads ks")
    named = {"rec": (prep.rec, (Nt, REC))}
    if parts & 1:
        named.update(q=(q, (Nt, N_X)), r=(r, (Nt, N_U)), qN=(qN, (N_X,)))
    if parts & 2:
        named["x0"] = (x0, (N_X,))
    if parts == 2:
        named["ks"] = (ks, (Nt, N_U))
    C = -(-Nt // prep.chunk)
    if (prep.psi is None) != (C == 1):
        raise ValueError(f"riccati_split_lanes: {C} chunks need "
                         f"{'no' if C == 1 else 'the'} transfer matrices")
    if prep.psi is not None:
        named["psi"] = (prep.psi, (C, N_X, N_X))
    kernels.require_cuda_f32("riccati_split_lanes", *(t for t, _ in named.values()))
    _check_shapes("riccati_split_lanes", B, named)
    dev = f.F.device
    if parts == 1 or (parts == 3 and not _staged(Nt, prep.chunk)):
        ks = torch.empty((B, Nt, N_U), dtype=torch.float32, device=dev)
    elif parts == 3:
        ks = None  # both sweeps: ks stays on the chip
    X = U = None
    if parts & 2:
        X = torch.empty((B, Nt + 1, N_X), dtype=torch.float32, device=dev)
        U = torch.empty((B, Nt, N_U), dtype=torch.float32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    fn = kernels.function(
        "riccati", "riccati_split_f32",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    err = fn(prep.rec.data_ptr(), ptr(prep.psi), ptr(q), ptr(r), ptr(qN), ptr(x0), ptr(ks),
             ptr(X), ptr(U), B, Nt, prep.chunk, int(parts), kernels.stream_of(f.F))
    kernels.check("riccati", "riccati_split_f32", err)
    riccati_split_lanes.launches_by_design[prep.design] += 1
    for sweep, bit in ((riccati_bwd_lanes, 1), (riccati_fwd_lanes, 2)):
        if parts & bit:
            sweep.launches += 1
    return ks if parts == 1 else (X, U)


riccati_split_lanes.launches_by_design = dict.fromkeys(RICCATI_DESIGNS, 0)


def prepared(fact: LQRFactorization, chunk: int) -> RiccatiPrep:
    """The preparation of a float32 contiguous CUDA factorization at `chunk`
    stages a chunk (one `riccati_prepare_lanes` launch); `prepare_resolve`
    takes the plan's chunk."""
    rec, psi = riccati_prepare_lanes(fact, chunk)
    return RiccatiPrep(fact, torch.float32, RICCATI_DESIGNS[psi is not None], chunk, rec, psi)


def _prepare(F, Bm, K, Quu_inv, PC, c) -> RiccatiPrep:
    f = LQRFactorization(A=None, B=Bm, c=c, P=None, K=K, Quu_inv=Quu_inv, F=F, PC=PC)
    return prepared(f, riccati_plan(*F.shape[:2])["chunk"])


def prepare_resolve(fact: LQRFactorization) -> RiccatiPrep:
    """Once a phase: the factorization in float32 and, on the card, its
    preparation (one `riccati_prepare_lanes` launch, in the span
    `ft_mpc.riccati`).  On the CPU nothing more than the cast."""
    dtype = fact.F.dtype
    f = LQRFactorization(*(x.to(torch.float32).contiguous() for x in fact))
    if f.F.device.type == "cpu":
        return RiccatiPrep(f, dtype, "plain", 0, None, None)
    with span("ft_mpc.riccati"):
        prep = prepared(f, riccati_plan(*f.F.shape[:2])["chunk"])
    return prep._replace(dtype=dtype)


def lqr_resolve_lanes(fact: LQRFactorization | RiccatiPrep, q, r, qN, x0):
    """Batched `lqr_resolve`: one kernel launch on the card.

    fact: an `LQRFactorization` whose leaves carry a leading batch axis B
    (prepared on the fly), or the `RiccatiPrep` of `prepare_resolve`.
    q (B, Nt, n), r (B, Nt, m), qN (B, n), x0 (B, n).
    Returns (X (B, Nt+1, n), U (B, Nt, m)) in the factorization's dtype.
    float32 inside (a float32 contiguous input is used as it is, not
    copied).  CUDA tensors launch `csrc/riccati.cu` (n = 13, m = 6 only);
    CPU tensors run the plain sweeps.
    """
    prep = fact if isinstance(fact, RiccatiPrep) else prepare_resolve(fact)
    f = prep.fact
    q, r, qN, x0 = (x.to(torch.float32).contiguous() for x in (q, r, qN, x0))
    if prep.design == "plain":
        ks = resolve_bwd_plain(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
        X, U = resolve_fwd_plain(f.F, f.B, f.c, f.K, ks, x0)
    else:
        with span("ft_mpc.riccati"):
            X, U = riccati_split_lanes(prep, q, r, qN, x0)
    return X.to(prep.dtype), U.to(prep.dtype)
