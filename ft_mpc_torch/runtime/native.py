"""Batched attainable-wrench hulls: the C++ engine `csrc/zonotope_native.cpp`
bound with ctypes, or the numpy path on request.

Counterpart of `ft_mpc_tpu/runtime/native.py`.  The library is compiled by
`g++` at first use into `build/` at the root of the checkout, keyed by a
hash of the source and flags (as `ft_mpc_torch.kernels` builds the CUDA
sources), written under a temporary name and renamed into place.  A failed
build raises with the compiler's output: the numpy path is taken only when
the caller asks for it (`engine="numpy"`), never as a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ft_mpc_torch.kernels import BUILD_DIR, CSRC

SOURCE = CSRC / "zonotope_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_LOCK = threading.Lock()


def lib_path() -> Path:
    """build/zonotope_native-<hash of source+flags>.so"""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"zonotope_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless this source is already built; its path."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("zonotope_native: g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"zonotope_native: g++ exit {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.ftmpc_batched_wrench_hulls
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ]
            _lib = lib
    return _lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def batched_wrench_hulls(
    D: np.ndarray,
    max_thrust: float,
    broken: np.ndarray,  # (B, n_thrusters)
    intensity: np.ndarray,  # (B, n_thrusters)
    max_facets: int = 32,
    n_threads: int | None = None,
    engine: str = "native",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded float64 (A (B, F, 6), b (B, F), mask (B, F)) hulls of a fault bank.

    engine 'native': the threaded C++ engine; rows whose wrench set is
    degenerate (it returns no facet for them) are recomputed with the numpy
    path, as the JAX package does.  engine 'numpy': every row with
    `geometry.zonotope.attainable_wrench_polytope`.  The two give the same
    facets; their row order differs (the engine interleaves +n, -n).
    """
    from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope

    if engine not in ("native", "numpy"):
        raise ValueError(f"engine {engine!r}: 'native' or 'numpy'")
    D = np.ascontiguousarray(D, dtype=np.float64)
    broken = np.ascontiguousarray(np.atleast_2d(broken), dtype=np.float64)
    intensity = np.ascontiguousarray(np.atleast_2d(intensity), dtype=np.float64)
    B, n_thr = broken.shape
    if D.shape != (6, n_thr):
        raise ValueError(f"D {D.shape}, expected (6, {n_thr})")
    A = np.zeros((B, max_facets, 6), dtype=np.float64)
    b = np.ones((B, max_facets), dtype=np.float64)
    mask = np.zeros((B, max_facets), dtype=np.float64)
    if engine == "native":
        rc = _load().ftmpc_batched_wrench_hulls(
            _as_c(D), n_thr, ctypes.c_double(max_thrust),
            _as_c(broken), _as_c(intensity), B, max_facets,
            _as_c(A), _as_c(b), _as_c(mask),
            n_threads or (os.cpu_count() or 1),
        )
        if rc != 0:
            raise ValueError(
                f"a fault pattern produced more than {max_facets} facets; "
                "pass a larger max_facets"
            )
        rows = np.where(mask.sum(axis=1) == 0)[0]
    else:
        rows = range(B)
    for s in rows:
        poly = attainable_wrench_polytope(D, max_thrust, broken[s], intensity[s])
        A[s], b[s], mask[s] = poly.as_padded(max_facets)
    return A, b, mask
