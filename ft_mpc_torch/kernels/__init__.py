"""Build and bind the hand-written CUDA kernels in `ft_mpc_torch/csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into its
own shared library with a plain C interface, at first use, into `build/` at
the root of the checkout, keyed by a hash of the sources and flags; ctypes
loads it.  `build()` starts one nvcc per source, all together.  Nothing
here runs at import: the CPU tests import every module, and this machine
class has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"
SOURCES = ("condense", "admm", "alloc", "riccati", "linearize", "terminal")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, CUDA_PATH)")


def lib_path(name: str) -> Path:
    """Where source `name` builds to: build/<name>-<hash of sources+flags>.so."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile the sources not yet built; returns {name: nvcc output}.

    One nvcc process per source, all started before any is waited on.
    The library is written under a temporary name and renamed into place,
    so a concurrent or interrupted build never leaves a partial file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def function(lib_name: str, fn_name: str, argtypes) -> object:
    """ctypes handle of `fn_name` in library `lib_name` (built on first use).

    Every launcher returns its cudaError_t as an int.
    """
    key = (lib_name, fn_name)
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            lib = _LIBS.get(lib_name)
            if lib is None:
                build((lib_name,))
                lib = ctypes.CDLL(str(lib_path(lib_name)))
                lib.ftmpc_error_string.argtypes = [ctypes.c_int]
                lib.ftmpc_error_string.restype = ctypes.c_char_p
                _LIBS[lib_name] = lib
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
    return fn


def check(lib_name: str, fn_name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (refused or failed launch)."""
    if err != 0:
        msg = _LIBS[lib_name].ftmpc_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous `dtype` on the current CUDA device."""
    for t in tensors:
        # the device type first: a build without CUDA has no current device to ask for
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, kernel takes cuda tensors")
        dev = torch.cuda.current_device()
        if t.device.index != dev:
            raise ValueError(f"{name}: tensor on {t.device}, kernel runs on cuda:{dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous float32 on the current CUDA device."""
    require_cuda(name, torch.float32, *tensors)
