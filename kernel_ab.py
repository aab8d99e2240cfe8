#!/usr/bin/env python3
"""Time two builds of the kernels on one card, in turns.

    python3 kernel_ab.py OLD_ROOT                   # from the root of a checkout
    python3 kernel_ab.py OLD_ROOT --only riccati    # one source's cases
    python3 kernel_ab.py OLD_ROOT --only linearize

OLD_ROOT is the root of another checkout of the repo (for example a `git
archive` of the parent commit).  Its `ft_mpc_torch/csrc/condense.cu`,
`admm.cu`, `alloc.cu` and `riccati.cu` are built with the same nvcc flags
into OLD_ROOT/build and loaded beside this checkout's own build.  The
condensing, ADMM and allocation kernels of both are called through the same
ctypes code on the same inputs, the condensed main path's
(`chip_smoke.py`: B=2048, Nt=15, after init and 12 chained steps):
- condense on the stage jacobians of the final warm start;
- ADMM on the QP of the final warm start at T=64 (60 iterations), on the
  worst 256 rows as the cleanup runs it (600 iterations), with the
  state-box and rate rows (T=596, 60 iterations) and on its worst 256 rows
  (T=596, 600 iterations); and at B=256, T=64, 60 iterations on the QP of
  the condensed path at horizons 20, 38 and 40 after 2 chained steps;
- allocation on the final step's wrenches (B=2048, F=32, 60 FISTA and 40
  ADMM iterations), and on their first 512 rows (the stagewise path's batch).
Each case is timed old, new, new, old (CUDA events, median of 3 rounds of
back-to-back calls each, all queued before the first event), and both
outputs are held against the plain version: condense and ADMM within
chip_smoke's tolerances; allocation u within TOL_ALLOC_MAIN on the rows where
both took the same branches, with the rows whose branches differ counted (at
most MAX_FLIP_SHARE of them), and the hull test must decide every row as
the old kernel does.

The Riccati re-solve runs on the stagewise path's own inputs
(`chip_smoke.capture_riccati` after 2 steps at B=512, Nt=240): its
factorization and linear terms at B=512 (the main ADMM), at the cleanup's
B=64 and on the first 8 rows of those (the long-horizon envelope's B=64
cleanup), and on the first 128, 256 and 384 rows of the B=512 ones (where
the plan's chunk count falls to one).  Both sides are called through the
same ctypes code (`split_prepare`, `call_split`).  The new side is this
build's `riccati_split_f32` on its `riccati_prepare_f32` at the chunk its
`riccati_plan` gives, as `lqr_resolve_lanes` runs it on a phase's
`prepare_resolve` (the preparation is made once, outside the timing, as the
solver makes it once a phase).  The old side is chosen by what OLD_ROOT's
library exports: where it has `riccati_split_f32` (with `riccati_plan`,
`riccati_staged` and `riccati_prepare_f32`), OLD_ROOT's own split re-solve
on its own preparation and plan ("split"); where it has only
`riccati_bwd_f32` and `riccati_fwd_f32` (a build of the
one-warp-a-scenario sweeps, before `riccati_split_f32` replaced them),
those two launches ("pair").  Each result names the old side that ran
(`old_side`).  Each sweep is also timed alone, each side's pair held
against the plain sweeps within TOL_RICCATI, and both preparations timed.
The new build's re-solve is also timed at other chunk lengths on the same
inputs (`chunk_ms`).

The linearization (`csrc/linearize.cu`, where OLD_ROOT has it) runs at
chip_smoke's LIN_SHAPES on each path's warm-start trajectory with seeded
inputs (`chip_smoke.linearize_inputs`): both builds' `linearize_f32`
through the same ctypes code, held against `linearize_plain` within
TOL_LINEARIZE (`chip_smoke.lin_gap`).  Without `--only`, every source
OLD_ROOT has is built and compared.

Prints the card's name and power limit and one JSON line per case.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

CONDENSE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
ADMM_ARGS = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])
ALLOC_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
              + [ctypes.c_void_p])
# the split re-solve `riccati_split_f32`, as `solvers/lanes_riccati.py` calls it
RICCATI_SPLIT = {"riccati_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                 "riccati_staged": [ctypes.c_int, ctypes.c_int],
                 "riccati_prepare_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p],
                 "riccati_split_f32": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p]}
# the two sweep kernels of earlier builds
RICCATI_PAIR = {"riccati_bwd_f32": [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                                            ctypes.c_void_p],
                "riccati_fwd_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                                            ctypes.c_void_p]}
LINEARIZE_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# {source: {launcher: argtypes}}; a launcher OLD_ROOT's library lacks is left out
ARGS = {"condense": {"condense_f32": CONDENSE_ARGS}, "admm": {"admm_f32": ADMM_ARGS},
        "alloc": {"alloc_f32": ALLOC_ARGS}, "riccati": {**RICCATI_SPLIT, **RICCATI_PAIR},
        "linearize": {"linearize_f32": LINEARIZE_ARGS}}
# chunk lengths the re-solve is also timed at (Nt=240: 1 to 16 chunks)
RICCATI_CHUNKS = (240, 120, 80, 60, 40, 30, 24, 20, 15)
RICCATI_MIDDLE = (128, 256, 384)  # rows of the B=512 capture, timed as well


def build_old(root: Path, names) -> dict:
    """{source: {launcher: handle}} of OLD_ROOT for the sources `names`,
    built in parallel."""
    from ft_mpc_torch import kernels

    out_dir = root / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = out_dir / f"{name}-ab.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
               str(root / "ft_mpc_torch" / "csrc" / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"old {name} build failed:\n{text}")
        usage = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        print(f"ptxas old {name}: " + " | ".join(usage), flush=True)
        lib = ctypes.CDLL(str(so))
        fns[name] = {}
        for fn_name, argtypes in ARGS[name].items():
            if not hasattr(lib, fn_name):
                continue
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name][fn_name] = fn
        if not (all(k in fns[name] for k in ARGS[name]) or name == "riccati"
                and old_riccati_side(fns[name]) is not None):
            raise RuntimeError(f"old {name}: the library lacks launchers of {sorted(ARGS[name])}")
    return fns


def old_riccati_side(fns) -> str | None:
    """'split' where OLD_ROOT exports the split re-solve, 'pair' where only
    the two sweep kernels, else None."""
    if all(k in fns for k in RICCATI_SPLIT):
        return "split"
    if all(k in fns for k in RICCATI_PAIR):
        return "pair"
    return None


def call_condense(fn, A, Bm, d):
    from ft_mpc_torch import kernels

    B, Nt = A.shape[:2]
    S = torch.empty((B, Nt, 13, 6 * Nt), dtype=torch.float32, device=A.device)
    phi = torch.empty((B, Nt, 13), dtype=torch.float32, device=A.device)
    err = fn(A.data_ptr(), Bm.data_ptr(), d.data_ptr(), S.data_ptr(), phi.data_ptr(),
             B, Nt, kernels.stream_of(A))
    if err:
        raise RuntimeError(f"condense_f32: CUDA error {err}")
    return S, phi


def call_admm(fn, args, sigma, alpha, iters, y_max):
    from ft_mpc_torch import kernels

    outs = [torch.empty_like(t) for t in args[6:11]]
    B, Nt, F = args[2].shape
    T = args[4].shape[1]
    err = fn(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs), B, Nt, F, T,
             float(sigma), float(alpha), int(iters), float(y_max), kernels.stream_of(args[0]))
    if err:
        raise RuntimeError(f"admm_f32: CUDA error {err}")
    return outs


def call_alloc(fn, args, iters=cs.ALLOC_HYPER[:2]):
    from ft_mpc_torch import kernels

    B, F = args[5].shape
    u = torch.empty((B, 16), dtype=torch.float32, device=args[1].device)
    w_des = torch.empty((B, 6), dtype=torch.float32, device=args[1].device)
    flags = torch.empty((B, 3), dtype=torch.float32, device=args[1].device)
    fista, admm = iters
    hyper = cs.ALLOC_HYPER[2:]
    err = fn(*(t.data_ptr() for t in args), u.data_ptr(), w_des.data_ptr(), flags.data_ptr(),
             B, F, fista, admm, *(float(h) for h in hyper), kernels.stream_of(args[1]))
    if err:
        raise RuntimeError(f"alloc_f32: CUDA error {err}")
    return u, w_des, flags


def alloc_vs(got, ref) -> dict:
    """Rows whose branches differ (of them, rows whose hull test differs) and
    max |du| on the rows with equal branches, as chip_smoke.check_alloc_main
    counts them."""
    bg, br = got[2][:, :2] > 0.5, ref[2][:, :2] > 0.5
    same = (bg == br).all(dim=1)
    du = (got[0].double() - ref[0].double()).abs().max(dim=1).values
    return {"branch_rows": int((~same).sum()), "hull_rows": int((bg[:, 0] != br[:, 0]).sum()),
            "u_err": float(du[same].max()) if bool(same.any()) else 0.0}


def alloc_phases(fn, args, device) -> dict:
    """The allocation kernel's time split by timing it with the FISTA and
    ADMM loops cut to 0 iterations: the rest (loads, hull test, the two 6x6
    inversions, polish) in ms, and us per FISTA and per ADMM iteration."""
    fista, admm = cs.ALLOC_HYPER[:2]
    t = {it: cs.time_ms(lambda: call_alloc(fn, args, it), 20, device, device_only=True)
         for it in ((0, 0), (fista, 0), (0, admm))}
    return {"rest_ms": t[(0, 0)],
            "fista_us_per_iter": 1e3 * (t[(fista, 0)] - t[(0, 0)]) / fista,
            "admm_us_per_iter": 1e3 * (t[(0, admm)] - t[(0, 0)]) / admm}


def split_prepare(fns, f, chunk=None):
    """A side's preparation of factorization `f` (`riccati_prepare_f32`) at
    `chunk` stages a chunk, by default its own `riccati_plan`'s: (rec, psi,
    chunk)."""
    from ft_mpc_torch import kernels
    from ft_mpc_torch.solvers.lanes_riccati import REC

    B, Nt = f.F.shape[:2]
    if chunk is None:
        plan = (ctypes.c_int * 7)()
        fns["riccati_plan"](B, Nt, plan)
        if plan[6]:
            raise RuntimeError(f"riccati_plan: CUDA error {plan[6]}")
        chunk = plan[0]
    C = -(-Nt // chunk)
    rec = torch.empty((B, Nt, REC), dtype=torch.float32, device=f.F.device)
    psi = (torch.empty((B, C, 13, 13), dtype=torch.float32, device=f.F.device)
           if C > 1 else None)
    err = fns["riccati_prepare_f32"](f.F.data_ptr(), f.B.data_ptr(), f.K.data_ptr(),
                                     f.Quu_inv.data_ptr(), f.PC.data_ptr(), f.c.data_ptr(),
                                     rec.data_ptr(), 0 if psi is None else psi.data_ptr(),
                                     B, Nt, chunk, kernels.stream_of(f.F))
    if err:
        raise RuntimeError(f"riccati_prepare_f32: CUDA error {err}")
    return rec, psi, chunk


def call_split(fns, prep, q, r, qN, x0, parts=3, ks=None):
    """A side's `riccati_split_f32` on its preparation: parts 3 (X, U), 1 ks,
    2 (X, U) from `ks`; ks stays on the chip where the side stages it."""
    from ft_mpc_torch import kernels

    rec, psi, chunk = prep
    B, Nt = rec.shape[:2]
    dev = rec.device
    if parts == 1 or (parts == 3 and not fns["riccati_staged"](Nt, chunk)):
        ks = torch.empty((B, Nt, 6), dtype=torch.float32, device=dev)
    X = U = None
    if parts & 2:
        X = torch.empty((B, Nt + 1, 13), dtype=torch.float32, device=dev)
        U = torch.empty((B, Nt, 6), dtype=torch.float32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = fns["riccati_split_f32"](rec.data_ptr(), ptr(psi), ptr(q), ptr(r), ptr(qN), ptr(x0),
                                   ptr(ks), ptr(X), ptr(U), B, Nt, chunk, parts,
                                   kernels.stream_of(rec))
    if err:
        raise RuntimeError(f"riccati_split_f32: CUDA error {err}")
    return ks if parts == 1 else (X, U)


def old_bwd(fns, f, q, r, qN):
    """OLD_ROOT's backward sweep kernel (builds before the split re-solve): ks."""
    from ft_mpc_torch import kernels

    B, Nt = f.F.shape[:2]
    ks = torch.empty((B, Nt, 6), dtype=torch.float32, device=f.F.device)
    err = fns["riccati_bwd_f32"](f.F.data_ptr(), f.B.data_ptr(), f.K.data_ptr(),
                                 f.Quu_inv.data_ptr(), f.PC.data_ptr(), q.data_ptr(),
                                 r.data_ptr(), qN.data_ptr(), ks.data_ptr(), B, Nt,
                                 kernels.stream_of(f.F))
    if err:
        raise RuntimeError(f"old riccati_bwd_f32: CUDA error {err}")
    return ks


def old_fwd(fns, f, ks, x0):
    """OLD_ROOT's forward sweep kernel (builds before the split re-solve): (X, U)."""
    from ft_mpc_torch import kernels

    B, Nt = f.F.shape[:2]
    X = torch.empty((B, Nt + 1, 13), dtype=torch.float32, device=f.F.device)
    U = torch.empty((B, Nt, 6), dtype=torch.float32, device=f.F.device)
    err = fns["riccati_fwd_f32"](f.F.data_ptr(), f.B.data_ptr(), f.c.data_ptr(),
                                 f.K.data_ptr(), ks.data_ptr(), x0.data_ptr(), X.data_ptr(),
                                 U.data_ptr(), B, Nt, kernels.stream_of(f.F))
    if err:
        raise RuntimeError(f"old riccati_fwd_f32: CUDA error {err}")
    return X, U


def riccati_results(old, device):
    """The Riccati re-solve, old build against new, on the stagewise path's
    captured inputs (module docstring); yields one result a shape."""
    from ft_mpc_torch import kernels
    from ft_mpc_torch.solvers import lanes_riccati as lr
    from ft_mpc_torch.solvers.riccati import (
        LQRFactorization,
        resolve_bwd_plain,
        resolve_fwd_plain,
    )

    sw = cs.Ctx(device, torch.float32, cs.SW_BATCH, stagewise_horizon=cs.SW_HORIZON)
    _, warm, _ = cs.drive_main_path(sw, 0, 2)
    cap = cs.capture_riccati(sw, warm)
    K = sw.cfg.cleanup_k
    first = lambda a, n: (LQRFactorization(*(t[:n].contiguous() for t in a[0])),
                          *(t[:n].contiguous() for t in a[1:]))
    cases = [("stagewise path", cap[cs.SW_BATCH]), ("cleanup", cap[K]),
             (f"the cleanup's first {cs.RICCATI_SMALL} rows", first(cap[K], cs.RICCATI_SMALL))]
    # batches between, where the plan moves from many chunks to one
    cases += [(f"the stagewise path's first {n} rows", first(cap[cs.SW_BATCH], n))
              for n in RICCATI_MIDDLE]
    del sw, warm, cap
    new = {k: kernels.function("riccati", k, a) for k, a in RICCATI_SPLIT.items()}
    fns = old["riccati"]
    side = old_riccati_side(fns)
    for label, (fact, q, r, qN, x0) in cases:
        f = LQRFactorization(*(t.float().contiguous() for t in fact))
        q, r, qN, x0 = (t.float().contiguous() for t in (q, r, qN, x0))
        B, Nt = f.F.shape[:2]
        ks_p = resolve_bwd_plain(f.F, f.B, f.K, f.Quu_inv, f.PC, q, r, qN)
        ref = (ks_p, *resolve_fwd_plain(f.F, f.B, f.c, f.K, ks_p, x0))
        sides = {"new": (new, split_prepare(new, f))}
        if side == "split":
            sides["old"] = (fns, split_prepare(fns, f))
        run = {name: {"pair": lambda s=s: call_split(*s, q, r, qN, x0),
                      "bwd": lambda s=s: call_split(*s, q, r, qN, None, parts=1),
                      "fwd": lambda s=s: call_split(*s, None, None, None, x0, parts=2,
                                                    ks=ks_p)}
               for name, s in sides.items()}
        if side == "pair":
            run["old"] = {"pair": lambda: old_fwd(fns, f, old_bwd(fns, f, q, r, qN), x0),
                          "bwd": lambda: old_bwd(fns, f, q, r, qN),
                          "fwd": lambda: old_fwd(fns, f, ks_p, x0)}
        got = {name: (r_["bwd"](), *r_["pair"]()) for name, r_ in run.items()}
        bounds = cs.riccati_bounds(f.F, f.B, f.c, f.K, f.Quu_inv, f.PC, q, r, qN, x0)
        res = {"kernel": "riccati", "shape": f"{label}: B={B} Nt={Nt}", "old_side": side,
               "plan": lr.riccati_plan(B, Nt),
               "bound_ms": bounds["pair"][0], "bound_by": bounds["pair"][1],
               "old_max_rel_err": cs.rel_err(got["old"], ref)[1],
               "new_max_rel_err": cs.rel_err(got["new"], ref)[1],
               **in_turns(run["old"]["pair"], run["new"]["pair"], 20, device)}
        for key in ("bwd", "fwd"):
            t = in_turns(run["old"][key], run["new"][key], 20, device)
            res[key] = {"old_ms": t["old_ms"], "new_ms": t["new_ms"], "speedup": t["speedup"],
                        "bound_ms": bounds[key][0]}
        for name, (side_fns, prep) in sides.items():
            res[f"{name}_prepare_ms"] = cs.time_ms(
                lambda: split_prepare(side_fns, f, prep[2]), 20, device, device_only=True)
        chunk_ms = {}
        for L in RICCATI_CHUNKS:
            if L > Nt:
                continue
            try:  # a chunk count whose block does not fit is refused (None)
                p_L = split_prepare(new, f, L)
                chunk_ms[L] = cs.time_ms(lambda: call_split(new, p_L, q, r, qN, x0), 20,
                                         device, device_only=True)
            except RuntimeError:
                chunk_ms[L] = None
        res["chunk_ms"] = chunk_ms
        yield res


def in_turns(old, new, reps, device) -> dict:
    """ms of each side, timed old, new, new, old."""
    t = [cs.time_ms(f, reps, device, device_only=True) for f in (old, new, new, old)]
    o, nw = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return {"old_ms": o, "new_ms": nw, "speedup": o / nw, "turns_ms": t}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if len(argv) == 3 and argv[1] == "--only" and argv[2] in ARGS:
        only = argv[2]
    elif len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    old_root = Path(argv[0]).resolve()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import ft_mpc_torch

    ft_mpc_torch.pin_fp32_matmuls()
    device = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    cs.build_kernels()
    have = [n for n in ARGS if (old_root / "ft_mpc_torch" / "csrc" / f"{n}.cu").is_file()]
    old = build_old(old_root, [only] if only else have)
    results = iter(())
    if only in (None, "riccati"):
        results = riccati_results(old, device)
    if only in (None, "condense", "admm", "alloc"):
        results = itertools.chain(results, condensed_results(old, device, only))
    if "linearize" in old:
        results = itertools.chain(results, linearize_results(old, device))

    ok = True
    for r in results:  # each printed as it comes
        cs.sync(device)
        r["old_bound_share"] = r["bound_ms"] / r["old_ms"]
        r["new_bound_share"] = r["bound_ms"] / r["new_ms"]
        print("ab: " + json.dumps(r), flush=True)
        if r["kernel"] == "condense":
            ok &= r["new_max_abs_err"] <= r["tol"]
        elif r["kernel"] == "admm":
            ok &= r["new_max_rel_err"] <= cs.TOL_ADMM
        elif r["kernel"] == "riccati":
            ok &= r["new_max_rel_err"] <= cs.TOL_RICCATI
        elif r["kernel"] == "linearize":
            ok &= r["new_max_rel_err"] <= cs.TOL_LINEARIZE
        else:
            # the hull test keeps its rounding: the same decision as the old kernel on every row
            v = r["new_vs_plain"]
            ok &= (v["u_err"] <= cs.TOL_ALLOC_MAIN and v["branch_rows"] <= cs.MAX_FLIP_SHARE * r["rows"]
                   and r["new_vs_old"]["hull_rows"] == 0)
    print(f"card: {cs.card_line()}", flush=True)
    return 0 if ok else 1


def call_linearize(fn, args, Nt):
    """One launch of a build's `linearize_f32`, as `ops.linearize` makes it."""
    from ft_mpc_torch import kernels
    from ft_mpc_torch.ops import linearize as lin

    B, Nt, strides, t = lin._check(*args, Nt)
    X = t["X"]
    outs = [torch.empty(shape, dtype=X.dtype, device=X.device)
            for shape in ((B, Nt, 13, 13), (B, Nt, 13, 6), (B, Nt, 13))]
    err = fn(*(v.data_ptr() for v in t.values()), *(o.data_ptr() for o in outs), *strides,
             B, Nt, kernels.stream_of(X))
    if err:
        raise RuntimeError(f"linearize_f32: CUDA error {err}")
    return outs


def linearize_results(old, device):
    """The linearization at chip_smoke's LIN_SHAPES (module docstring).
    Runs when first iterated."""
    from ft_mpc_torch import kernels
    from ft_mpc_torch.ops import linearize as lin

    fns = (old["linearize"]["linearize_f32"],
           kernels.function("linearize", "linearize_f32", LINEARIZE_ARGS))
    for B, Nt in cs.LIN_SHAPES:
        args = cs.linearize_inputs(device, B, Nt)
        ref = lin.linearize_plain(*args, Nt)
        errs = [cs.lin_gap(call_linearize(fn, args, Nt), ref, args[2]) for fn in fns]
        b_ms, b_by = cs.linearize_bound(args, ref)
        yield {"kernel": "linearize", "shape": f"B={B} Nt={Nt}", "bound_ms": b_ms,
               "bound_by": b_by, "old_max_rel_err": errs[0], "new_max_rel_err": errs[1],
               **in_turns(lambda: call_linearize(fns[0], args, Nt),
                          lambda: call_linearize(fns[1], args, Nt), 20, device)}


def condensed_results(old, device, only):
    """The condensing, ADMM and allocation cases (module docstring); `only`
    one of them.  Runs when first iterated."""
    from ft_mpc_torch import kernels

    names = [only] if only else ["condense", "admm", "alloc"]
    old = {name: old[name][f"{name}_f32"] for name in names}
    new = {name: kernels.function(name, f"{name}_f32", ARGS[name][f"{name}_f32"])
           for name in names}

    ctx = cs.Ctx(device, torch.float32, cs.BATCH)
    _, warm, out = cs.drive_main_path(ctx, 10, 2)
    results = []
    sp = ctx.sp
    if "condense" in names:
        results.append(condense_result(ctx, warm, old, new, device))
    if "admm" in names:
        results += admm_results(ctx, warm, out, old, new, device)
    if "alloc" in names:
        results += alloc_results(ctx, out, old, new, device)
    yield from results


def condense_result(ctx, warm, old, new, device) -> dict:
    from ft_mpc_torch.solvers.lanes_condense import condense_plain

    sp = ctx.sp
    X = torch.cat([sp.robot_to_center(ctx.bank.r, ctx.x0)[:, None], warm.X[:, 1:]], dim=1)
    A, Bm, d = (t.float().contiguous() for t in
                sp._linearize(ctx.params, ctx.bank, ctx.cfg, X, warm.U, ctx.u_ref))
    ref = condense_plain(A, Bm, d)
    errs = [cs.rel_err(call_condense(fn, A, Bm, d), ref)[0]
            for fn in (old["condense"], new["condense"])]
    tol_condense = cs.TOL_CONDENSE * max(1.0, float(ref[0].abs().max()), float(ref[1].abs().max()))
    B, Nt = A.shape[:2]
    b_ms, b_by = cs.bound_ms(cs.nbytes(A, Bm, d, *ref),
                             B * Nt * (2 * 13 * 13 * 6 * Nt + 2 * 13 * 13 + 13 + 13 * 6))
    res = {"kernel": "condense", "shape": f"B={B} Nt={Nt}", "bound_ms": b_ms, "bound_by": b_by,
           "old_max_abs_err": errs[0], "new_max_abs_err": errs[1], "tol": tol_condense,
           **in_turns(lambda: call_condense(old["condense"], A, Bm, d),
                      lambda: call_condense(new["condense"], A, Bm, d), 20, device)}
    return res


def admm_results(ctx, warm, out, old, new, device) -> list:
    from ft_mpc_torch.solvers.lanes_qp import admm_plain, admm_plan

    sp = ctx.sp
    results = []
    x_lb, x_ub = np.full(13, -1e8), np.full(13, 1e8)
    x_lb[3:6], x_ub[3:6] = -1.0, 1.0  # chip_smoke.py's box and rate rows
    boxed = sp.MPCWeights.from_diagonals(cs.Q_DIAG, cs.R_DIAG, x_lb=x_lb, x_ub=x_ub,
                                         du_max=np.full(6, 0.5), dtype=torch.float32,
                                         device=device)
    c = ctx.cfg.admm
    worst = torch.topk(out.info.r_prim, 256).indices
    cases = [(label, cs.admm_inputs(ctx, warm, weights, rows=rows), iters, reps)
             for label, weights, rows, iters, reps in (
                 ("main path T=64", ctx.weights, None, c.iters, 10),
                 ("cleanup K=256", ctx.weights, worst, ctx.cfg.cleanup_iters, 3),
                 ("box and rate rows T>64", boxed, None, c.iters, 3),
                 ("box and rate rows, cleanup K=256", boxed, worst, ctx.cfg.cleanup_iters, 3))]
    for Nt in cs.C2_HORIZONS:
        hctx = cs.Ctx(device, torch.float32, cs.C2_BATCH, horizon=Nt)
        _, hwarm, _ = cs.drive_main_path(hctx, 0, cs.C2_STEPS)
        cases.append((f"horizon {Nt}", cs.admm_inputs(hctx, hwarm, hctx.weights), c.iters, 5))
        del hctx, hwarm
    for label, args, iters, reps in cases:
        hyper = (c.sigma, c.alpha, iters, c.elastic_y_max)
        ref = admm_plain(*args, *hyper)
        rel = [cs.rel_err(call_admm(fn, args, *hyper), ref)[1]
               for fn in (old["admm"], new["admm"])]
        B, Nt, F = args[2].shape
        T = args[4].shape[1]
        b_ms, b_by = cs.bound_ms(cs.nbytes(*args, *ref), cs.admm_flops(B, Nt, F, T, iters))
        res = {"kernel": "admm", "shape": f"{label}: B={B} Nt={Nt} F={F} T={T} iters={iters}",
               "plan": admm_plan(Nt, F, T),
               "bound_ms": b_ms, "bound_by": b_by, "old_max_rel_err": rel[0],
               "new_max_rel_err": rel[1],
               **in_turns(lambda: call_admm(old["admm"], args, *hyper),
                          lambda: call_admm(new["admm"], args, *hyper), reps, device)}
        res["old_us_per_iter"] = 1e3 * res["old_ms"] / iters
        res["new_us_per_iter"] = 1e3 * res["new_ms"] / iters
        results.append(res)
        del args, ref
    return results


def alloc_results(ctx, out, old, new, device) -> list:
    from ft_mpc_torch.solvers.lanes_alloc import alloc_plain

    results = []
    full = cs.alloc_args(ctx, out.wrench)
    iters = sum(cs.ALLOC_HYPER[:2])
    for label, rows in (("condensed path", len(full[1])), ("first rows, stagewise batch", cs.SW_BATCH)):
        args = [full[0]] + [t[:rows].contiguous() for t in full[1:]]
        ref = alloc_plain(*args, *cs.ALLOC_HYPER)
        got = {side: call_alloc(fn, args) for side, fn in
               (("old", old["alloc"]), ("new", new["alloc"]))}
        B, F = args[5].shape
        b_ms, b_by = cs.bound_ms(cs.nbytes(*args, *ref), cs.alloc_flops(B, F, *cs.ALLOC_HYPER[:2]))
        res = {"kernel": "alloc", "shape": f"{label}'s own wrenches: B={B} F={F} iters={iters}",
               "rows": B, "bound_ms": b_ms, "bound_by": b_by,
               **{f"{side}_vs_plain": alloc_vs(g, ref) for side, g in got.items()},
               "new_vs_old": alloc_vs(got["new"], got["old"]),
               **in_turns(lambda: call_alloc(old["alloc"], args),
                          lambda: call_alloc(new["alloc"], args), 20, device)}
        res["old_us_per_iter"] = 1e3 * res["old_ms"] / iters
        res["new_us_per_iter"] = 1e3 * res["new_ms"] / iters
        for side, fns in (("old", old), ("new", new)):
            res[f"{side}_phases"] = alloc_phases(fns["alloc"], args, device)
        results.append(res)
    return results


if __name__ == "__main__":
    sys.exit(main())
