"""The readings that the comparison's limits are set from, on the chip.

    python3 -m perfbench.control --workload <cell> --seeds 1 2 3 ... --seconds <s> [--out F]

For each seed, in one process: a run of the cell (`run.run`) with a short
window at the cell's own load, whose comparison numbers are the program's
readings; then, on the same sampled periods and inputs, the reference
itself put in the program's place in float32 with every product in TF32
(the control: the precision below the configuration's float32 with TF32
off) and, as a witness, in float32, each judged against the float64
reference by the same numbers.  One JSON line a seed.  Not part of a
benchmark run.

TF32 is emulated, not left to cuBLAS: cuBLAS takes its tensor cores only
for some products, and none of the stagewise reference's batched 13x13 and
13x6 ones, so a TF32 switch would leave that QP in float32.  Instead every
float32 operand of a product (`@`, `matmul`, `mm`, `bmm`, `mv`, `einsum`,
...) is rounded to TF32's 11 significant bits, as a tensor core reads it,
and the product accumulates in float32.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
            torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, torch.mv, torch.Tensor.mv,
            torch.einsum, torch.tensordot, torch.addmm, torch.baddbmm, torch.linalg.matmul}


def to_tf32(t):
    """A float32 tensor rounded to nearest at 11 significant bits (TF32's
    10 stored and 1 implicit), by Veltkamp's split: arithmetic only, so it
    holds under `torch.func` transforms and keeps forward-mode tangents."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    c = t * 8193.0  # 2**13 + 1: 24 - 13 = 11 bits stay
    return c - (c - t)


class TF32Products(TorchFunctionMode):
    """Every product's float32 operands in TF32 while the mode is on."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            args, kwargs = tree_map(to_tf32, args), tree_map(to_tf32, kwargs)
        return func(*args, **kwargs)


def precision_readings(kept, config, traffic, device) -> dict:
    """The comparison numbers of the reference in float32, with every
    product in TF32 and without, against the float64 reference, on the
    sampled periods."""
    from perfbench import check, plant
    from perfbench.run import REF_ROWS, ROOT

    Nt = config["mpc"]["horizon"]
    xr, ur = plant.hover_refs(REF_ROWS + Nt + 1, traffic["reference"]["position"],
                              traffic["reference"]["omega_des"])
    r64 = check.Reference(config, traffic, ROOT, device)
    r32 = check.Reference(config, traffic, ROOT, device, dtype=torch.float32)
    out = {"tf32": {}, "fp32": {}}
    for s in kept:
        win = slice(s.start, s.start + Nt + 1)
        as_t = lambda a, dt: torch.as_tensor(a[win], dtype=dt, device=device)
        base = r64.step(s, as_t(xr, torch.float64), as_t(ur, torch.float64))
        for name in ("tf32", "fp32"):
            step = lambda: r32.step(s, as_t(xr, torch.float32), as_t(ur, torch.float32))
            if name == "tf32":
                with TF32Products():
                    r = step()
            else:
                r = step()
            for k, v in check.judge(r.u_phys, r.warm.U, base, r64.rows).items():
                out[name][k] = max(out[name].get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    from perfbench import run

    run.environment()
    torch.set_num_threads(1)
    from perfbench import cell as cells

    device = torch.device("cuda:0")
    c = cells.load(args.workload)
    lines = []
    for seed in args.seeds:
        result, _, info = run.run(args.workload, seed, args.seconds, False, device, keep=True)
        kept = info.pop("kept")
        line = {"seed": seed, "program": info.pop("compared"),
                **precision_readings(kept, c.config, c.traffic, device),
                "info": info, "metrics": result["metrics"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
