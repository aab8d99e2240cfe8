"""Run one cell of the port's benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up builds the cell's bank through the
program, draws the craft's initial states, the plant's noise and the
reference from the seed, makes the first warm start and flies a few
warm-up periods.  Then the window: control periods in closed loop for
`--seconds` seconds, each

  1. `get_control_batch` on the craft's current states,
  2. the thruster commands copied to the host (a period's latency ends here),
  3. every craft advanced by the harness's own plant (RK4 with its row's
     fault, the reference's additive noise),
  4. the warm start shifted by the program's `shift_warmstart`,
  5. the reference windows slid one step.

With `--trace 0` the result carries the cell's end-to-end metrics; with
`--trace 1` a fixed number of further periods run under the profiler and
the result carries the per-layer metrics.  Either way a sample of the
window's periods is then judged against the plain reference
(`perfbench/check.py`), every compared number is printed beside its limit
(last lines of standard error, and last in the result), and the result is
the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ft_mpc_tpu")
PERIOD_S = 0.1  # the controller's control period
REF_ROWS = 4096  # reference windows cover this many periods, then hold their last rows


def environment() -> None:
    """Before torch is imported: build and kernel caches at fixed paths inside
    the checkout (the program's own CUDA build goes to `build/` beside them),
    and one thread for the host's numerical libraries: the step is host-bound,
    and idle pool threads spinning beside it on a shared host spread the runs."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def card_line() -> str | None:
    """`nvidia-smi`'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Loop:
    """The closed loop: the program's control step, the harness's plant."""

    def __init__(self, sut, c, x0, seed, device):
        import torch

        from perfbench import cell as cells, plant, reference as ref, system

        self.sut, self.system, self.plant = sut, system, plant
        cfg, tr = c.config, c.traffic
        self.Nt = cfg["mpc"]["horizon"]
        consts = ref.plant_constants(cfg["plant"])
        f32 = torch.float32
        self.pl = {k: torch.as_tensor(consts[k], dtype=f32, device=device)
                   for k in ("mass", "inertia", "inertia_inv", "D", "dt")}
        rows = cells.bank_rows(tr)
        broken = torch.zeros(len(tr["patterns"]), 16, dtype=f32)
        for i, p in enumerate(tr["patterns"]):
            broken[i, list(p)] = 1.0
        self.broken = broken[rows].to(device)
        self.max_thrust = consts["max_thrust"]  # the deployment's float32 value
        self.fault_force = self.broken * float(self.max_thrust)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.scales = tr["noise"]["scales"]
        if tr["noise"]["mode"] != "reference":
            raise ValueError(f"unknown noise mode {tr['noise']['mode']!r}")
        rf = tr["reference"]
        if rf["kind"] != "hover":
            raise ValueError(f"unknown reference {rf['kind']!r}")
        xr, ur = plant.hover_refs(REF_ROWS + self.Nt + 1, rf["position"], rf["omega_des"])
        self.x_ref = torch.as_tensor(xr, dtype=f32, device=device)
        self.u_ref = torch.as_tensor(ur, dtype=f32, device=device)
        self.x = torch.as_tensor(x0, device=device)
        self.i = 0
        self.warm = system.init_warm(sut, self.x, self.x_ref[: self.Nt + 1],
                                     self.u_ref[: self.Nt + 1])
        self.prev = None

    def start(self) -> int:
        return min(self.i, REF_ROWS)

    def period(self):
        """One control period: (latency s, the program's output, the commands
        on the host, the inputs it took)."""
        s = self.start()
        win = slice(s, s + self.Nt + 1)
        t0 = time.perf_counter()
        out = self.system.step(self.sut, self.x, self.x_ref[win], self.u_ref[win], self.warm)
        u_host = out.u_phys.cpu()
        lat = time.perf_counter() - t0
        taken = SimpleNamespace(p=self.i, x=self.x, start=s, warm_in=self.warm, prev=self.prev)
        x_new = self.plant.advance(self.pl, self.broken, self.fault_force, self.x, out.u_phys,
                                   self.gen, self.scales)
        self.prev = out.warm
        self.warm = self.system.shift(self.sut, out.warm, x_new)
        self.x, self.i = x_new, self.i + 1
        return lat, out, u_host, taken


def end_to_end(lats, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: `step_ms`, the whole window over
    the periods completed in it (plant and shift included); `setup_s`."""
    return {"step_ms": 1e3 * window_s / len(lats), "setup_s": setup_s}


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        bench_path: Path | None = None, data: Path | None = None,
        max_periods: int | None = None, keep: bool = False) -> tuple[dict, list[str], dict]:
    """One run of the cell: (the result, the lines that name each compared
    number beside its limit, other readings for the earlier output lines)."""
    import numpy as np
    import torch

    from perfbench import cell as cells, check, plant, system, trace as tracing

    c = cells.load(workload, bench_path, data)
    tr, cfg = c.traffic, c.config
    B = tr["batch"]
    sut = system.build(cfg, tr, device)
    x0 = plant.initial_states(tr["initial_state"], B, seed)
    loop = Loop(sut, c, x0, seed, device)
    sample = check.Sample(seed, 1 + tr["check_periods"])
    kept = [None] * (1 + tr["check_periods"])
    guard = check.Guarantees(loop.broken.cpu().numpy(), float(loop.max_thrust))

    def fly(timed: bool):
        lat, out, u_host, t = loop.period()
        slot = sample.wants(t.p) if (timed or t.p == 0) else None
        if slot is not None:
            kept[slot] = check.snapshot(t.p, t.x, t.start, t.warm_in, t.prev, out)
        if timed:
            guard.see(u_host.numpy())
        return lat

    for _ in range(tr["warmup_periods"]):
        fly(False)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    # what set-up left behind is kept out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    rescues0 = system.rescues()
    lats = []
    t0 = time.perf_counter()
    while True:  # at least one period; the last one may end past `seconds`
        lats.append(fly(True))
        if time.perf_counter() - t0 >= seconds or len(lats) == max_periods:
            break
    sync()
    window_s = time.perf_counter() - t0
    rescues = system.rescues() - rescues0

    traced = None
    if trace:
        events = tracing.record(lambda: [loop.period() for _ in range(tr["traced_periods"])],
                                sync)
        traced = tracing.analyse(events)
        traced_events = len(events)
        del events
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del loop, sut
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = check.Reference(cfg, tr, ROOT, device)
    xr, ur = plant.hover_refs(REF_ROWS + cfg["mpc"]["horizon"] + 1, tr["reference"]["position"],
                              tr["reference"]["omega_des"])
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    numbers = {**guard.numbers(),
               **check.compare([k for k in kept if k is not None], reference, as_t(xr), as_t(ur),
                               cfg["mpc"]["horizon"])}
    ref_s = time.perf_counter() - t_ref

    verdict = {k: {"value": numbers[k], "limit": c.limits[k]["limit"]} for k in c.limits}
    correct = all(v["value"] <= v["limit"] for v in verdict.values())
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in verdict.items()]

    periods = len(lats)
    lat_ms = 1e3 * np.asarray(lats)
    e2e = end_to_end(lats, window_s, setup_s)
    result = {"correct": bool(correct), "attempted": periods, "failed": guard.failed}
    if trace:
        run_ns = SimpleNamespace(trace=traced, periods=tr["traced_periods"], window_periods=periods,
                                 latencies_s=lats, window_s=window_s, rescues=rescues, config=cfg,
                                 traffic=tr, B=B, K=cells.cleanup_k(cfg, B))
        metrics = {}
        for m in c.per_layer:
            v = importlib.import_module(f"perfbench.metrics.{m['name']}").read(run_ns)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(c.entry["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = 1e-6 * traced.busy_us
        dev["window_s"] = 1e-6 * traced.window_us
    result["device"] = dev
    if trace:
        result["breakdown"] = tracing.breakdown(traced)
    info = {"periods": periods, "window_s": window_s, "solves_per_s": B * periods / window_s,
            "period_p50_ms": float(np.median(lat_ms)), "period_max_ms": float(lat_ms.max()),
            "periods_over_control_period": int((lat_ms > 1e3 * PERIOD_S).sum()),
            "kinv_rescues": rescues, "memory_peak_bytes": int(peak), "reference_s": ref_s,
            "setup_s": setup_s, "trace_events": traced_events if trace else None}
    if keep:
        info["kept"] = [k for k in kept if k is not None]
        info["compared"] = numbers
    result["check"] = verdict
    return result, lines, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch

    torch.set_num_threads(1)
    from perfbench import cell as cells

    chips = int(cells.load(args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} card(s)",
              file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    result, lines, info = run(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    card = card_line()
    result["card"] = {"nvidia_smi": card,
                      "power_limit": None if card is None else card.rsplit(",", 1)[-1].strip()}
    result["check"] = result.pop("check")
    print(json.dumps({"info": {**info, "card": card}}))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
