"""CPU tests of the port's benchmark harness (`perfbench/`).

    python3 -m pytest perfbench/tests -q -p no:cacheprovider

They check the harness's frozen copies against the program, its statistics
on planted samples, its work counts against hand counts, that a cell is
added by adding files, the shape of a run's result, that the comparison
deciding `correct` fails each fault the cells can have, and that neither the
harness nor the reference loads JAX or the JAX package (nor, for the
reference, anything of the port).  The tests marked `cuda` need the card and
skip here.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import plant, reference as ref, run as bench_run, system
from perfbench.metrics import (admm_roofline, alloc_roofline, condense_roofline, period_p90_ms,
                               riccati_roofline)

PB = Path(__file__).resolve().parent.parent
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ft_mpc_tpu"}
TINY_PATTERNS = [[], [0], [1], [0, 1]]


def tiny_cell(tmp: Path, config="condensed_h15", horizon=None, initial=None,
              patterns=TINY_PATTERNS) -> tuple:
    """A new cell made of files only: a traffic mix of 4 craft, a check file,
    and a BENCHMARK.json that lists the cell.  Its limits are the cell's, but
    for the gaps: over four rows a median is one row's gap, so they get
    5e-3, still far under what each fault reads (0.1 N and more)."""
    data = tmp / "data"
    for sub in ("configs", "traffic", "checks"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((PB / "configs" / f"{config}.json").read_text())
    if horizon is not None:
        cfg["mpc"]["horizon"] = horizon
    (data / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    traffic = {"name": "tiny4", "batch": 4, "patterns": patterns, "tiling": "in_order",
               "initial_state": initial or {"kind": "tumbling", "pos": 1.0, "vel": 0.3, "omega": 0.3},
               "noise": {"mode": "reference", "scales": [1e-3] * 4},
               "reference": {"kind": "hover", "position": [0.0, 0.0, 0.0],
                             "omega_des": [0.0, 0.0, 0.6]},
               "warmup_periods": 1, "traced_periods": 1, "check_periods": 1}
    (data / "traffic" / "tiny4.json").write_text(json.dumps(traffic))
    name = f"{config}.tiny4"
    limits = json.loads(next((PB / "checks").glob(f"{config}.*.json")).read_text())
    for k in limits:
        if "_gap_" in k:
            limits[k]["limit"] = 5e-3
    (data / "checks" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": "tiny4", "chips": 1,
                               "why": "four craft on the CPU"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(w.startswith(config) for w in m["workloads"]):
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return name, tmp / "BENCHMARK.json", data


def run_tiny(tmp, trace=False, **kw):
    name, bench, data = tiny_cell(tmp, **kw)
    return bench_run.run(name, 2**33 + 7, 1e9, trace, torch.device("cpu"), bench, data,
                         max_periods=2)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    return run_tiny(tmp_path_factory.mktemp("tiny"))


# ---------------------------------------------------------------------------
# frozen copies and statistics
# ---------------------------------------------------------------------------


def test_plant_matches_the_programs_robot_step_in_float64():
    from ft_mpc_torch.ops.dynamics import BodyParams, FaultState, robot_step

    torch.manual_seed(0)
    f64 = torch.float64
    params = BodyParams.default(0.1, dtype=f64, device="cpu")
    B = 64
    broken = (torch.rand(B, 16, dtype=f64) < 0.15).to(f64)
    x = torch.randn(B, 13, dtype=f64)
    x[:, 6:10] = x[:, 6:10] / x[:, 6:10].norm(dim=1, keepdim=True)
    u = 3.4 * torch.rand(B, 16, dtype=f64)
    want = robot_step(params, FaultState(broken=broken, intensity=broken), x, u)
    pl = {k: getattr(params, k) for k in ("mass", "inertia", "inertia_inv", "D", "dt")}
    got = plant.robot_step(pl, broken, broken * params.max_thrust, x, u)
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


def test_initial_states_come_from_the_seed():
    a = plant.tumbling_x0(16, 2**33 + 1, 1.0, 0.3, 0.3)
    assert np.array_equal(a, plant.tumbling_x0(16, 2**33 + 1, 1.0, 0.3, 0.3))
    assert not np.array_equal(a, plant.tumbling_x0(16, 2**33 + 2, 1.0, 0.3, 0.3))
    assert np.allclose(np.linalg.norm(a[:, 6:10], axis=1), 1.0, atol=1e-6)
    b = plant.at_rest_x0(16, 5, 1.0)
    assert np.all(b[:, 3:9] == 0) and np.all(b[:, 9] == 1) and np.all(b[:, 10:] == 0)


def test_step_ms_moves_with_a_stall_that_a_median_of_window_means_hides():
    lats = [0.3] * 100
    stalled = list(lats)
    stalled[37] += 2.7
    plain, hit = (bench_run.end_to_end(x, sum(x), 1.0) for x in (lats, stalled))
    assert hit["step_ms"] - plain["step_ms"] == pytest.approx(27.0)
    window_means = lambda x: np.median(np.asarray(x).reshape(10, 10).mean(axis=1))
    assert window_means(stalled) == window_means(lats)


def test_p90_is_the_90th_percentile_of_every_period():
    rng = np.random.default_rng(0)
    lats = list(rng.permutation(np.arange(1, 101) / 1000.0))
    assert period_p90_ms.read(SimpleNamespace(latencies_s=lats)) == pytest.approx(90.1)
    assert period_p90_ms.read(SimpleNamespace(latencies_s=[])) is None


def test_work_counts_by_hand():
    # ADMM at B=Nt=F=T=iters=1 (n = 6): rhs 12 + 12, K^-1 matvec 72, hull
    # and dense rows 12 + 12, projections and duals 24, relaxation 36
    assert admm_roofline.admm_flops(1, 1, 1, 1, 1) == 180
    # K^-1 36, hull 6 + 1, G 6, h 1, g 6, x 6, z and y 2 x 2, rho 1; out x 6, z and y 4
    assert admm_roofline.admm_bytes(1, 1, 1, 1) == 4 * 77
    # condensing one stage: A 169, B 78, d 13 in; S 13 x 6, phi 13 out
    assert condense_roofline.work(1, 1) == (4 * 351, 2 * 169 * 6 + 2 * 169 + 13 + 78)
    # allocation of one row, F = 1, no iterations: D 96 shared; per row in 6 + 6 + 16
    # + 6 + 1 + 96 + 6 + 2, out 16 + 6 + 3
    assert alloc_roofline.work(1, 1, 0, 0) == (4 * (96 + 164), 12 + 3456 + 1400 + 648)
    # a re-solve of one stage: factorization 387, q 13, r 6, qN and x0 26, X 26, U 6
    assert riccati_roofline.resolve_work(1, 1) == (4 * 464, 767 + 682)
    assert riccati_roofline.prepare_work(2, 3) == (4 * 6 * 387, 6 * (338 + 156))


# ---------------------------------------------------------------------------
# the reference against the program, in float64 where the program is
# ---------------------------------------------------------------------------


def test_reference_bank_matches_the_programs():
    cfg = json.loads((PB / "configs" / "condensed_h15.json").read_text())
    traffic = json.loads((PB / "traffic" / "fleet2048_closed.json").read_text())
    traffic["batch"] = len(traffic["patterns"])
    sut = system.build(cfg, traffic, torch.device("cpu"))
    consts = ref.plant_constants(cfg["plant"])
    bank = ref.build_bank(consts, traffic["patterns"], range(traffic["batch"]),
                          cfg["terminal"]["tuning"], ROOT / cfg["terminal"]["cache_dir"], 32, 64,
                          torch.device("cpu"), torch.float64)
    pairs = {"hull_A": "hull_A", "hull_b": "hull_b", "hull_mask": "hull_mask", "r": "r",
             "u_comp": "u_comp", "omega_des": "omega_des", "u_ub": "u_ub", "gen_G": "gen_G",
             "term_A": "term_A", "term_b": "term_b", "term_mask": "term_mask"}
    for mine, theirs in pairs.items():
        a, b = getattr(bank, mine), getattr(sut.bank, theirs).double()
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6), mine
    assert torch.allclose(bank.t_P, sut.bank.term.P.double(), rtol=1e-6, atol=1e-6)
    assert torch.allclose(bank.gen_L, sut.bank.gen_L.double(), rtol=1e-6)


def test_doubling_scan_resolve_matches_the_programs_riccati_sweeps():
    from ft_mpc_torch.solvers.riccati import lqr_factor, lqr_resolve

    g = torch.Generator().manual_seed(1)
    B, Nt, n, m = 3, 37, 13, 6
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    A = torch.eye(n, dtype=torch.float64) + 0.05 * r(B, Nt, n, n)
    Bm, c = 0.1 * r(B, Nt, n, m), 0.01 * r(B, Nt, n)
    spd = lambda k: (lambda M: M @ M.transpose(-1, -2) + torch.eye(k, dtype=torch.float64))(r(B, k, k))
    Q, R, QN = spd(n), spd(m), spd(n)
    q, rr, qN = r(B, Nt, n), r(B, Nt, m), r(B, n)
    X, U = lqr_resolve(lqr_factor(A, Bm, c, Q, R, QN), q, rr, qN, torch.zeros(B, n, dtype=torch.float64))
    Xr, Ur = ref.lqr_resolve(ref.lqr_factor(A, Bm, c, Q, R, QN), q, rr, qN)
    assert torch.allclose(Xr, X, atol=1e-9) and torch.allclose(Ur, U, atol=1e-9)


def test_reference_terminal_terms_match_the_programs():
    from ft_mpc_torch.terminal.poly import terminal_gradient, terminal_hessian_psd, terminal_value

    cfg = json.loads((PB / "configs" / "condensed_h15.json").read_text())
    traffic = json.loads((PB / "traffic" / "fleet2048_closed.json").read_text())
    pats = traffic["patterns"][:6]
    traffic.update(batch=len(pats), patterns=pats)
    sut = system.build(cfg, traffic, torch.device("cpu"))
    term = type(sut.bank.term)(*(t.double() if t.is_floating_point() else t for t in sut.bank.term))
    bank = ref.build_bank(ref.plant_constants(cfg["plant"]), pats, range(len(pats)),
                          cfg["terminal"]["tuning"], ROOT / cfg["terminal"]["cache_dir"], 32, 64,
                          torch.device("cpu"), torch.float64)
    e = 0.3 * torch.randn(len(pats), 9, generator=torch.Generator().manual_seed(2),
                          dtype=torch.float64)
    vm = torch.func.vmap
    assert torch.allclose(ref.terminal_value(bank, e), vm(terminal_value)(term, e), rtol=1e-5)
    assert torch.allclose(ref.terminal_grad(bank, e), vm(terminal_gradient)(term, e), rtol=1e-5,
                          atol=1e-8)
    assert torch.allclose(ref.terminal_hessian_psd(bank, e), vm(terminal_hessian_psd)(term, e),
                          rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# a run, end to end, on the CPU (the kernels' plain versions)
# ---------------------------------------------------------------------------


def test_a_traffic_file_makes_a_new_cell(tiny_run):
    result, lines, info = tiny_run
    assert set(result["metrics"]) == {"step_ms", "setup_s"}
    assert result["correct"], lines
    assert info["periods"] == result["attempted"] == 2


def test_the_result_line_has_its_shape(tiny_run):
    result, lines, _ = tiny_run
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    units = {m["name"]: m["unit"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["end_to_end"]}
    assert all(v["unit"] == units[k] and v["value"] > 0 for k, v in result["metrics"].items())
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())
    assert [ln.split(":")[0] for ln in lines] == [f"check {k}" for k in result["check"]]
    json.dumps(result)


def test_a_traced_run_reports_the_per_layer_metrics(tmp_path):
    result, _, _ = run_tiny(tmp_path, trace=True)
    assert {"period_p90_ms", "linearize_ms", "cleanup_ms",
            "kinv_rescues_per_step"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())


def test_the_stagewise_backend_runs_and_agrees(tmp_path):
    result, lines, _ = run_tiny(tmp_path, config="stagewise_h240", **CELLS["stagewise_h240"])
    assert result["correct"], lines


def _half(t):
    n = t.shape[0] // 2
    return torch.cat([t[:n], t[:n].mean(0, keepdim=True).expand(t.shape[0] - n, *t.shape[1:])])


def _unchanged(params, bank, weights, cfg, c0, x_ref, u_ref, warm):
    """An SQP that hands back the state it was given."""
    from ft_mpc_torch.controllers.spiraling import SQPInfo

    zero = torch.zeros(c0.shape[0], dtype=c0.dtype, device=c0.device)
    return warm, SQPInfo(*(zero,) * 6)


def _at_warm_start(out, warm, rows):
    """The rows' answers left at the warm start the step was given: its
    iterate, and no thrust (within every guarantee)."""
    u, U = out.u_phys.clone(), out.warm.U.clone()
    u[rows], U[rows] = 0.0, warm.U[rows]
    return out._replace(u_phys=u, warm=out.warm._replace(U=U))


# each breaks the timed path underneath the harness: (where, how)
FAULTS = {
    # the step returns its state unchanged (the commands come from it)
    "state_unchanged": ("solver", _unchanged),
    # half of the bank left out, its answers the mean of the rest
    "half_the_bank": ("output", lambda out, warm, P: out._replace(
        u_phys=_half(out.u_phys), warm=out.warm._replace(U=_half(out.warm.U)))),
    # half of the bank left at its warm start
    "half_at_warm_start": ("output", lambda out, warm, P: _at_warm_start(
        out, warm, torch.arange(out.u_phys.shape[0]) < out.u_phys.shape[0] // 2)),
    # one fault pattern's rows left at their warm start (a minority of the bank)
    "one_pattern_at_warm_start": ("output", lambda out, warm, P: _at_warm_start(
        out, warm, torch.arange(out.u_phys.shape[0]) % P == 1)),
    # the commands altered where they are produced (still within bounds)
    "answer_altered": ("output", lambda out, warm, P: out._replace(u_phys=0.9 * out.u_phys)),
    # the worst-K cleanup not run: only the rows it re-solves go wrong
    "cleanup_skipped": ("config", lambda cfg: cfg._replace(cleanup_rounds=0)),
}
CELLS = {"condensed_h15": {}, "stagewise_h240": {
    "horizon": 20, "initial": {"kind": "at_rest", "pos": 1.0}, "patterns": [[], [10, 11]]}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config", sorted(CELLS))
def test_each_fault_comes_out_not_correct(tmp_path, monkeypatch, config, fault):
    from ft_mpc_torch.controllers import spiraling

    where, how = FAULTS[fault]
    if where == "solver":
        monkeypatch.setattr(spiraling, "sqp_solve_batch", how)
        monkeypatch.setattr(spiraling, "sqp_solve_batch_stagewise", how)
    elif where == "config":
        real_cfg = system.mpc_config
        monkeypatch.setattr(system, "mpc_config", lambda *a: how(real_cfg(*a)))
    else:
        real = system.step
        P = len(CELLS[config].get("patterns", TINY_PATTERNS))
        monkeypatch.setattr(system, "step", lambda *a: how(real(*a), a[-1], P))
    result, lines, _ = run_tiny(tmp_path, config=config, **CELLS[config])
    assert not result["correct"], lines
    if where != "solver" and fault != "half_the_bank":
        # within the guarantees: the comparison with the reference catches it
        caught = [k for k, v in result["check"].items() if v["value"] > v["limit"]]
        assert caught and all("_gap_" in k for k in caught), lines


def test_the_control_rounds_each_products_operands_to_tf32():
    from perfbench.control import TF32Products, to_tf32

    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-20, 1.0 + 2.0**-12, -3.0e-7],
                     dtype=torch.float32)
    got = to_tf32(x)
    # 11 significant bits, to nearest
    assert got.tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, to_tf32(x[3:]).item()]
    m, e = torch.frexp(got)
    assert torch.all((m * 2**11).frac() == 0)
    assert torch.equal(to_tf32(x.double()), x.double())
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    with TF32Products():
        prod, ein, elem = a @ b, torch.einsum("bij,bjk->bik", a, b), a * 1.0
        jac = torch.func.vmap(torch.func.jacfwd(lambda v: a[0] @ v))(b[:, :, 0])
    assert torch.allclose(prod, to_tf32(a) @ to_tf32(b), rtol=1e-6, atol=1e-6)
    assert torch.allclose(ein, prod, rtol=1e-6, atol=1e-6) and not torch.equal(prod, a @ b)
    assert torch.equal(elem, a)
    assert torch.allclose(jac, to_tf32(a[0]).expand(3, 5, 7), rtol=1e-6)


# ---------------------------------------------------------------------------
# what the harness and the reference load
# ---------------------------------------------------------------------------


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "plant.py", "check.py", "peaks.py"):
        assert "ft_mpc_torch" not in _imports(PB / name), name
    code = ("import sys, perfbench.check, perfbench.reference, perfbench.plant; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ft_mpc_torch', 'jax', 'jaxlib', 'flax', 'ft_mpc_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, torch; from pathlib import Path; sys.path.insert(0, %r); "
            "import test_perfbench_harness as t; t.run_tiny(Path(%r)); "
            "from perfbench.run import forbidden_modules; print(forbidden_modules())"
            % (str(Path(__file__).parent), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_tf32_control_fails_where_the_program_passes(card, tmp_path, config):
    """The control at a size a test run holds: each cell's patterns, eight
    craft a pattern and at least 64 (the stagewise one at its horizon of
    240); the program passes the cell's limits, the reference in float32
    with every product in TF32 fails one."""
    from perfbench import cell as cells, control

    name, bench, data = tiny_cell(tmp_path, config=config,
                                  initial=CELLS[config].get("initial"))
    limits = next((PB / "checks").glob(f"{config}.*.json")).read_text()
    (data / "checks" / f"{name}.json").write_text(limits)
    cell_traffic = "fleet2048_closed" if config == "condensed_h15" else "fleet512_closed"
    traffic = json.loads((data / "traffic" / "tiny4.json").read_text())
    patterns = json.loads((PB / "traffic" / f"{cell_traffic}.json").read_text())["patterns"]
    traffic.update(batch=max(64, 8 * len(patterns)), check_periods=2, patterns=patterns)
    (data / "traffic" / "tiny4.json").write_text(json.dumps(traffic))
    result, lines, info = bench_run.run(name, 2**33 + 11, 5.0, False, card, bench, data, keep=True)
    assert result["correct"], lines
    c = cells.load(name, bench, data)
    got = control.precision_readings(info["kept"], c.config, c.traffic, card)["tf32"]
    assert any(got[k] > v["limit"] for k, v in c.limits.items() if k in got), got
