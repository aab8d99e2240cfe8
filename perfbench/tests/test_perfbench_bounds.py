"""CPU tests of a configuration's bounds in the harness: the state box
(`x_lb`, `x_ub`) and the wrench-rate bound (`du_max`) in `weights`.

    python3 -m pytest perfbench/tests -q -p no:cacheprovider

The program flies them (`system.build`), the reference builds the same rows
(`reference.ext_rows`, the line search's violations, the duals' size) and
the ADMM roofline counts them; a configuration that states none takes
exactly the path it took before they existed.  Also the near-orbit initial
states, a frozen copy of the sanitizer's draw.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import cell as cells, check, peaks, plant, reference as ref, run as bench_run, system
from perfbench.metrics import admm_roofline

PB = Path(__file__).resolve().parent.parent
ROOT = PB.parent
F64 = torch.float64
BIG = 1e8
VEL = [3, 4, 5]  # the centre's velocity in the 13-state


def _harness():
    """The harness's own test module, for its tiny cells."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_harness_tests", PB / "tests" / "test_perfbench_harness.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _harness()


def _box(vel, lower=True, upper=True):
    """A velocity box of +/- vel, the other states unbounded (at BIG)."""
    ub = [BIG] * 13
    for i in VEL:
        ub[i] = vel
    out = {}
    if upper:
        out["x_ub"] = ub
    if lower:
        out["x_lb"] = [-v for v in ub]
    return out


# the bounds of a test: a two-sided box, each side alone, the rate alone, both
BOUNDS = {
    "box": _box(0.1),
    "upper_only": _box(0.1, lower=False),
    "lower_only": _box(0.1, upper=False),
    "du_max": {"du_max": [0.5] * 6},
    "box_and_du_max": {**_box(0.1), "du_max": [0.5] * 6},
}
# the tiny boxed cell: binds on the tiny cell's tumbling starts (up to 0.3 m/s)
TINY_BOUNDS = BOUNDS["box_and_du_max"]


def _config(name="condensed_h15", **bounds):
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    cfg["weights"].update(bounds)
    return cfg


def _program_weights(bounds, dtype=F64):
    from ft_mpc_torch.controllers.spiraling import MPCWeights

    cfg = _config(**bounds)
    return MPCWeights.from_diagonals(cfg["weights"]["Q"], cfg["weights"]["R"],
                                     **cells.weight_bounds(cfg), dtype=dtype, device="cpu")


def _reference_weights(bounds):
    t = lambda v: None if v is None else torch.as_tensor(v, dtype=F64)
    cfg = _config(**bounds)
    return SimpleNamespace(Q=torch.diag(t(cfg["weights"]["Q"])),
                           R=torch.diag(t(cfg["weights"]["R"])),
                           **{k: t(v) for k, v in cells.weight_bounds(cfg).items()})


def _f64(tree):
    """Every floating tensor of a (nested) named tuple in float64."""
    if isinstance(tree, tuple):
        return type(tree)(*(_f64(t) for t in tree))
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(F64)
    return tree


def _boxed_tiny_cell(tmp: Path):
    name, bench, data = H.tiny_cell(tmp)
    path = data / "configs" / "condensed_h15.json"
    cfg = json.loads(path.read_text())
    cfg["weights"].update(TINY_BOUNDS)
    path.write_text(json.dumps(cfg))
    return name, bench, data


def _run(name, bench, data, **kw):
    return bench_run.run(name, 2**33 + 7, 1e9, False, torch.device("cpu"), bench, data,
                         max_periods=2, **kw)


# ---------------------------------------------------------------------------
# the rows, against the program's, in float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
def test_ext_rows_are_the_programs(bounds):
    from ft_mpc_torch.controllers.spiraling import _ext_rows, n_extra_rows

    g = torch.Generator().manual_seed(3)
    B, Nt = 3, 15
    r = lambda *s: torch.randn(*s, generator=g, dtype=F64)
    X, S = 0.3 * r(B, Nt + 1, 13), r(B, Nt, 13, 6 * Nt)
    phi, offset = 0.1 * r(B, Nt, 13), r(B, Nt, 6)
    W, mine = _program_weights(BOUNDS[bounds]), _reference_weights(BOUNDS[bounds])
    E = n_extra_rows(W, Nt)
    assert ref.n_extra(mine, Nt) == cells.extra_rows(_config(**BOUNDS[bounds])) == E > 0
    G, h = ref.ext_rows(mine, X, S, phi, offset)
    G_p, h_p = _ext_rows(W, X, S, phi, offset)
    assert G.shape == (B, E, 6 * Nt) and h.shape == (B, E)
    assert torch.equal(G, G_p) and torch.equal(h, h_p)


def test_the_assembled_qp_and_the_line_search_are_the_programs():
    """The whole dense block (terminal rows, then the bounds' rows, relaxed)
    and the merit's violations, on a bank the program built, in float64."""
    from ft_mpc_torch.controllers import spiraling

    cfg = _config(**TINY_BOUNDS)
    traffic = {"batch": 4, "patterns": H.TINY_PATTERNS, "tiling": "in_order"}
    sut = system.build(cfg, traffic, torch.device("cpu"))
    params, bank = system.plant(cfg, "cpu", dtype=F64), _f64(sut.bank)
    W = spiraling.MPCWeights(*(None if t is None else t.to(F64) for t in sut.weights))
    reference = check.Reference(cfg, traffic, ROOT, torch.device("cpu"))
    rbank, pl, rW, rcfg = reference.bank, reference.pl, reference.W, reference.cfg
    mcfg = system.mpc_config(cfg, 4)
    Nt = mcfg.horizon
    x0 = torch.as_tensor(plant.tumbling_x0(4, 11, 1.0, 0.3, 0.3), dtype=F64)
    x_ref = torch.as_tensor(plant.hover_refs(Nt + 1, [0, 0, 0], [0, 0, 0.6])[0], dtype=F64)
    u_ref = torch.zeros(Nt + 1, 6, dtype=F64)
    warm = ref.init_warm(pl, rbank, rW, rcfg, ref.robot_to_center(rbank.r, x0), x_ref, u_ref)
    assert warm.y_term.shape == (4, reference.dense_rows) == (4, 64 + 364 + 168)
    g = torch.Generator().manual_seed(4)
    X, U = warm.X, 0.5 * torch.randn(4, Nt, 6, generator=g, dtype=F64)
    geo = spiraling._masked_geometry(bank)
    xr_p = spiraling._per_scenario_ref(bank, x_ref, 4)
    qp_p, _, _, _ = spiraling._assemble_condensed(params, bank, W, mcfg, X, U, xr_p, u_ref, *geo)
    qp, S, phi, _ = ref.assemble_condensed(pl, rbank, rW, rcfg, X, U, ref.per_row_ref(rbank, x_ref),
                                           u_ref, ref.geometry(rbank))
    assert qp.G_term.shape == qp_p.G_term.shape == (4, 596, 90)
    assert torch.allclose(qp.G_term, qp_p.G_term, rtol=1e-5, atol=1e-6)
    assert torch.allclose(qp.h_term, qp_p.h_term, rtol=1e-5, atol=1e-6)
    # steps that cross the box and the rate bound: each candidate's merit
    # carries their violations on both sides alike, and without either
    # bound some rows would take another step
    without = {"box": dict(x_lb=None, x_ub=None), "du_max": dict(du_max=None)}
    moved = dict.fromkeys(without, False)
    for scale in (0.5, 0.1, 0.2, 0.3):
        dU = scale * torch.randn(4, Nt, 6, generator=g, dtype=F64)
        dX = torch.einsum("btin,bn->bti", S, dU.reshape(4, -1)) + phi
        a_p = spiraling._merit_alpha(params, bank, W, mcfg, X, U, dX, dU, xr_p, u_ref, *geo)
        alpha = lambda w: ref.merit_alpha(pl, rbank, w, rcfg, X, U, dX, dU,
                                          ref.per_row_ref(rbank, x_ref), u_ref, ref.geometry(rbank))
        a = alpha(rW)
        assert torch.equal(a, a_p), scale
        for k, gone in without.items():
            moved[k] |= not torch.equal(a, alpha(SimpleNamespace(**{**vars(rW), **gone})))
    assert all(moved.values()), moved


# ---------------------------------------------------------------------------
# a boxed cell, and what a dropped bound reads
# ---------------------------------------------------------------------------


def test_a_boxed_tiny_cell_is_correct(tmp_path):
    result, lines, _ = _run(*_boxed_tiny_cell(tmp_path))
    assert result["correct"], lines


@pytest.mark.parametrize("dropped", ["box", "du_max"])
def test_a_bound_the_program_drops_is_not_correct(tmp_path, monkeypatch, dropped):
    real = system.build
    gone = {"box": dict(x_lb=None, x_ub=None), "du_max": dict(du_max=None)}[dropped]

    def build(*a):
        sut = real(*a)
        sut.weights = sut.weights._replace(**gone)
        return sut

    monkeypatch.setattr(system, "build", build)
    name, bench, data = _boxed_tiny_cell(tmp_path)
    result, lines, info = _run(name, bench, data, keep=True)
    assert not result["correct"], lines
    caught = [k for k, v in result["check"].items() if v["value"] > v["limit"]]
    assert caught and all("_gap_" in k for k in caught), lines
    # the first period starts from the reference's own warm start: its gaps
    # alone, finite, read the dropped bound
    c = cells.load(name, bench, data)
    reference = check.Reference(c.config, c.traffic, ROOT, torch.device("cpu"))
    xr, ur = plant.hover_refs(bench_run.REF_ROWS + 16, [0, 0, 0], [0, 0, 0.6])
    first = check.compare(info["kept"][:1], reference, torch.as_tensor(xr, dtype=F64),
                          torch.as_tensor(ur, dtype=F64), 15)
    assert any(np.isfinite(first[k]) and first[k] > c.limits[k]["limit"] for k in check.GAPS), first


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", [{"xub": [0.5] * 13}, {"x_ub": [0.5] * 9},
                                     {"du_max": [1.0] * 5}, {"x_box": [0.5] * 13}])
def test_an_unknown_or_misshapen_bound_is_refused(weights):
    cfg = _config(**weights)
    (key,) = weights
    traffic = {"batch": 1, "patterns": [[]], "tiling": "in_order"}
    with pytest.raises(ValueError, match=key):
        system.build(cfg, traffic, torch.device("cpu"))
    with pytest.raises(ValueError, match=key):
        check.Reference(cfg, traffic, ROOT, torch.device("cpu"))
    with pytest.raises(ValueError, match=key):
        cells.extra_rows(cfg)


@pytest.mark.parametrize("key", ["x_lb", "x_ub", "du_max"])
def test_the_stagewise_reference_refuses_a_bound(key):
    bound = BOUNDS["box_and_du_max"][key]
    cfg = _config("stagewise_h240", **{key: bound})
    traffic = {"batch": 2, "patterns": [[], [10, 11]], "tiling": "in_order"}
    with pytest.raises(ValueError, match=key):
        check.Reference(cfg, traffic, ROOT, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the ADMM roofline's work
# ---------------------------------------------------------------------------


def test_admm_work_counts_the_bounds_rows_by_hand():
    # Nt=15, F=32 and T = 64 + 2*13*14 + 2*6*14 = 596 (n = 90): a row-iteration
    # rhs 5760 + 107280, K^-1 16200, hull and dense rows of x~ 5760 + 107280,
    # projections and duals 12 * 1076, relaxation 540
    assert admm_roofline.admm_flops(1, 15, 32, 596, 1) == 255732
    # K^-1 8100, hull 192 + 480, G 53640, h 596, g 90, x 90, z and y 2152, rho 1;
    # out x 90, z and y 2152
    assert admm_roofline.admm_bytes(1, 15, 32, 596) == 4 * 67583
    cfg = _config(**_box(0.5, lower=False), du_max=[2, 2, 2, 1, 1, 1])
    assert cells.extra_rows(cfg) == 532
    run = SimpleNamespace(config=cfg, B=2048, K=256)
    main = peaks.bound_s(4 * 2048 * 67583, 2048 * 60 * 255732)
    cleanup = peaks.bound_s(4 * 256 * 67583, 256 * 600 * 255732)
    assert admm_roofline.work_s(run) == pytest.approx(2 * main + 3 * cleanup, rel=1e-12)
    assert admm_roofline.work_s(run) > 4 * admm_roofline.work_s(SimpleNamespace(
        config=_config(), B=2048, K=256))


@pytest.mark.parametrize("name", ["condensed_h15", "stagewise_h240"])
def test_admm_work_is_unchanged_on_the_committed_configurations(name):
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    m, pad = cfg["mpc"], cfg["padding"]
    B = 2048 if name.startswith("condensed") else 512
    K = cells.cleanup_k(cfg, B)
    assert cells.extra_rows(cfg) == 0 and pad["terminal_rows"] == 64
    Nt, F = m["horizon"], pad["hull_facets"]
    calls = [(B, m["admm"]["iters"])] * (m["sqp_iters"] * m["admm"]["phases"]) \
        + [(K, m["cleanup_iters"])] * (m["cleanup_phases"] * m["cleanup_rounds"])
    before = sum(peaks.bound_s(admm_roofline.admm_bytes(b, Nt, F, 64),
                               admm_roofline.admm_flops(b, Nt, F, 64, it)) for b, it in calls)
    assert admm_roofline.work_s(SimpleNamespace(config=cfg, B=B, K=K)) == before


# ---------------------------------------------------------------------------
# no bound: exactly the path without them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["condensed_h15", "stagewise_h240"])
def test_without_bounds_nothing_is_added(name, monkeypatch):
    def refuse(*a):
        raise AssertionError("ext_rows called without a bound")

    monkeypatch.setattr(ref, "ext_rows", refuse)
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    assert set(cfg["weights"]) == {"Q", "R"}
    patterns = H.TINY_PATTERNS if name.startswith("condensed") else [[], [10, 11]]
    traffic = {"batch": 4, "patterns": patterns, "tiling": "in_order"}
    sut = system.build(cfg, traffic, torch.device("cpu"))
    assert sut.weights.x_lb is None and sut.weights.x_ub is None and sut.weights.du_max is None
    reference = check.Reference(cfg, traffic, ROOT, torch.device("cpu"))
    assert reference.dense_rows == 64
    assert (reference.W.x_lb, reference.W.x_ub, reference.W.du_max) == (None, None, None)
    Nt = reference.cfg.horizon
    x0 = torch.as_tensor(plant.tumbling_x0(4, 12, 1.0, 0.3, 0.3), dtype=F64)
    x_ref = torch.as_tensor(plant.hover_refs(Nt + 1, [0, 0, 0], [0, 0, 0.6])[0], dtype=F64)
    u_ref = torch.zeros(Nt + 1, 6, dtype=F64)
    rb = reference.bank
    warm = ref.init_warm(reference.pl, rb, reference.W, reference.cfg,
                         ref.robot_to_center(rb.r, x0), x_ref, u_ref)
    assert warm.y_term.shape == (4, 64)
    if name.startswith("condensed"):
        qp, _, _, _ = ref.assemble_condensed(reference.pl, rb, reference.W, reference.cfg, warm.X,
                                             warm.U, ref.per_row_ref(rb, x_ref), u_ref,
                                             ref.geometry(rb))
        assert qp.G_term.shape == (4, 64, 6 * Nt) and qp.h_term.shape == (4, 64)
        step = ref.control_step(reference.pl, rb, reference.W, reference.cfg, x0, x_ref, u_ref,
                                warm)
        assert step.warm.y_term.shape == (4, 64)


# ---------------------------------------------------------------------------
# initial states
# ---------------------------------------------------------------------------


def test_near_orbit_is_the_sanitizers_draw():
    from ft_mpc_torch.benchmarks import sanitizer

    want = sanitizer.x0_states(137)
    got = plant.initial_states({"kind": "near_orbit", "pos": 0.5, "vel": 0.2, "omega": 0.3}, 137,
                               sanitizer.SEED)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    big = plant.near_orbit_x0(8, 2**33 + 3, 0.5, 0.2, 0.3)
    assert not np.array_equal(big, plant.near_orbit_x0(8, 2**33 + 4, 0.5, 0.2, 0.3))
    assert np.all(big[:, 6:10] == [0, 0, 0, 1])


def test_the_other_initial_states_are_as_they_were():
    digest = lambda a: hashlib.sha256(a.tobytes()).hexdigest()
    assert digest(plant.tumbling_x0(64, 2**33 + 5, 1.0, 0.3, 0.3)) == \
        "83a303202e0b0bc1b50cc0125ef31f0fe2138586e3240e28eafd739b182359e8"
    assert digest(plant.at_rest_x0(64, 2**33 + 5, 1.0)) == \
        "1dc75b9ea529353199fc24685c3071d6fc044605723cbe363d4c24ddb3643d1a"
