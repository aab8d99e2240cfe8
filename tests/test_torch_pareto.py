"""The port's accuracy/throughput sweep (`ft_mpc_torch.benchmarks.pareto`)
on the CPU, against `benchmarks/pareto.py`'s recipe.

- The six points are the JAX script's (`pareto.py:25-32`, copied below),
  and each point's configuration equals the MPCConfig `bench.py:87-104`
  builds from the point's FT_MPC_BENCH_* overrides, field for field.
- The sweep at B=8 with two small points, 2 rounds of windows of 2 steps:
  the record's fields, each point's samples from its own rounds, the
  in-turns order (each point's untimed window, then the points in order,
  reversed every other round), the launches counted per point (none on
  the CPU), nothing written but `out` (never under `benchmarks/`).
- The frontier table and the fastest point at max_r_prim <= 1e-3 on
  synthetic points; the entry point; no run without a card.
"""

from __future__ import annotations

import json
import tomllib
from pathlib import Path

import pytest
import torch

from ft_mpc_torch.benchmarks import pareto
from ft_mpc_tpu.controllers import spiraling as jsp
from ft_mpc_tpu.solvers.mpc_qp import StructuredADMMConfig as JCfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# pareto.py:25-32, copied
JAX_CONFIGS = [
    (2, 40, 1, 3, 0, 0),
    (2, 60, 1, 3, 0, 0),
    (2, 60, 1, 3, 300, 256),
    (2, 60, 1, 3, 450, 256),
    (2, 60, 1, 3, 600, 256),
    (3, 80, 1, 3, 600, 256),
]
SMALL = ((2, 10, 1, 3, 0, 0), (2, 10, 1, 3, 20, 4))


def plain(t):
    """A NamedTuple as nested dicts (tuples kept), for comparing configs
    across packages."""
    if hasattr(t, "_asdict"):
        return {k: plain(v) for k, v in t._asdict().items()}
    return t


def test_points_are_the_jax_scripts():
    assert list(pareto.CONFIGS) == JAX_CONFIGS
    assert pareto.DEPLOYED in pareto.CONFIGS


@pytest.mark.parametrize("point", JAX_CONFIGS)
def test_point_config_is_bench_pys(point):
    """bench.py:87-104 with FT_MPC_BENCH_SQP, ITERS, PHASES, NEWTON,
    CLEANUP, CLEANUP_K set as pareto.py:41-48 sets them."""
    sqp, iters, phases, newton, cleanup, cleanup_k = point
    want = jsp.MPCConfig(horizon=15, sqp_iters=sqp,
                         admm=JCfg(iters=iters, phases=phases, rho=50.0, adapt_clip=1.5),
                         newton_iters=newton, cleanup_iters=cleanup, cleanup_k=cleanup_k,
                         cleanup_phases=3)
    assert plain(pareto.point_config(point)) == plain(want)


def test_pareto_on_cpu(monkeypatch, tmp_path):
    order = []
    real_call = pareto.Chain.__call__

    def call(self):
        order.append(self.cfg.cleanup_iters)
        real_call(self)

    monkeypatch.setattr(pareto.Chain, "__call__", call)
    before = sorted((p.name, p.stat().st_mtime_ns) for p in (REPO / "benchmarks").iterdir())
    out = tmp_path / "pareto.json"
    rec = pareto.main(B=8, configs=SMALL, rounds=2, steps_per_window=2, device="cpu", out=out)
    # each point's untimed window, then round 0 in order and round 1 reversed
    assert order == [0, 20, 0, 20, 20, 0]
    assert json.loads(out.read_text())["points"][0]["label"] == pareto.label(SMALL[0])
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in (REPO / "benchmarks").iterdir()) == before
    assert rec["device"] == "cpu" and rec["card"] is None and rec["gap_gate"] == 10.0
    assert rec["rounds"] == 2 and rec["reference_point"] == pareto.label(SMALL[0])
    a, b = rec["points"]
    for r, point in zip(rec["points"], SMALL):
        assert len(r["latency_samples_ms"]) == 2 and r["counted_steps"] == 6
        assert r["latency_p50_ms"] == pytest.approx(sum(r["latency_samples_ms"]) / 2)
        assert r["solves_per_s"] == pytest.approx(8e3 / r["latency_p50_ms"])
        assert r["spread"]["max_over_min"] >= 1.0
        assert r["config"]["cleanup_iters"] == point[4] and r["config"]["cleanup_phases"] == 3
        assert all(v == 0 for v in r["launches_per_step"].values())  # plain versions
        assert r["max_r_prim"] > 0 and r["max_term_gap"] >= 0
    assert a["vs_deployed_same_round"] == 1.0
    assert len(rec["frontier_md"]) >= 2 + len(SMALL) + 2
    json.dumps(rec)


def _point(p50, r_prim, **kw):
    return {"label": f"{p50} {r_prim}", "latency_p50_ms": p50, "latency_p99_ms": p50,
            "solves_per_s": 2048e3 / p50, "max_r_prim": r_prim, "max_term_gap": 0.3,
            "gap_rows": [209], "meets_control_period": p50 <= 100.0, "sqp_iters": 2,
            "admm_iters": 60, "phases": 1, "cleanup_iters": 600, "cleanup_k": 256,
            "spread": {"max_over_min": 1.1}, **kw}


def test_fastest_accurate_and_frontier():
    pts = [_point(250.0, 5e-2), _point(340.0, 7e-4), _point(330.0, 9e-4), _point(90.0, 2e-3)]
    best = pareto.fastest_accurate(pts)
    assert best["latency_p50_ms"] == 330.0 and not best["meets_control_period"]
    assert pareto.fastest_accurate(pts[:1]) is None
    assert pareto.fastest_accurate([_point(90.0, 1e-3)])["meets_control_period"]
    md = pareto.frontier(pts)
    assert md[0].startswith("| sqp | admm iters | cleanup | solves/s | max_r_prim |")
    assert md[2] == ("| 2 | 60x1 | 600@K256 | 8192.0 | 5.000e-02 | 250.000 | 250.000 | "
                     "1.100 |")
    assert md[-1] == "- rows [209], max gap 0.3"  # the gap rows once, apart


def test_entry_point_and_cli(monkeypatch, capsys):
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["ft-mpc-torch-pareto"] == "ft_mpc_torch.benchmarks.pareto:cli"
    monkeypatch.setattr(pareto, "main", lambda **kw: {"frontier_md": ["| table |"], **kw})
    assert pareto.cli(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "| table |" and json.loads(lines[-1])["device"] == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_needs_a_card_unless_asked():
    with pytest.raises(RuntimeError, match="CUDA"):
        pareto.main()
