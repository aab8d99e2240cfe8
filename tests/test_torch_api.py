"""The port's user-facing API and demo vs the JAX package.

Float64 plant on both sides (the JAX package's tests run in x64), on the
CPU; the JAX builder reads a scratch copy of the committed terminal cache,
so no test writes under `ft_mpc_tpu/`, and the port reads the same copy:
  * `SpiralingMPC.get_control` against the JAX class's, two steps before
    and two after `set_fault(BrokenThruster(10, 1.0))`, at the per-scenario
    control step's tolerance (tests/test_torch_control.py: 1e-6 on u_phys);
    the broken thruster commands below 1e-9 N; the trajectory-end
    ValueError;
  * `SimulationEnvironment`: 5 steps against the JAX class step by step,
    the same seed and host noise, states within 1e-8; its history's
    67-column table against the JAX one's and the CSV header;
  * the demo (`ft_mpc_torch.examples.sim.main`) on the CPU with --batch 2
    for a 1 s run prints its three lines and writes its CSV.
"""

from __future__ import annotations

import re
import shutil
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_mpc_torch import api as tapi
from ft_mpc_torch.ops.dynamics import BodyParams as TBodyParams
from ft_mpc_torch.sim.history import CSV_HEADER, history_to_table
from ft_mpc_torch.utils.faults import BrokenThruster as TBroken
from ft_mpc_tpu import api as japi
from ft_mpc_tpu.ops.dynamics import BodyParams as JBodyParams
from ft_mpc_tpu.utils.faults import BrokenThruster as JBroken
from torch_parity import gentle_states

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TERMINAL_CACHE = REPO / "ft_mpc_tpu" / "config" / "terminal_cache"
TOL_U = 1e-6  # a per-scenario control step, float64 (tests/test_torch_control.py)
TOL_STATE = 1e-8


@pytest.fixture
def cache_copy(tmp_path, monkeypatch):
    """A scratch copy of the committed cache, read (and filled) by both
    packages' builders."""
    copy = tmp_path / "terminal_cache"
    shutil.copytree(TERMINAL_CACHE, copy)
    monkeypatch.setattr(japi, "_build_scenario_with_terminal",
                        partial(japi._build_scenario_with_terminal, cache_dir=str(copy)))
    return copy


def _controllers(cache, faults=()):
    jm = japi.SpiralingMPC(JBodyParams.default(0.1), [JBroken(i, 1.0) for i in faults])
    tm = tapi.SpiralingMPC(TBodyParams.default(0.1, torch.float64, "cpu"),
                           [TBroken(i, 1.0) for i in faults], cache_dir=cache)
    return jm, tm


def test_spiraling_mpc_matches_jax(cache_copy):
    jm, tm = _controllers(cache_copy)
    for m in (jm, tm):
        m.load_trajectory("hover", 3.0)
    x0 = gentle_states(1, seed=3)[0]
    for t in (0.0, 0.1):
        np.testing.assert_allclose(tm.get_control(x0, t), jm.get_control(x0, t),
                                   rtol=0, atol=TOL_U)
    jm.set_fault(JBroken(10, 1.0))
    tm.set_fault(TBroken(10, 1.0))
    assert tm._warm is None and tm.faults == [TBroken(10, 1.0)]
    np.testing.assert_array_equal(tm.trajectory[:, 6:9].numpy(),
                                  np.asarray(jm.trajectory)[:, 6:9])
    for t in (0.2, 0.3):
        u = tm.get_control(x0, t)
        np.testing.assert_allclose(u, jm.get_control(x0, t), rtol=0, atol=TOL_U)
        assert abs(u[10]) < 1e-9
    # the loaded 3 s trajectory covers steps 0..300 at horizon 15
    tm.get_control(x0, 30.0)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="trajectory only covers"):
            m.get_control(x0, 30.1)
    with pytest.raises(RuntimeError, match="load_trajectory"):
        tapi.SpiralingMPC(TBodyParams.default(0.1, torch.float64, "cpu"),
                          cache_dir=cache_copy).get_control(x0, 0.0)


def test_simulation_environment_matches_jax(cache_copy, tmp_path):
    jm, tm = _controllers(cache_copy, faults=(10,))
    envs = (japi.SimulationEnvironment(JBodyParams.default(0.1), jm, seed=7),
            tapi.SimulationEnvironment(TBodyParams.default(0.1, torch.float64, "cpu"), tm,
                                       seed=7))
    for env in envs:
        env.controller.load_trajectory("hover", 3.0)
        env.set_initial_state(position=[0.2, -0.1, 0.15], velocity=[0.05, 0.0, -0.02],
                              orientation=[0.0, 0.0, 0.0, 1.0],
                              angular_velocity=[0.0, 0.05, 0.5])
    for _ in range(5):
        for env in envs:
            env.step()
        np.testing.assert_allclose(envs[1].state, envs[0].state, rtol=0, atol=TOL_STATE)
        np.testing.assert_allclose(envs[1].history[-1][2], envs[0].history[-1][2],
                                   rtol=0, atol=TOL_U)
        assert envs[1].cur_time == envs[0].cur_time
    assert abs(envs[1].history[-1][2][10]) < 1e-9

    from ft_mpc_tpu.sim.history import history_to_table as j_table

    D = np.asarray(JBodyParams.default(0.1).D)
    table = history_to_table(envs[1].to_history(), D)
    assert table.shape == (5, 67)
    np.testing.assert_allclose(table, j_table(envs[0].to_history(), D), rtol=0,
                               atol=TOL_U)
    path = tmp_path / "run.csv"
    envs[1].export_csv(str(path))
    header = path.read_text().splitlines()[0]
    assert header == "# " + ";".join(CSV_HEADER) and len(CSV_HEADER) == 67
    np.testing.assert_allclose(np.loadtxt(path, delimiter=";"), table, rtol=1e-15,
                               atol=1e-15)


def test_demo_main_on_cpu(cache_copy, tmp_path, capsys):
    """`--batch 2` draws the second pattern from default_rng(0), as
    examples/sim.py does; a pattern the cache lacks goes through the
    pipeline into the scratch cache."""
    import yaml

    from ft_mpc_torch.examples import sim
    from ft_mpc_torch.utils.config import DEFAULT_CONFIG_PATH

    raw = yaml.safe_load(DEFAULT_CONFIG_PATH.read_text())
    raw["traj_duration"] = 1.0
    config = tmp_path / "short.yaml"
    config.write_text(yaml.safe_dump(raw))
    csv = tmp_path / "demo.csv"
    res = sim.main(["--config", str(config), "--batch", "2", "--device", "cpu",
                    "--csv", str(csv), "--cache-dir", str(cache_copy)])
    out = capsys.readouterr().out
    assert re.search(r"^simulated 1\.0s x 2 scenario\(s\) in .* MPC solves/s\) on cpu$",
                     out, re.M), out
    assert re.search(r"^final orbit-center position error: \d+\.\d{4} m$", out, re.M), out
    assert f"history exported to {csv}" in out
    anim = tmp_path / "sim_anim_torch.gif"
    assert f"animation saved to {anim}" in out and anim.stat().st_size > 0
    assert res["steps"] == 10 and res["scenarios"] == 2
    assert np.isfinite(res["final_error_m"])
    hist = res["history"]
    assert hist.u_phys.shape == (10, 16) and bool(torch.isfinite(hist.u_phys).all())
    assert hist.u_phys[:, 10:12].abs().max() <= 1e-6  # the configuration's (10, 11)
    assert np.loadtxt(csv, delimiter=";").shape == (10, 67)
