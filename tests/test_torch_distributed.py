"""Multi-process scaffolding of ft_mpc_torch (`parallel/distributed.py`,
`parallel/launch.py`) on `torch.distributed`.

torch has no virtual devices: a process lists its own, and a device may
repeat, so `--cpu-devices 4` gives a process four CPU shards.  The
multi-process runs are real: separate interpreters joined by a gloo process
group on localhost (a free port found by binding to port 0), each with
OMP_NUM_THREADS=1 and a timeout:
  * `initialize_distributed` returns False with no coordinator and names its
    backend (nccl needs CUDA; nothing is switched silently);
  * `local_scenario_range` in one process and in two (even and uneven
    global batches);
  * `python -m ft_mpc_torch.parallel.launch`, two gloo processes x 4 CPU
    shards against one process x 8 shards on the same global bank: the
    gathered u_phys and wrench equal at 1e-5 N, the metrics at rtol 1e-5
    (the JAX package's bar, `tests/test_distributed.py:164-171`), and the
    JSON line's fields.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_mpc_torch.parallel import distributed as tdist
from ft_mpc_torch.parallel import launch as tlaunch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300
ENV_NAMES = ("FT_MPC_COORDINATOR", "FT_MPC_NUM_PROCESSES", "FT_MPC_PROCESS_ID",
             "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
LAUNCH = ["--per-device", "4", "--horizon", "5", "--reps", "2"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ENV_NAMES}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    return env


def run_together(cmds) -> list[str]:
    """Start every command, then wait for each (TIMEOUT s); their stdouts."""
    procs = [subprocess.Popen(c, cwd=REPO, env=child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.fixture
def no_cluster_env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)


def test_initialize_distributed_single_process(no_cluster_env):
    import torch.distributed as dist

    assert tdist.initialize_distributed() is False
    assert not dist.is_initialized()
    assert tdist.process_count() == 1 and tdist.process_index() == 0


def test_initialize_distributed_names_its_backend(no_cluster_env, monkeypatch):
    with pytest.raises(ValueError, match="number of processes"):
        tdist.initialize_distributed("127.0.0.1:1")
    with pytest.raises(ValueError, match="backend"):
        tdist.initialize_distributed("127.0.0.1:1", 1, 0, backend="mpi")
    # the default is nccl, which needs CUDA: no silent fall-back to gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.initialize_distributed()


def test_host_mesh_and_single_process_helpers(no_cluster_env, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.make_host_scenario_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdist.make_host_scenario_mesh().devices == (torch.device("cuda", 3),)
    mesh = tdist.make_host_scenario_mesh(["cpu"] * 2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert tdist.local_scenario_range(64) == (0, 64)
    assert tdist.local_scenario_range(63) == (0, 63)  # one process: any batch
    sh = tdist.global_scenario_array(mesh, torch.arange(6.0))
    assert (sh.offset, sh.global_batch) == (0, 6) and len(sh.shards) == 2
    t = torch.arange(4.0)
    assert tdist.process_allgather(t) is t
    assert tdist.global_shard_count(mesh) == 2


def test_launch_flags():
    with pytest.raises(SystemExit):
        tlaunch._parse(["--cpu-devices", "2", "--backend", "nccl"])
    with pytest.raises(SystemExit):
        tlaunch._parse(["--cpu-devices", "2", "--devices", "cpu,cpu"])
    a = tlaunch._parse([])
    assert (a.per_device, a.horizon, a.reps, a.sqp_iters, a.admm_iters, a.admm_phases) == (
        256, 15, 10, 2, 40, 1)
    assert a.backend is None and a.devices is None and a.cpu_devices is None


_RANGE_SCRIPT = r"""
import sys
import torch.distributed as dist
from ft_mpc_torch.parallel.distributed import (
    global_scenario_array, initialize_distributed, local_scenario_range,
    make_host_scenario_mesh, process_allgather,
)
import torch
pid = int(sys.argv[1])
assert initialize_distributed("127.0.0.1:" + sys.argv[2], 2, pid, backend="gloo") is True
assert initialize_distributed() is True  # idempotent
assert dist.get_world_size() == 2 and dist.get_rank() == pid
lo, hi = local_scenario_range(128)
assert (lo, hi) == (64 * pid, 64 * (pid + 1)), (lo, hi)
try:
    local_scenario_range(129)
    raise SystemExit("expected ValueError for an uneven batch")
except ValueError:
    pass
mesh = make_host_scenario_mesh(["cpu"] * 4)
sh = global_scenario_array(mesh, torch.arange(lo, hi, dtype=torch.float32))
assert (sh.offset, sh.global_batch) == (lo, 128), (sh.offset, sh.global_batch)
g = process_allgather(sh.gather())
assert torch.equal(g, torch.arange(128, dtype=torch.float32))
dist.destroy_process_group()
print("ok", pid)
"""


def test_local_scenario_range_two_processes():
    port = str(free_port())
    outs = run_together([[sys.executable, "-c", _RANGE_SCRIPT, str(pid), port]
                         for pid in (0, 1)])
    assert [o.split()[-1] for o in outs] == ["0", "1"]


def test_two_process_launch_matches_single_process(tmp_path):
    """Identical global bank and states on 8 CPU shards: 1 process x 8
    against 2 gloo processes x 4; only the collective transport differs."""
    dump1, dump2 = tmp_path / "out_1proc.npz", tmp_path / "out_2proc.npz"
    port = str(free_port())
    launch = [sys.executable, "-m", "ft_mpc_torch.parallel.launch", *LAUNCH]
    outs = run_together(
        [launch + ["--cpu-devices", "8", "--dump", str(dump1)]]
        + [launch + ["--cpu-devices", "4", "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", "2", "--process-id", str(pid),
                     "--dump", str(dump2)] for pid in (0, 1)]
    )
    one, two = json_line(outs[0]), json_line(outs[1])
    assert not [ln for ln in outs[2].splitlines() if ln.startswith("{")]  # rank 1 is quiet
    assert (one["processes"], one["devices"], one["global_batch"]) == (1, 8, 32)
    assert (two["processes"], two["devices"], two["global_batch"]) == (2, 8, 32)
    for line in (one, two):
        assert sorted(line) == sorted(["processes", "devices", "global_batch",
                                       "solves_per_s", "mean_cost", "max_r_prim",
                                       "max_term_gap"])
        assert line["solves_per_s"] > 0 and np.isfinite(line["mean_cost"])
        assert line["max_r_prim"] < 1.0 and line["max_term_gap"] <= 0.4

    a, b = np.load(dump1), np.load(dump2)
    assert a["u_phys"].shape == b["u_phys"].shape == (32, 16)
    assert np.isfinite(a["u_phys"]).all()
    np.testing.assert_allclose(b["u_phys"], a["u_phys"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(b["wrench"], a["wrench"], rtol=0, atol=1e-5)
    for k in ("mean_cost", "max_r_prim", "max_term_gap"):
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5, err_msg=k)
        assert float(b[k]) == pytest.approx(two[k], rel=1e-6)
