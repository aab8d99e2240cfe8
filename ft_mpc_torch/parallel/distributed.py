"""Multi-process execution on `torch.distributed`, counterpart of
`ft_mpc_tpu/parallel/distributed.py`.

  * `initialize_distributed()` -- `init_process_group` with argument /
    environment plumbing, idempotent, safe to call unconditionally at
    program start (returns False in single-process runs).
  * `make_host_scenario_mesh()` -- this process's scenario mesh.  torch has
    no global device list: each process lists its own devices, and the
    processes' meshes together make the global one, process-major.
  * `global_scenario_array()` -- this process's rows of the global batch,
    sharded over its mesh, with the global batch size and this process's
    offset, so each process materializes only its own rows.
  * `local_scenario_range()` -- the [start, stop) rows of the global batch
    this process builds on the host.
  * `process_allgather()` -- every process's rows, concatenated in process
    order on every process (the JAX package's `process_allgather(tiled=True)`).

The backend is the caller's choice, never switched behind its back: the
default is 'nccl', whose ranks each need a card of their own.  Two
processes that share one card run only on 'gloo', which the caller names
(`backend="gloo"`); with a CUDA mesh the scalar metrics, and the outputs
`process_allgather` gathers, are then copied to the host for the
collective.  A CPU mesh runs on 'gloo'.

Usage, one command per process (or under `torchrun`, whose MASTER_ADDR,
MASTER_PORT, RANK and WORLD_SIZE are read too):

    python -m ft_mpc_torch.parallel.launch --coordinator=HOST0:1234 \
        --num-processes=2 --process-id=$RANK ...
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ft_mpc_torch import resolve_device
from ft_mpc_torch.parallel.mesh import (
    ScenarioMesh,
    Sharded,
    collective_device,
    make_scenario_mesh,
    shard_scenario_batch,
)

BACKENDS = ("nccl", "gloo")


def _env_int(*names: str) -> int | None:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Initialize the default `torch.distributed` process group. Idempotent.

    Each field: the explicit argument, then the environment
    (`FT_MPC_COORDINATOR`, `FT_MPC_NUM_PROCESSES`, `FT_MPC_PROCESS_ID`),
    then torchrun's (`MASTER_ADDR`:`MASTER_PORT`, `WORLD_SIZE`, `RANK`).
    `backend` defaults to 'nccl' (which needs CUDA and a card per rank);
    'gloo' must be named.  Returns True if a process group was (or already
    is) initialized, False for single-process runs (nothing to do).
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("FT_MPC_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("FT_MPC_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("FT_MPC_PROCESS_ID", "RANK")
    if coordinator_address is None:
        return False  # single-process run
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} given without the number of "
            "processes and this process's id"
        )
    backend = "nccl" if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        resolve_device(None)  # raises without CUDA
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def make_host_scenario_mesh(devices=None) -> ScenarioMesh:
    """This process's scenario mesh: `cuda:{LOCAL_RANK}` (default 0), or
    the given devices.  Without a card the default raises."""
    if devices is None:
        devices = [f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"]
    return make_scenario_mesh(devices)


def local_scenario_range(global_batch: int) -> tuple[int, int]:
    """[start, stop) rows of the global scenario batch this process owns.

    The global batch must divide evenly over the processes.
    """
    nproc = process_count()
    if global_batch % nproc:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {nproc}"
        )
    per = global_batch // nproc
    pid = process_index()
    return pid * per, (pid + 1) * per


def global_scenario_array(mesh: ScenarioMesh, local_tree) -> Sharded:
    """This process's rows (see `local_scenario_range`) sharded over its
    mesh, with the global batch size and this process's row offset.  Every
    process holds the same number of rows.  Single-process runs are
    `shard_scenario_batch`."""
    sh = shard_scenario_batch(mesh, local_tree)
    n = process_count()
    return sh._replace(offset=process_index() * sh.global_batch,
                       global_batch=n * sh.global_batch)


def global_shard_count(mesh: ScenarioMesh) -> int:
    """Shards over every process (this mesh's size times the processes'
    count, checked by an all-reduce in multi-process runs)."""
    if process_count() == 1:
        return mesh.size
    dev = collective_device(mesh.devices[0])
    t = torch.tensor([mesh.size, -mesh.size], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != -int(t[1]):
        raise ValueError("every process must list the same number of devices")
    return mesh.size * process_count()


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` concatenated along axis 0 in process order, on
    `t`'s device (`process_allgather(tiled=True)`); `t` itself in a
    single-process run.  On gloo the rows go through the host."""
    if process_count() == 1:
        return t
    src = t.contiguous().to(collective_device(t.device))
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=0).to(t.device)
