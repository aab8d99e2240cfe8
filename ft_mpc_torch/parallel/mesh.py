"""Scenario-parallel execution over a list of devices, counterpart of
`ft_mpc_tpu/parallel/mesh.py`.

The scaling axis is the scenario batch: fault patterns x initial states are
independent, so the leading scenario axis is split into contiguous, equal
shards, each on its own device, and each shard runs the port's batched
function on its rows.  Only scalar metrics cross shards.

  * A `ScenarioMesh` is a tuple of `torch.device`s and the axis name.  A
    device may repeat: `["cpu"] * 8` stands in for eight CPU devices (the
    JAX suite's 8 virtual devices), `["cuda:0", "cuda:0"]` runs two shards
    on one card.
  * Batched leaves (scenarios, states, warm starts) travel as `Sharded`:
    one tree per shard, in row order.  Plant params, weights and the
    reference windows are replicated: copied to each shard's device once
    per call.
  * Each shard's call runs inside `torch.cuda.device(shard device)`, since
    the kernels launch on the current CUDA device.  Shards are dispatched in
    turn from one Python thread; the condensed step's one host sync
    (`lanes_qp.newton_kinv`'s rescue test) makes shards on different cards
    wait for each other there.
  * Metrics are the JAX package's reductions: `mean_cost` is the mean of
    the shards' means (`pmean`), `max_r_prim` and `max_term_gap` are maxima
    (`pmax`), over every process of an initialized `torch.distributed`
    group as well (`all_reduce`; on gloo the scalars go through the host).

Semantics that follow from the JAX design and are kept: the Newton-metric
rescue predicate is batch-global, so a shard may pick the exact
factorization where the whole batch did not, and the worst-K cleanup picks
K worst rows per shard.  A sharded lanes step therefore equals the
unsharded step to ADMM tolerance (not bit for bit, and only where cleanup is
off), and equals `get_control_batch` on each shard's own rows exactly.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ft_mpc_torch import resolve_device
from ft_mpc_torch.controllers.spiraling import (
    MPCConfig,
    MPCWeights,
    get_control_batch,
    get_control_rows,
    init_warmstart_batch,
)
from ft_mpc_torch.ops.dynamics import BodyParams
from ft_mpc_torch.sim.env import SimConfig, batched_rollout, batched_rollout_lanes

SCENARIO_AXIS = "scenario"


class ScenarioMesh(NamedTuple):
    """1-D mesh: one shard of the scenario axis per listed device."""

    devices: tuple[torch.device, ...]
    axis_name: str = SCENARIO_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _mesh_device(device) -> torch.device:
    """A mesh entry: `resolve_device`, with a CUDA index made explicit."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_scenario_mesh(devices: Sequence | None = None) -> ScenarioMesh:
    """1-D mesh over every local CUDA device (default) or the given devices.

    A device may repeat: `["cpu"] * 8` gives eight CPU shards and
    `["cuda:0", "cuda:0"]` two shards on one card.  Without a CUDA device
    the default raises (`resolve_device`).
    """
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_mesh_device(d) for d in devices)
    if not devs:
        raise ValueError("a scenario mesh needs at least one device")
    return ScenarioMesh(devices=devs)


class Sharded(NamedTuple):
    """A scenario-batched tree split along its leading axis: one tree per
    shard of a mesh, in row order.  `offset` is the global row of the first
    shard and `global_batch` the rows over every process (one process holds
    all of them unless the tree came from `global_scenario_array`)."""

    shards: tuple
    offset: int = 0
    global_batch: int = 0

    def gather(self, device=None):
        """The whole (local) tree, the shards concatenated in row order on
        `device` (default the first shard's)."""
        leaves0, spec = tree_flatten(self.shards[0])
        dev = device
        if dev is None:
            dev = next((x.device for x in leaves0 if isinstance(x, torch.Tensor)), None)
        per_shard = [tree_flatten(s)[0] for s in self.shards]
        cat = [
            None if leaves[0] is None
            else torch.cat([x.to(dev) for x in leaves], dim=0)
            for leaves in zip(*per_shard)
        ]
        return tree_unflatten(cat, spec)


def _rows(tree) -> int:
    return next(x.shape[0] for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


def shard_scenario_batch(mesh: ScenarioMesh, tree) -> Sharded:
    """Split a scenario-batched tree into contiguous, equal shards, shard i
    on `mesh.devices[i]`.  A batch that does not divide evenly raises."""
    B = _rows(tree)
    n = mesh.size
    if B % n:
        raise ValueError(f"batch {B} does not divide over {n} shards")
    per = B // n
    shards = tuple(
        tree_map(lambda x, lo=i * per: None if x is None else x[lo: lo + per].to(dev), tree)
        for i, dev in enumerate(mesh.devices)
    )
    return Sharded(shards=shards, offset=0, global_batch=B)


def _device_context(device: torch.device):
    """The context a shard's call runs in: its card made current."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _as_sharded(mesh: ScenarioMesh, tree) -> Sharded:
    if isinstance(tree, Sharded):
        if len(tree.shards) != mesh.size:
            raise ValueError(f"{len(tree.shards)} shards on a mesh of {mesh.size}")
        return tree
    return shard_scenario_batch(mesh, tree)


def map_shards(mesh: ScenarioMesh, fn: Callable, sharded: Sequence, replicated=()) -> Sharded:
    """fn(*shard_i, *replicated_on_device_i) for every shard, each call in
    its device's context: the counterpart of `jax.shard_map` with scenario
    specs on `sharded` and replicated specs on `replicated`.  Replicated
    trees are copied once to each distinct device."""
    parts = [_as_sharded(mesh, t) for t in sharded]
    copies = {}
    outs = []
    for i, dev in enumerate(mesh.devices):
        if dev not in copies:
            copies[dev] = [
                tree_map(lambda x: None if x is None else x.to(dev), t) for t in replicated
            ]
        with _device_context(dev):
            outs.append(fn(*(p.shards[i] for p in parts), *copies[dev]))
    return Sharded(shards=tuple(outs), offset=parts[0].offset,
                   global_batch=parts[0].global_batch)


def sharded_init_warmstart(
    mesh: ScenarioMesh,
    params: BodyParams,
    scenarios,  # Sharded (or a whole batch, sharded here)
    weights: MPCWeights,
    cfg: MPCConfig,
    c0,  # (B, 13) center-frame states, sharded
    x_ref: torch.Tensor,  # replicated
    u_ref: torch.Tensor,
) -> Sharded:
    """`init_warmstart_batch` on every shard (the exact K^-1 per shard)."""
    return map_shards(
        mesh,
        lambda sc, c, p, w, xr, ur: init_warmstart_batch(p, sc, w, cfg, c, xr, ur),
        (scenarios, c0), (params, weights, x_ref, u_ref),
    )


class StepMetrics(NamedTuple):
    mean_cost: torch.Tensor  # mean of the shards' means (pmean)
    max_r_prim: torch.Tensor  # max over every shard (pmax)
    # max of the elastic terminal-restoration gap (SQPInfo.term_gap):
    # nonzero only for scenarios whose restoration QP is genuinely
    # infeasible -- gated separately from solver convergence (max_r_prim)
    max_term_gap: torch.Tensor
    u_phys: Sharded  # (B, 16) per shard
    wrench: Sharded  # (B, 6) per shard


def collective_device(device: torch.device) -> torch.device:
    """Where a tensor takes part in a collective: the host on gloo."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else device


def _step_metrics(mesh: ScenarioMesh, out: Sharded) -> StepMetrics:
    """`StepMetrics` of a sharded `ControlOutput`: pmean of the shards' mean
    cost, pmax of r_prim and term_gap, over every process of an
    initialized `torch.distributed` group too."""
    dev = mesh.devices[0]
    infos = [o.info for o in out.shards]
    means = torch.stack([i.cost.mean().to(dev) for i in infos])
    maxes = torch.stack([
        torch.stack([i.r_prim.max().to(dev) for i in infos]).max(),
        torch.stack([i.term_gap.max().to(dev) for i in infos]).max(),
    ])
    sums = torch.stack([means.sum(), torch.tensor(float(len(infos)), dtype=means.dtype,
                                                  device=dev)])
    if dist.is_available() and dist.is_initialized():
        cdev = collective_device(dev)
        sums, maxes = sums.to(cdev), maxes.to(cdev)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
        sums, maxes = sums.to(dev), maxes.to(dev)
    return StepMetrics(
        mean_cost=sums[0] / sums[1],
        max_r_prim=maxes[0],
        max_term_gap=maxes[1],
        u_phys=out._replace(shards=tuple(o.u_phys for o in out.shards)),
        wrench=out._replace(shards=tuple(o.wrench for o in out.shards)),
    )


def sharded_control_step(
    mesh: ScenarioMesh,
    params: BodyParams,
    scenarios,  # Sharded, leading axis B
    weights: MPCWeights,
    cfg: MPCConfig,
    x0,  # (B, 13), sharded
    x_ref: torch.Tensor,  # (Nt+1, 9) replicated
    u_ref: torch.Tensor,  # (Nt+1, 6) replicated
    warm,  # batched WarmStart (kinv None), sharded
) -> tuple[Sharded, StepMetrics]:
    """One batched MPC control step on the per-scenario path, scenario-
    sharded: `get_control_rows` (the JAX package's `vmap(get_control)`) on
    every shard."""
    out = map_shards(
        mesh,
        lambda sc, x, w, p, wt, xr, ur: get_control_rows(p, sc, wt, cfg, x, xr, ur, w),
        (scenarios, x0, warm), (params, weights, x_ref, u_ref),
    )
    return out, _step_metrics(mesh, out)


def sharded_control_step_lanes(
    mesh: ScenarioMesh,
    params: BodyParams,
    scenarios,  # Sharded, leading axis B
    weights: MPCWeights,
    cfg: MPCConfig,
    x0,  # (B, 13), sharded
    x_ref: torch.Tensor,  # (Nt+1, 9) replicated
    u_ref: torch.Tensor,  # (Nt+1, 6)
    warm,  # batched WarmStart incl. kinv, sharded
) -> tuple[Sharded, StepMetrics]:
    """One batched MPC control step on the deployed batched backend,
    scenario-sharded: `get_control_batch` (the condensing, ADMM and
    allocation kernels on a card) on every shard's rows."""
    out = map_shards(
        mesh,
        lambda sc, x, w, p, wt, xr, ur: get_control_batch(p, sc, wt, cfg, x, xr, ur, w),
        (scenarios, x0, warm), (params, weights, x_ref, u_ref),
    )
    return out, _step_metrics(mesh, out)


def _rollout_sharded(rollout_fn, mesh, params, scenarios, weights, mpc_cfg, sim_cfg,
                     x_inits, x_ref_full, u_ref_full, generators) -> Sharded:
    gens = (None,) * mesh.size if generators is None else tuple(generators)
    if len(gens) != mesh.size:
        raise ValueError(f"{len(gens)} generators for a mesh of {mesh.size} shards")
    return map_shards(
        mesh,
        lambda sc, x, g, p, w, xr, ur: rollout_fn(p, sc, w, mpc_cfg, sim_cfg, x, xr, ur, g),
        (scenarios, x_inits, Sharded(shards=gens)), (params, weights, x_ref_full, u_ref_full),
    )


def sharded_rollout_lanes(
    mesh: ScenarioMesh,
    params: BodyParams,
    scenarios,  # Sharded, leading axis B
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_inits,  # (B, 13), sharded
    x_ref_full: torch.Tensor,  # replicated
    u_ref_full: torch.Tensor,
    generators: Sequence[torch.Generator] | None = None,  # one per shard
) -> Sharded:
    """Closed-loop rollouts on the batched backend, scenario-sharded: each
    shard runs `batched_rollout_lanes` on its rows; a `Sharded` of
    `RolloutHistory` (B_shard, T, ...).

    Noise: the JAX package takes one PRNG key per scenario, the port's
    rollouts one `torch.Generator` per bank, so here one generator per
    shard, on that shard's device.  Noisy sharded rollouts therefore are not
    the unsharded ones; with noise_mode='none' they are.
    """
    return _rollout_sharded(batched_rollout_lanes, mesh, params, scenarios, weights,
                            mpc_cfg, sim_cfg, x_inits, x_ref_full, u_ref_full, generators)


def sharded_rollout(
    mesh: ScenarioMesh,
    params: BodyParams,
    scenarios,  # Sharded, leading axis B
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_inits,  # (B, 13), sharded
    x_ref_full: torch.Tensor,  # replicated
    u_ref_full: torch.Tensor,
    generators: Sequence[torch.Generator] | None = None,  # one per shard
) -> Sharded:
    """Closed-loop rollouts on the per-scenario controller, scenario-
    sharded: `batched_rollout` on every shard (noise as in
    `sharded_rollout_lanes`)."""
    return _rollout_sharded(batched_rollout, mesh, params, scenarios, weights, mpc_cfg,
                            sim_cfg, x_inits, x_ref_full, u_ref_full, generators)

