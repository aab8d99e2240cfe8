"""Closed-loop simulation, counterpart of `ft_mpc_tpu/sim/env.py`.

Each step: controller (SQP solve -> allocation) -> plant RK4 -> additive
state noise -> quaternion renormalize -> warm-start shift.  The JAX package
runs the loop as one `lax.scan`; here it is a Python loop over steps whose
every operation is batched over the B rollouts at once and stays on the
device: the loop reads nothing back to the host (the batched controller's
`newton_kinv` keeps its one rescue test, and a configuration with gated
refinement reads whether any row still needs it).

  * `rollout` / `rollout_with_fault_schedule`: one scenario, the per-scenario
    controller (`get_control`), histories (T, ...);
  * `batched_rollout`: B scenarios on the per-scenario controller, every
    row at once (`get_control_rows`, the JAX package's vmap of `rollout`);
  * `batched_rollout_lanes`: B scenarios on the batched controller
    (`get_control_batch`: the condensing, ADMM and allocation kernels).
  The batched ones return (B, T, ...).

Noise: the reference adds uniform(0, 1e-3) per state block, a positively
biased disturbance.  `noise_mode` selects 'reference' (that bias),
'zero_mean', or 'none'.  A `torch.Generator` on the tensors' device takes
the place of the JAX package's PRNG key; any mode but 'none' needs one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_map

from ft_mpc_torch.controllers.spiraling import (
    ControlOutput,
    MPCConfig,
    MPCWeights,
    WarmStart,
    _first,
    _one,
    get_control_batch,
    get_control_rows,
    init_warmstart,
    init_warmstart_batch,
    shift_warmstart,
)
from ft_mpc_torch.geometry.scenario import Scenario
from ft_mpc_torch.ops.dynamics import BodyParams, robot_step, robot_to_center
from ft_mpc_torch.ops.quaternion import quat_normalize

NOISE_MODES = ("reference", "zero_mean", "none")


class SimConfig(NamedTuple):
    """Rollout configuration."""

    steps: int
    noise_mode: str = "reference"  # 'reference' | 'zero_mean' | 'none'
    noise_position: float = 1e-3
    noise_velocity: float = 1e-3
    noise_orientation: float = 1e-3
    noise_angular_velocity: float = 1e-3


class RolloutHistory(NamedTuple):
    """Per-step records (time axis first for one rollout, (B, T, ...) for a
    batch); a superset of the reference's 67-column CSV schema."""

    time: torch.Tensor  # (T,)
    state: torch.Tensor  # (T, 13) robot state at solve time
    c0: torch.Tensor  # (T, 13) center state at solve time
    u_phys: torch.Tensor  # (T, 16)
    wrench: torch.Tensor  # (T, 6) commanded generalized force
    x_ref0: torch.Tensor  # (T, 9) active reference
    cost: torch.Tensor  # (T,)
    r_prim: torch.Tensor  # (T,)
    r_dual: torch.Tensor  # (T,)
    defect: torch.Tensor  # (T,)
    term_gap: torch.Tensor  # (T,) elastic terminal-restoration gap
    was_clipped: torch.Tensor  # (T,)


def _check_noise(cfg: SimConfig, generator: torch.Generator | None) -> None:
    if cfg.noise_mode not in NOISE_MODES:
        raise ValueError(f"unknown noise_mode {cfg.noise_mode}")
    if cfg.noise_mode != "none" and generator is None:
        raise ValueError(
            f"noise_mode {cfg.noise_mode!r} draws noise: pass a torch.Generator on "
            "the tensors' device (or noise_mode='none')"
        )


def _noise_vector(cfg: SimConfig, generator: torch.Generator | None,
                  like: torch.Tensor) -> torch.Tensor:
    """Additive state noise shaped like `like` (..., 13), in its dtype.

    'reference': u * scales with u ~ uniform[0, 1) (positively biased);
    'zero_mean': (u - 0.5) * scales; 'none': zeros, and nothing is drawn.
    """
    _check_noise(cfg, generator)
    if cfg.noise_mode == "none":
        return torch.zeros_like(like)
    kw = dict(dtype=like.dtype, device=like.device)
    scales = torch.cat([
        torch.full((3,), cfg.noise_position, **kw),
        torch.full((3,), cfg.noise_velocity, **kw),
        torch.full((4,), cfg.noise_orientation, **kw),
        torch.full((3,), cfg.noise_angular_velocity, **kw),
    ])
    u = torch.rand(like.shape, generator=generator, **kw)
    if cfg.noise_mode == "reference":
        return u * scales
    return (u - 0.5) * scales


def _window(full: torch.Tensor, i: int, length: int) -> torch.Tensor:
    """full[i : i + length], with the start clamped so the window fits, as
    `jax.lax.dynamic_slice` clamps it."""
    if full.shape[0] < length:
        raise ValueError(f"reference of {full.shape[0]} rows, a window needs {length}")
    start = min(i, full.shape[0] - length)
    return full[start : start + length]


def _closed_loop(
    params: BodyParams,
    scenario_at: Callable[[int], Scenario],
    control: Callable[..., ControlOutput],
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_init: torch.Tensor,  # (B, 13), in the reference's dtype
    warm: WarmStart,
    x_ref_full: torch.Tensor,
    u_ref_full: torch.Tensor,
    generator: torch.Generator | None,
    on_step: Callable[[int, torch.Tensor, WarmStart], None] | None = None,
) -> RolloutHistory:
    """The loop shared by every rollout: (B, T, ...) histories.  `on_step`,
    when given, is called as on_step(i, state, warm) with step i's inputs
    before it, and with i = steps and the next ones after the last step."""
    Nt = mpc_cfg.horizon
    dtype = x_ref_full.dtype
    B = x_init.shape[0]
    state = x_init
    recs = []
    for i in range(sim_cfg.steps):
        if on_step is not None:
            on_step(i, state, warm)
        sc = scenario_at(i)
        x_ref = _window(x_ref_full, i, Nt + 1)
        u_ref = _window(u_ref_full, i, Nt + 1)
        out = control(params, sc, weights, mpc_cfg, state, x_ref, u_ref, warm)

        x_new = robot_step(params, sc.fault, state, out.u_phys)
        x_new = x_new + _noise_vector(sim_cfg, generator, x_new)
        x_new = torch.cat([x_new[:, :6], quat_normalize(x_new[:, 6:10]), x_new[:, 10:]],
                          dim=1)
        warm = shift_warmstart(out.warm, robot_to_center(sc.r, x_new))

        recs.append((
            torch.full((B,), float(i), dtype=dtype, device=state.device) * params.dt,
            state, out.c0, out.u_phys, out.wrench, x_ref[0].expand(B, 9),
            out.info.cost, out.info.r_prim, out.info.r_dual, out.info.defect,
            out.info.term_gap, out.alloc.was_clipped,
        ))
        state = x_new
    if on_step is not None:
        on_step(sim_cfg.steps, state, warm)
    return RolloutHistory(*(torch.stack(r, dim=1) for r in zip(*recs)))


def _per_scenario_loop(params, bank: Scenario, weights, mpc_cfg, sim_cfg, x_inits,
                       x_ref_full, u_ref_full, generator) -> RolloutHistory:
    """B rollouts on the per-scenario controller, every row at once."""
    _check_noise(sim_cfg, generator)
    x_inits = x_inits.to(x_ref_full.dtype)
    c_init = robot_to_center(bank.r, x_inits)
    warm0 = init_warmstart(params, bank, mpc_cfg, c_init, weights=weights)
    return _closed_loop(params, lambda i: bank, get_control_rows, weights, mpc_cfg,
                        sim_cfg, x_inits, warm0, x_ref_full, u_ref_full, generator)


def rollout(
    params: BodyParams,
    scenario: Scenario,
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_init: torch.Tensor,  # (13,) robot state
    x_ref_full: torch.Tensor,  # (T_ref, 9) center reference (T_ref >= Nt+1)
    u_ref_full: torch.Tensor,  # (T_ref, 6)
    generator: torch.Generator | None = None,
) -> RolloutHistory:
    """One closed-loop simulation of one scenario; histories (T, ...)."""
    hist = _per_scenario_loop(params, _one(scenario), weights, mpc_cfg, sim_cfg,
                              x_init[None], x_ref_full, u_ref_full, generator)
    return _first(hist)


def rollout_with_fault_schedule(
    params: BodyParams,
    scenario_schedule: Scenario,  # leading axis S: scenario per phase
    switch_steps,  # (S,) step at which each scenario activates
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_init: torch.Tensor,
    x_ref_full: torch.Tensor,
    u_ref_full: torch.Tensor,
    generator: torch.Generator | None = None,
) -> RolloutHistory:
    """Closed loop with mid-trajectory fault injection; histories (T, ...).

    At step i the active scenario is the last entry of `scenario_schedule`
    whose switch step is <= i (index clip(sum(switch_steps <= i) - 1, 0,
    S - 1)), gathered on the device: model, constraint geometry,
    compensation input and terminal ingredients all change at once.
    """
    _check_noise(sim_cfg, generator)
    dtype = x_ref_full.dtype
    dev = x_ref_full.device
    switch = torch.as_tensor(switch_steps, device=dev)
    S = switch.shape[0]

    def active(i: int) -> Scenario:
        idx = torch.clamp((switch <= i).sum() - 1, 0, S - 1).reshape(1)
        return tree_map(lambda leaf: leaf.index_select(0, idx), scenario_schedule)

    x0 = x_init.to(dtype)[None]
    sc0 = active(0)
    warm0 = init_warmstart(params, sc0, mpc_cfg, robot_to_center(sc0.r, x0),
                           weights=weights)
    hist = _closed_loop(params, active, get_control_rows, weights, mpc_cfg, sim_cfg, x0,
                        warm0, x_ref_full, u_ref_full, generator)
    return _first(hist)


def batched_rollout(
    params: BodyParams,
    scenarios: Scenario,  # leading scenario axis on every leaf
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_inits: torch.Tensor,  # (B, 13)
    x_ref_full: torch.Tensor,  # shared (T_ref, 9)
    u_ref_full: torch.Tensor,
    generator: torch.Generator | None = None,
) -> RolloutHistory:
    """B simultaneous closed loops on the per-scenario controller (the JAX
    package's vmap of `rollout`); histories (B, T, ...)."""
    return _per_scenario_loop(params, scenarios, weights, mpc_cfg, sim_cfg, x_inits,
                              x_ref_full, u_ref_full, generator)


def batched_rollout_lanes(
    params: BodyParams,
    scenarios: Scenario,  # leading scenario axis on every leaf
    weights: MPCWeights,
    mpc_cfg: MPCConfig,
    sim_cfg: SimConfig,
    x_inits: torch.Tensor,  # (B, 13)
    x_ref_full: torch.Tensor,  # shared (T_ref, 9)
    u_ref_full: torch.Tensor,
    generator: torch.Generator | None = None,
    on_step: Callable[[int, torch.Tensor, WarmStart], None] | None = None,
) -> RolloutHistory:
    """B simultaneous closed loops on the batched controller.

    Same semantics as `batched_rollout`, but each step is one
    `get_control_batch` for the whole bank (the condensing, ADMM and
    allocation kernels on the card, the Newton-refreshed inverse metric
    carried in the warm start).  Histories (B, T, ...).  `on_step(i, state,
    warm)`, when given, sees each step's robot state and warm start before
    the step runs, and the next ones once after the last (i = steps): a
    caller's per-step timer, or a copy of the last step's inputs.
    """
    _check_noise(sim_cfg, generator)
    Nt = mpc_cfg.horizon
    x_inits = x_inits.to(x_ref_full.dtype)
    c_init = robot_to_center(scenarios.r, x_inits)
    warm0 = init_warmstart_batch(params, scenarios, weights, mpc_cfg, c_init,
                                 x_ref_full[: Nt + 1], u_ref_full[: Nt + 1])
    return _closed_loop(params, lambda i: scenarios, get_control_batch, weights, mpc_cfg,
                        sim_cfg, x_inits, warm0, x_ref_full, u_ref_full, generator, on_step)
