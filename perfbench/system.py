"""The system under test, built through the program's own entry points.

The harness hands the program only what it would get in flight: the bank it
builds from the fault patterns (`api.build_scenario_with_terminal` with the
committed terminal cache), the weights with the configuration's state box
and wrench-rate bound where it states them, an `MPCConfig` whose every field
comes from the configuration's file, the states and the reference windows.
A period is `get_control_batch`; between periods the harness shifts the
warm start with the program's `shift_warmstart`, as the program's own
closed loop (`sim/env.py`) does.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from perfbench import cell as cells


def mpc_config(config: dict, B: int):
    """Every field of the program's `MPCConfig` from the file; a field the
    file lacks, or one the program does not have, is refused."""
    from ft_mpc_torch.controllers.spiraling import MPCConfig
    from ft_mpc_torch.solvers.mpc_qp import StructuredADMMConfig
    from ft_mpc_torch.solvers.mpc_qp_stagewise import StagewiseConfig

    m = dict(config["mpc"])
    m["cleanup_k"] = cells.cleanup_k(config, B)
    del m["cleanup_k_fraction"]
    for cls, got in ((MPCConfig, m), (StructuredADMMConfig, m["admm"]),
                     (StagewiseConfig, m["stagewise"])):
        if set(got) != set(cls._fields):
            raise ValueError(f"{cls.__name__}: the file gives {sorted(got)}, "
                             f"the program has {sorted(cls._fields)}")
    m["admm"] = StructuredADMMConfig(**m["admm"])
    m["stagewise"] = StagewiseConfig(**m["stagewise"])
    m["ls_alphas"] = tuple(m["ls_alphas"])
    return MPCConfig(**m)


def plant(config: dict, device, dtype=torch.float32):
    """The program's `BodyParams` of the configuration's plant."""
    import numpy as np

    from ft_mpc_torch.ops.dynamics import BodyParams
    from perfbench.plant import thruster_matrix

    p = config["plant"]
    inertia = np.diag(p["inertia_diag"])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return BodyParams(mass=t(p["mass"]), inertia=t(inertia), inertia_inv=t(np.linalg.inv(inertia)),
                      max_thrust=t(p["max_thrust"]), D=t(thruster_matrix(*p["thruster_arms"])),
                      dt=t(p["dt"]))


def build(config: dict, traffic: dict, device):
    """The program's bank (built on the host, tiled, handed to `device`),
    plant, weights and configuration for this cell."""
    from ft_mpc_torch.api import build_scenario_with_terminal
    from ft_mpc_torch.controllers.spiraling import MPCWeights
    from ft_mpc_torch.geometry.scenario import stack_scenarios, take_rows
    from ft_mpc_torch.utils.faults import BrokenThruster

    cpu = torch.device("cpu")
    host_plant = plant(config, cpu)
    term = config["terminal"]
    scenarios = [build_scenario_with_terminal(host_plant, [BrokenThruster(i, 1.0) for i in p],
                                              term["tuning"], terminal_mode=term["mode"],
                                              device=cpu)
                 for p in traffic["patterns"]]
    B = traffic["batch"]
    bank = stack_scenarios(scenarios, device=device).scenarios
    bank = take_rows(bank, torch.as_tensor(cells.bank_rows(traffic), device=device))
    w = config["weights"]
    return SimpleNamespace(
        bank=bank, params=plant(config, device),
        weights=MPCWeights.from_diagonals(w["Q"], w["R"], **cells.weight_bounds(config),
                                          dtype=torch.float32, device=device),
        cfg=mpc_config(config, B))


def init_warm(sut, x0, x_ref, u_ref):
    from ft_mpc_torch.controllers.spiraling import init_warmstart_batch
    from ft_mpc_torch.ops.dynamics import robot_to_center

    c0 = robot_to_center(sut.bank.r, x0)
    return init_warmstart_batch(sut.params, sut.bank, sut.weights, sut.cfg, c0, x_ref, u_ref)


def step(sut, x, x_ref, u_ref, warm):
    from ft_mpc_torch.controllers.spiraling import get_control_batch

    return get_control_batch(sut.params, sut.bank, sut.weights, sut.cfg, x, x_ref, u_ref, warm)


def shift(sut, warm, x_new):
    from ft_mpc_torch.controllers.spiraling import shift_warmstart
    from ft_mpc_torch.ops.dynamics import robot_to_center

    return shift_warmstart(warm, robot_to_center(sut.bank.r, x_new))


def rescues() -> int:
    """The program's count of whole-bank exact refactors of K^-1."""
    from ft_mpc_torch.solvers.lanes_qp import newton_kinv

    return newton_kinv.rescues
