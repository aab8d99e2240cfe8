"""2D freeflyer plant, embedded in the 3D engine; counterpart of
`ft_mpc_tpu/models/planar.py`.

The reference documents (but does not ship code for) a 2D freeflyer:
m = 14.5 kg, J = 0.37 kg m^2, 8 thrusters, 3x8 allocation matrix, f_max =
1.75 N.  The planar craft is expressed in the 13-state engine:

  * thrusters 0-7 fire in the body x/y plane with z-lever torques,
  * columns 8-15 of D are zero, and those indices are marked as *dead
    faults* in every scenario (`planar_fault`), so the zonotope geometry,
    MPC constraints and allocation all see an 8-thruster planar craft,
  * out-of-plane inertia entries exist but are never excited (planar
    initial states + zero out-of-plane wrench keep z/roll/pitch invariant).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ft_mpc_torch import resolve_device
from ft_mpc_torch.ops.dynamics import N_THRUSTERS, BodyParams
from ft_mpc_torch.utils.faults import BrokenThruster

PLANAR_ABSENT_THRUSTERS = tuple(range(8, 16))


def build_thruster_matrix_2d(lever: float = 0.12) -> np.ndarray:
    """6x16 allocation matrix with 8 active planar thrusters, host numpy.

    Layout (forces in body frame, torques about z):
      0,1: -x force, -+lever z-torque     2,3: +x force, +-lever z-torque
      4,5: -y force, -+lever z-torque     6,7: +y force, +-lever z-torque
    Columns 8-15 are zero (absent).
    """
    D = np.zeros((6, N_THRUSTERS))
    # force x
    D[0, 0:2] = -1.0
    D[0, 2:4] = 1.0
    # force y
    D[1, 4:6] = -1.0
    D[1, 6:8] = 1.0
    # torque z: opposing pairs so pure forces and pure torques are attainable
    D[5, 0:8] = [-lever, lever, lever, -lever, -lever, lever, lever, -lever]
    return D


def planar_body_params(dt: float = 0.1, dtype: torch.dtype = torch.float32,
                       device=None) -> BodyParams:
    """BodyParams for the documented 2D freeflyer, leaves of `dtype` on
    `device` (default cuda), as `BodyParams.default` takes them."""
    dev = resolve_device(device)
    inertia = np.diag([0.185, 0.185, 0.37])
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    return BodyParams(
        mass=as_t(14.5),
        inertia=as_t(inertia),
        inertia_inv=as_t(np.linalg.inv(inertia)),
        max_thrust=as_t(1.75),
        D=as_t(build_thruster_matrix_2d()),
        dt=as_t(dt),
    )


def planar_fault(faults: Sequence[BrokenThruster] = ()) -> list[BrokenThruster]:
    """Fault list with the absent out-of-plane thrusters marked dead."""
    for f in faults:
        if f.index >= 8:
            raise ValueError("planar craft has thrusters 0-7 only")
    dead = [BrokenThruster(i, 0.0) for i in PLANAR_ABSENT_THRUSTERS]
    return list(faults) + dead
