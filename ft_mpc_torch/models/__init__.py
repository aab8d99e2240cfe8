"""Model families, counterpart of `ft_mpc_tpu/models`.

The default 3D spacecraft lives in `ops.dynamics` (`BodyParams.default`).
`planar` provides the 2D freeflyer of the reference's documentation
(`data/InertialProperties.md`: m = 14.5 kg, J = 0.37 kg m^2, 8 thrusters)
as a *configuration* of the same 13-state engine: absent out-of-plane
thrusters are dead faults, so every subsystem (zonotope geometry, SQP MPC,
allocation, terminal ingredients) applies unchanged.
"""

from ft_mpc_torch.models.planar import (  # noqa: F401
    planar_body_params,
    planar_fault,
    PLANAR_ABSENT_THRUSTERS,
)
