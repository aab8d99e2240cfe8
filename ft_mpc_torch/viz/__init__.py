"""Host-side visualization: 3D animation and diagnostic dashboards,
counterpart of `ft_mpc_tpu/viz` (matplotlib, imported when a function runs)."""

from ft_mpc_torch.viz.animate import animate_rollout, thruster_geometry  # noqa: F401
from ft_mpc_torch.viz.polytope_plot import (  # noqa: F401
    plot_polytope_2d,
    plot_polytope_3d,
    plot_wrench_sets,
)
from ft_mpc_torch.viz.dashboards import (  # noqa: F401
    show_direct_inputs,
    show_generalized_inputs,
    show_orbit_errors,
    show_robot_errors,
)
