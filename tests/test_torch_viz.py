"""Visualization of ft_mpc_torch (`viz/`) and the `Polytope` methods it
uses, against the JAX package (`ft_mpc_tpu/viz`, `tests/test_viz.py`).

  * the Agg backend, no display;
  * `thruster_geometry` equal to the JAX one and consistent with D;
  * `Polytope.from_vertices`, `contains`, `minkowski_add_vector`,
    `set_subtraction_along_vector` and `transform_input` equal to the JAX
    package's on the same float64 inputs;
  * the dashboards, the animation and the polytope plots render a port
    `RolloutHistory` (the per-scenario loop on the CPU, 6 steps) into
    files.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ft_mpc_torch.api import DEFAULT_TUNING, build_scenario_with_terminal  # noqa: E402
from ft_mpc_torch.controllers import spiraling as tsp  # noqa: E402
from ft_mpc_torch.geometry.polytope import Polytope as TPolytope  # noqa: E402
from ft_mpc_torch.models.planar import build_thruster_matrix_2d  # noqa: E402
from ft_mpc_torch.ops.dynamics import BodyParams, build_thruster_matrix  # noqa: E402
from ft_mpc_torch.sim.env import SimConfig, rollout  # noqa: E402
from ft_mpc_torch.utils import trajectory as ttraj  # noqa: E402
from ft_mpc_torch.utils.faults import BrokenThruster  # noqa: E402
from ft_mpc_torch.viz import (  # noqa: E402
    animate_rollout,
    plot_polytope_2d,
    plot_polytope_3d,
    plot_wrench_sets,
    show_direct_inputs,
    show_generalized_inputs,
    show_orbit_errors,
    show_robot_errors,
    thruster_geometry,
)
from ft_mpc_tpu.geometry.polytope import Polytope as JPolytope  # noqa: E402
from ft_mpc_tpu.viz.animate import thruster_geometry as j_thruster_geometry  # noqa: E402

torch.set_num_threads(1)


def test_agg_backend():
    assert matplotlib.get_backend().lower() == "agg"


@pytest.mark.parametrize("D", [None, build_thruster_matrix(), build_thruster_matrix_2d()],
                         ids=["default", "3d", "planar"])
def test_thruster_geometry_matches_jax(D):
    poss, dirs = thruster_geometry(D if D is None else torch.as_tensor(D))
    jposs, jdirs = j_thruster_geometry(D)
    np.testing.assert_array_equal(poss, jposs)
    np.testing.assert_array_equal(dirs, jdirs)
    D = build_thruster_matrix() if D is None else D
    for i in range(16):
        f, tau = D[0:3, i], D[3:6, i]
        np.testing.assert_allclose(-dirs[i] * np.linalg.norm(f), f, atol=1e-12)
        np.testing.assert_allclose(np.cross(poss[i], f), tau, atol=1e-12)


def test_polytope_methods_match_jax(rng):
    pts = rng.standard_normal((40, 3))
    t, j = TPolytope.from_vertices(pts), JPolytope.from_vertices(pts)
    np.testing.assert_array_equal(t.A, j.A)
    np.testing.assert_array_equal(t.b, j.b)
    for x in [*rng.standard_normal((20, 3)), pts[0], 3 * pts[1]]:
        assert t.contains(x) == j.contains(x)
        assert t.contains(x, tol=0.1) == j.contains(x, tol=0.1)
    assert t.contains(pts.mean(axis=0)) and not t.contains(10 * np.abs(pts).max(axis=0))
    v, M = rng.standard_normal(3), rng.standard_normal((3, 3))
    for name, arg in (("minkowski_add_vector", v), ("set_subtraction_along_vector", v),
                      ("transform_input", M)):
        got, want = getattr(t, name)(arg), getattr(j, name)(arg)
        assert isinstance(got, TPolytope), name
        np.testing.assert_array_equal(got.A, want.A, err_msg=name)
        np.testing.assert_array_equal(got.b, want.b, err_msg=name)
    box = TPolytope.from_box([-1, -1], [1, 2])
    assert box.minkowski_add_vector([1.0, 0.0]).contains([1.9, 0.0])
    assert not box.set_subtraction_along_vector([0.5, 0.0]).contains([0.9, 0.0])


@pytest.fixture(scope="module")
def small_history():
    """tests/test_viz.py's history on the port: (10), horizon 8, 1 SQP
    iteration, 6 steps, no noise, float64 on the CPU."""
    params = BodyParams.default(0.1, dtype=torch.float64, device="cpu")
    sc = build_scenario_with_terminal(params, [BrokenThruster(10, 1.0)], DEFAULT_TUNING,
                                      device="cpu", dtype=torch.float64)
    weights = tsp.MPCWeights.from_diagonals(DEFAULT_TUNING["Q"], DEFAULT_TUNING["R"],
                                            dtype=torch.float64, device="cpu")
    traj = ttraj.generate_trajectory("hover", 0.1, 3)
    x_ref, u_ref = ttraj.prepare_center_trajectory(traj, sc.omega_des.numpy(), 16.8, 0.1, 9)
    x0 = np.zeros(13)
    x0[9] = 1.0
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    hist = rollout(params, sc, weights, tsp.MPCConfig(horizon=8, sqp_iters=1),
                   SimConfig(steps=6, noise_mode="none"), t(x0), t(x_ref), t(u_ref))
    return hist, sc, params


def test_dashboards_render(small_history, tmp_path):
    hist, sc, params = small_history
    for i, fig in enumerate([show_direct_inputs(hist), show_generalized_inputs(hist, params.D),
                             show_orbit_errors(hist), show_robot_errors(hist)]):
        fig.savefig(tmp_path / f"f{i}.png")
        plt.close(fig)
        assert (tmp_path / f"f{i}.png").stat().st_size > 0


def test_animation_renders(small_history, tmp_path):
    hist, sc, _ = small_history
    anim = animate_rollout(hist, sc, save_path=str(tmp_path / "a.gif"), stride=1, fps=5)
    assert (tmp_path / "a.gif").stat().st_size > 0
    assert anim is not None


def test_polytope_plots(small_history, tmp_path):
    ax = plot_polytope_2d(TPolytope.from_box([-1, -1], [1, 2]), show_vertices=True)
    ax.figure.savefig(tmp_path / "p2.png")
    plt.close(ax.figure)
    ax3 = plot_polytope_3d(TPolytope.from_box([-1, -1, 0], [1, 2, 1]))
    ax3.figure.savefig(tmp_path / "p3.png")
    plt.close(ax3.figure)
    with pytest.raises(ValueError, match="dim 2"):
        plot_polytope_2d(TPolytope.from_box([0, 0, 0], [1, 1, 1]))
    _, _, params = small_history
    fig = plot_wrench_sets(params.D.numpy(), 3.4,
                           [[], [BrokenThruster(10, 1.0), BrokenThruster(11, 1.0)]],
                           save_path=str(tmp_path / "wrench.png"))
    plt.close(fig)
    assert (tmp_path / "wrench.png").stat().st_size > 0
