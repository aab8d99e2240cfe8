"""Polytope and wrench-hull visualization (host-side, matplotlib),
counterpart of `ft_mpc_tpu/viz/polytope_plot.py` on the port's `Polytope`.

Covers the reference's plotting surface the framework previously lacked:
`MyPolytope.plot_2d/plot_3d` (`ft_mpc/util/polytope.py:176-346`) and the
InputBounds smoke plots of the force/torque hulls under fault patterns
(`ft_mpc/controllers/tools/input_bounds.py:78-100`).

All functions accept an optional matplotlib Axes and return it, so they
compose into dashboards; nothing here touches the device.
"""

from __future__ import annotations

import numpy as np

from ft_mpc_torch.geometry.polytope import Polytope
from ft_mpc_torch.ops.dynamics import host_array


def _require_matplotlib():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt  # noqa: F401

    return matplotlib.pyplot


def plot_polytope_2d(
    poly: Polytope,
    ax=None,
    *,
    color: str = "C0",
    alpha: float = 0.35,
    label: str | None = None,
    show_vertices: bool = False,
):
    """Filled 2D polygon of a 2-d polytope (vertices ordered by angle).

    Counterpart of `MyPolytope.plot_2d` (`ft_mpc/util/polytope.py:176-230`),
    minus its `np.rand` bug (quirk 9 in SURVEY.md §8).
    """
    if poly.dim != 2:
        raise ValueError(f"plot_polytope_2d needs dim 2, got {poly.dim}")
    plt = _require_matplotlib()
    if ax is None:
        _, ax = plt.subplots()
    verts = poly.vertices()
    center = verts.mean(axis=0)
    order = np.argsort(np.arctan2(verts[:, 1] - center[1], verts[:, 0] - center[0]))
    verts = verts[order]
    ax.fill(verts[:, 0], verts[:, 1], color=color, alpha=alpha, label=label)
    ax.plot(
        np.append(verts[:, 0], verts[0, 0]),
        np.append(verts[:, 1], verts[0, 1]),
        color=color,
        lw=1.2,
    )
    if show_vertices:
        ax.plot(verts[:, 0], verts[:, 1], "o", color=color, ms=3)
    ax.set_aspect("equal", adjustable="datalim")
    return ax


def plot_polytope_3d(
    poly: Polytope,
    ax=None,
    *,
    color: str = "C0",
    alpha: float = 0.25,
    edge_color: str = "k",
    label: str | None = None,
):
    """Translucent 3D hull of a 3-d polytope via its vertex convex hull.

    Counterpart of `MyPolytope.plot_3d` (`ft_mpc/util/polytope.py:232-346`),
    built on one qhull call instead of per-facet vertex chasing.
    """
    if poly.dim != 3:
        raise ValueError(f"plot_polytope_3d needs dim 3, got {poly.dim}")
    plt = _require_matplotlib()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    from scipy.spatial import ConvexHull

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    verts = poly.vertices()
    hull = ConvexHull(verts)
    faces = [verts[s] for s in hull.simplices]
    coll = Poly3DCollection(
        faces, alpha=alpha, facecolor=color, edgecolor=edge_color, linewidths=0.3
    )
    ax.add_collection3d(coll)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    pad = 0.05 * np.maximum(hi - lo, 1e-9)
    ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
    ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
    ax.set_zlim(lo[2] - pad[2], hi[2] + pad[2])
    if label is not None:
        ax.set_title(label)
    return ax


def _project(poly: Polytope, dims: tuple[int, ...]) -> Polytope:
    """Orthogonal projection of the polytope onto the given coordinates
    (via vertex enumeration + re-hull -- exact, fine at the 6-d wrench sizes)."""
    verts = poly.vertices()[:, list(dims)]
    return Polytope.from_vertices(verts)


def plot_wrench_sets(
    D: np.ndarray,
    max_thrust: float,
    fault_patterns,
    save_path: str | None = None,
):
    """Force and torque hulls of the attainable wrench set per fault pattern.

    The framework's version of the InputBounds `__main__` smoke plot
    (`ft_mpc/controllers/tools/input_bounds.py:78-100`): one row per fault
    pattern, left the 3-d force hull, right the 3-d torque hull.

    Args:
        fault_patterns: sequence of fault lists (each a list of
            `BrokenThruster`); `[]` plots the healthy craft.

    Returns the matplotlib Figure.
    """
    from ft_mpc_torch.geometry.zonotope import attainable_wrench_polytope

    plt = _require_matplotlib()
    D = host_array(D)
    patterns = list(fault_patterns)
    fig = plt.figure(figsize=(8, 3.5 * max(len(patterns), 1)))
    m = D.shape[1]
    for row, faults in enumerate(patterns):
        broken = np.zeros(m)
        intensity = np.zeros(m)
        for f in faults:
            broken[f.index] = 1.0
            intensity[f.index] = f.intensity
        hull6 = attainable_wrench_polytope(D, max_thrust, broken, intensity)
        names = (
            "healthy"
            if not faults
            else ", ".join(f"#{f.index}@{f.intensity:g}" for f in faults)
        )
        for col, (dims, what) in enumerate(
            [((0, 1, 2), "force [N]"), ((3, 4, 5), "torque [Nm]")]
        ):
            ax = fig.add_subplot(len(patterns), 2, 2 * row + col + 1, projection="3d")
            plot_polytope_3d(
                _project(hull6, dims), ax=ax, color=f"C{row % 10}",
                label=f"{names}: {what}",
            )
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=110)
    return fig
