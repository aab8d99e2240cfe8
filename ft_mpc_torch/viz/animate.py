"""3D closed-loop animation: spacecraft body, thruster firings, faults;
counterpart of `ft_mpc_tpu/viz/animate.py`, on the port's `RolloutHistory`
and `Scenario` (tensors on any device, brought to numpy on entry).

Role parity with `ft_mpc/util/animate.py:7-405` (body box + 16 thruster
arrows, failed thrusters highlighted red, body axes, orbit-center trace,
setpoint marker, gif/mp4 export) -- but the thruster geometry is *derived
from the allocation matrix D* instead of hand-tabulated: each thruster's
direction is its force column and its position is recovered from the torque
column via p = dir x tau / |dir|^2 (+ a surface offset along dir), so the
drawing stays consistent with whatever plant the scenario defines.
"""

from __future__ import annotations

import numpy as np

from ft_mpc_torch.ops.dynamics import build_thruster_matrix, host_array


def thruster_geometry(D: np.ndarray | None = None, body_half: float = 0.15):
    """Per-thruster (position, direction) in body frame, derived from D.

    direction_i = -D[0:3, i] normalized (thrust direction; the force on the
    body is along +D).  position_i solves p x f = tau with the minimum-norm
    component plus an offset that puts the nozzle on the body surface.
    """
    D = build_thruster_matrix() if D is None else host_array(D)
    dirs = []
    poss = []
    for i in range(D.shape[1]):
        f = D[0:3, i]
        tau = D[3:6, i]
        n = np.linalg.norm(f)
        if n < 1e-12:
            dirs.append(np.zeros(3))
            poss.append(np.zeros(3))
            continue
        # tau = p x f  ->  minimum-norm p = f x tau / |f|^2
        p = np.cross(f, tau) / n**2
        # push the nozzle out to the face the thruster fires from
        p = p - body_half * f / n
        dirs.append(-f / n)  # exhaust direction (opposite of force)
        poss.append(p)
    return np.array(poss), np.array(dirs)


def _rot_body_to_world(q):
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(np.array(q, dtype=np.float64)).as_matrix()


def animate_rollout(
    hist,
    scenario,
    save_path: str | None = None,
    stride: int = 2,
    body_half: float = 0.15,
    fps: int = 15,
):
    """Animate a RolloutHistory.  Returns the FuncAnimation object."""
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    state = host_array(hist.state)[::stride]
    u = host_array(hist.u_phys)[::stride]
    c0 = host_array(hist.c0)[::stride]
    ref = host_array(hist.x_ref0)[::stride]
    Tn = state.shape[0]

    poss, dirs = thruster_geometry()
    broken = host_array(scenario.fault.broken)
    intensity = host_array(scenario.fault.intensity)

    # body box corners
    h = body_half
    corners = np.array(
        [[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)]
    )
    edges = [
        (a, b)
        for a in range(8)
        for b in range(a + 1, 8)
        if np.sum(np.abs(corners[a] - corners[b]) > 1e-9) == 1
    ]

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    lim = max(1.5, np.abs(state[:, 0:3]).max() * 1.2)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")

    edge_lines = [ax.plot([], [], [], "k-", lw=1)[0] for _ in edges]
    thr_lines = [
        ax.plot([], [], [], "r-" if broken[i] else "b-", lw=2)[0] for i in range(16)
    ]
    axis_lines = [ax.plot([], [], [], c, lw=1.5)[0] for c in ("r-", "g-", "b-")]
    trace, = ax.plot([], [], [], "c-", lw=0.8, alpha=0.7)
    center_pt, = ax.plot([], [], [], "co", ms=4)
    setpoint, = ax.plot([], [], [], "g*", ms=10)

    def update(k):
        pos = state[k, 0:3]
        R = _rot_body_to_world(state[k, 6:10])
        wc = (R @ corners.T).T + pos
        for line, (a, b) in zip(edge_lines, edges):
            line.set_data([wc[a, 0], wc[b, 0]], [wc[a, 1], wc[b, 1]])
            line.set_3d_properties([wc[a, 2], wc[b, 2]])
        for i in range(16):
            mag = intensity[i] * 3.4 if broken[i] else u[k, i]
            p0 = R @ poss[i] + pos
            p1 = p0 + R @ dirs[i] * 0.12 * mag
            thr_lines[i].set_data([p0[0], p1[0]], [p0[1], p1[1]])
            thr_lines[i].set_3d_properties([p0[2], p1[2]])
        for j, line in enumerate(axis_lines):
            a = R[:, j] * 0.35
            line.set_data([pos[0], pos[0] + a[0]], [pos[1], pos[1] + a[1]])
            line.set_3d_properties([pos[2], pos[2] + a[2]])
        trace.set_data(c0[: k + 1, 0], c0[: k + 1, 1])
        trace.set_3d_properties(c0[: k + 1, 2])
        center_pt.set_data([c0[k, 0]], [c0[k, 1]])
        center_pt.set_3d_properties([c0[k, 2]])
        setpoint.set_data([ref[k, 0]], [ref[k, 1]])
        setpoint.set_3d_properties([ref[k, 2]])
        ax.set_title(f"t = {k * stride * 0.1:.1f}s")
        return edge_lines + thr_lines + axis_lines + [trace, center_pt, setpoint]

    anim = FuncAnimation(fig, update, frames=Tn, interval=1000 // fps, blit=False)
    if save_path is not None:
        # gif via pillow; mp4 via ffmpeg when available (the reference saves
        # either, `ft_mpc/util/animate.py:389-400`).
        if str(save_path).endswith(".mp4"):
            from matplotlib.animation import FFMpegWriter, writers

            if writers.is_available("ffmpeg"):
                anim.save(save_path, writer=FFMpegWriter(fps=fps))
            else:  # no ffmpeg binary in this environment: fall back to gif
                import warnings

                gif_path = str(save_path)[:-4] + ".gif"
                warnings.warn(
                    f"ffmpeg unavailable; saving {gif_path} instead of mp4"
                )
                anim.save(gif_path, writer="pillow", fps=fps)
        else:
            anim.save(save_path, writer="pillow", fps=fps)
        plt.close(fig)
    return anim
