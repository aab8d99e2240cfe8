"""Diagnostic dashboards over rollout histories, counterpart of
`ft_mpc_tpu/viz/dashboards.py`, on the port's `RolloutHistory` (tensors on
any device, brought to numpy on entry).

Role parity with `ControllerDebug.show_*`
(`ft_mpc/util/controller_debug.py:93-202`): per-thruster input grid,
force/torque traces, orbit-center and robot tracking errors -- operating on
the framework's `RolloutHistory` arrays instead of per-step Python objects.
Each function returns the figure (call plt.show() to display).
"""

from __future__ import annotations

from ft_mpc_torch.ops.dynamics import host_array


def _plt():
    import matplotlib.pyplot as plt

    return plt


def show_direct_inputs(hist):
    """4x4 grid of the 16 thruster commands over time."""
    plt = _plt()
    t = host_array(hist.time)
    u = host_array(hist.u_phys)
    fig, ax = plt.subplots(4, 4, figsize=(12, 8), sharex=True)
    for i in range(16):
        a = ax[i // 4, i % 4]
        a.plot(t, u[:, i])
        a.set_title(f"Input {i}", fontsize=8)
    fig.tight_layout()
    return fig


def show_generalized_inputs(hist, D):
    """2x3 grid: realized body-frame forces and torques."""
    plt = _plt()
    t = host_array(hist.time)
    gf = host_array(hist.u_phys) @ host_array(D).T
    fig, ax = plt.subplots(2, 3, figsize=(12, 6), sharex=True)
    for i in range(3):
        ax[0, i].plot(t, gf[:, i])
        ax[0, i].set_title(f"Force {i}")
        ax[1, i].plot(t, gf[:, 3 + i])
        ax[1, i].set_title(f"Torque {i}")
    fig.tight_layout()
    return fig


def show_orbit_errors(hist):
    """Orbit-center tracking errors (position, velocity, angular velocity)."""
    plt = _plt()
    t = host_array(hist.time)
    c0 = host_array(hist.c0)
    ref = host_array(hist.x_ref0)
    fig, ax = plt.subplots(3, 3, figsize=(12, 8), sharex=True)
    names = ["position", "velocity", "angular velocity"]
    for blk in range(3):
        err = ref[:, 3 * blk : 3 * blk + 3] - c0[:, 3 * blk : 3 * blk + 3]
        for i in range(3):
            ax[i, blk].plot(t, err[:, i])
            ax[i, blk].set_title(f"Orbit {names[blk]} err {i}", fontsize=9)
    fig.tight_layout()
    return fig


def show_robot_errors(hist):
    """Robot-state tracking errors including quaternion components."""
    plt = _plt()
    t = host_array(hist.time)
    s = host_array(hist.state)
    ref = host_array(hist.x_ref0)
    fig, ax = plt.subplots(4, 3, figsize=(12, 9), sharex=True)
    pos_err = ref[:, 0:3] - s[:, 0:3]
    vel_err = ref[:, 3:6] - s[:, 3:6]
    om_err = ref[:, 6:9] - s[:, 10:13]
    for i in range(3):
        ax[0, i].plot(t, pos_err[:, i])
        ax[0, i].set_title(f"Robot pos err {i}", fontsize=9)
        ax[1, i].plot(t, vel_err[:, i])
        ax[1, i].set_title(f"Robot vel err {i}", fontsize=9)
        ax[2, i].plot(t, om_err[:, i])
        ax[2, i].set_title(f"Robot omega err {i}", fontsize=9)
    for i in range(3):
        ax[3, i].plot(t, s[:, 6 + i])
        ax[3, i].set_title(f"Quaternion {('x','y','z')[i]}", fontsize=9)
    fig.tight_layout()
    return fig
