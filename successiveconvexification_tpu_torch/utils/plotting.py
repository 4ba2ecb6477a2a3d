"""Trajectory figures: the port's copy of the JAX package's
``utils/plotting.py``.

Static matplotlib figures: the 3D trajectory with thrust vectors, and the
time histories (position, velocity, thrust magnitude, tilt and rates,
mass). ``animate_trajectory`` renders the descent as a GIF. numpy and
matplotlib only (matplotlib is imported inside the functions, so the port
imports without it); the attitude's DCMs come from the port's
``utils/quaternion.quat_to_dcm`` on CPU tensors. X, U and sigma may be
numpy arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from successiveconvexification_tpu_torch.utils.quaternion import quat_to_dcm


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _dcm(q: np.ndarray) -> np.ndarray:
    return quat_to_dcm(torch.as_tensor(q)).numpy()


def _pyplot():
    """matplotlib's pyplot on the Agg backend; an ImportError names it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(X, U, sigma, params=None, path: str = "trajectory.png"):
    """Render a 6-DoF (or 3-DoF) trajectory to ``path``. Returns the figure."""
    plt = _pyplot()
    X, U, sigma = _np(X), _np(U), float(_np(sigma))
    K, nx = X.shape
    t = np.linspace(0.0, sigma, K)
    is6dof = nx >= 14

    fig = plt.figure(figsize=(14, 9))
    ax3 = fig.add_subplot(2, 3, 1, projection="3d")
    r = X[:, 1:4]
    # axes: x = up; plot as (east, north, up) for readability
    ax3.plot(r[:, 1], r[:, 2], r[:, 0], "-o", ms=2, lw=1)
    # thrust vectors (every few nodes)
    step = max(1, K // 20)
    if is6dof:
        for k in range(0, K, step):
            Ti = _dcm(X[k, 7:11]) @ U[k]
            ax3.quiver(r[k, 1], r[k, 2], r[k, 0], -Ti[1], -Ti[2], -Ti[0],
                       length=0.12, color="tab:red", normalize=False)
    ax3.set_xlabel("east")
    ax3.set_ylabel("north")
    ax3.set_zlabel("up")
    ax3.set_title(f"trajectory (tf = {sigma:.3f})")

    ax = fig.add_subplot(2, 3, 2)
    ax.plot(t, r)
    ax.set_title("position")
    ax.legend(["up", "east", "north"], fontsize=7)

    ax = fig.add_subplot(2, 3, 3)
    ax.plot(t, X[:, 4:7])
    ax.set_title("velocity")

    ax = fig.add_subplot(2, 3, 4)
    ax.plot(t, np.linalg.norm(U, axis=1), label="|T|")
    if params is not None:
        ax.axhline(float(_np(params.T_max)), ls="--", c="gray")
        ax.axhline(float(_np(params.T_min)), ls="--", c="gray")
    ax.set_title("thrust magnitude")

    ax = fig.add_subplot(2, 3, 5)
    if is6dof:
        tilt = 2.0 * np.arcsin(np.clip(np.linalg.norm(X[:, 9:11], axis=1), 0, 1))
        ax.plot(t, np.rad2deg(tilt), label="tilt")
        ax.plot(t, np.rad2deg(np.linalg.norm(X[:, 11:14], axis=1)),
                label="|omega|")
        ax.legend(fontsize=7)
        ax.set_title("attitude")
    else:
        ax.plot(t, X[:, 0])
        ax.set_title("mass")

    ax = fig.add_subplot(2, 3, 6)
    ax.plot(t, X[:, 0])
    ax.set_title("mass")

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    return fig


def animate_trajectory(X, U, sigma, params=None, path: str = "trajectory.gif",
                       fps: int = 10, body_len: float = 0.35):
    """Animate the landing: trail, body axis and thrust vector per node.

    Writes an animated GIF (matplotlib's PillowWriter). Returns the
    animation object, whose frame count callers may read."""
    plt = _pyplot()
    from matplotlib import animation

    X, U, sigma = _np(X), _np(U), float(_np(sigma))
    K, nx = X.shape
    r = X[:, 1:4]
    is6dof = nx >= 14
    # C_IB (body -> inertial), the dynamics' convention (thrust_i = C_ib u)
    dcms = [_dcm(X[k, 7:11]) for k in range(K)] if is6dof else None

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    pad = 0.1 * max(1.0, float(np.abs(r).max()))
    ax.set_xlim(r[:, 1].min() - pad, r[:, 1].max() + pad)
    ax.set_ylim(r[:, 2].min() - pad, r[:, 2].max() + pad)
    ax.set_zlim(min(0.0, r[:, 0].min()) - 0.1, r[:, 0].max() + pad)
    ax.set_xlabel("east")
    ax.set_ylabel("north")
    ax.set_zlabel("up")

    (trail,) = ax.plot([], [], [], "-", lw=1, color="tab:blue")
    (body,) = ax.plot([], [], [], "-", lw=2.5, color="k")
    (plume,) = ax.plot([], [], [], "-", lw=2, color="tab:red")

    def frame(k):
        trail.set_data(r[: k + 1, 1], r[: k + 1, 2])
        trail.set_3d_properties(r[: k + 1, 0])
        if dcms is not None:
            tip = r[k] + body_len * (dcms[k] @ np.array([1.0, 0.0, 0.0]))
            body.set_data([r[k, 1], tip[1]], [r[k, 2], tip[2]])
            body.set_3d_properties([r[k, 0], tip[0]])
            Ti = dcms[k] @ U[k]
        else:
            Ti = U[k]
        tail_pt = r[k] - 0.15 * Ti
        plume.set_data([r[k, 1], tail_pt[1]], [r[k, 2], tail_pt[2]])
        plume.set_3d_properties([r[k, 0], tail_pt[0]])
        ax.set_title(f"t = {sigma * k / max(K - 1, 1):.2f} / {sigma:.2f}")
        return trail, body, plume

    anim = animation.FuncAnimation(fig, frame, frames=K, blit=False)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return anim
