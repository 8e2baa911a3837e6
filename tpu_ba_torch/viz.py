"""Scene and convergence plots (headless matplotlib).

Counterpart of ``tpu_ba/viz.py``: a 3-D scene of points and camera centres,
measured against reprojected features of one camera, and the cost / λ / CG
histories of a solve. Each function renders to a file with the Agg backend
and returns the path. Tensors on any device are copied to the host;
matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ba_torch.core import to_host
from tpu_ba_torch.geometry.cameras import project_bal
from tpu_ba_torch.geometry.rotations import aa_to_matrix


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _camera_centers(cameras) -> np.ndarray:
    """BAL convention: x_cam = R(aa) @ X + t  ⇒  center = −Rᵀ t."""
    cams = to_host(cameras).astype(np.float64)
    R = aa_to_matrix(torch.from_numpy(cams[:, :3])).numpy()
    return -np.einsum("cij,ci->cj", R, cams[:, 3:6])


def plot_scene(cameras, points, path: str, *, title: str = "scene",
               max_points: int = 20000, elev: float = 20.0,
               azim: float = -60.0) -> str:
    """3-D scatter of the structure and the camera centres."""
    plt = _plt()
    pts = to_host(points)
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points, replace=False)
        pts = pts[sel]
    centers = _camera_centers(cameras)

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c="#4477aa", alpha=0.4,
               label=f"points ({pts.shape[0]})")
    ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=14, c="#cc3311",
               marker="^", label=f"cameras ({centers.shape[0]})")
    # robust axis limits (BA scenes have outliers)
    allp = np.concatenate([pts, centers])
    lo, hi = np.percentile(allp, 2, axis=0), np.percentile(allp, 98, axis=0)
    mid, span = (lo + hi) / 2, float(np.max(hi - lo)) / 2 + 1e-9
    ax.set_xlim(mid[0] - span, mid[0] + span)
    ax.set_ylim(mid[1] - span, mid[1] + span)
    ax.set_zlim(mid[2] - span, mid[2] + span)
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_reprojection(problem, cameras, points, path: str, *,
                      camera: int = 0, title: str | None = None) -> str:
    """Measured against reprojected 2-D features of one camera."""
    plt = _plt()
    ci = to_host(problem.cam_idx)
    sel = np.nonzero((ci == camera) & to_host(problem.mask))[0]
    obs = to_host(problem.obs_2d)[sel].astype(np.float64)
    pts = torch.from_numpy(to_host(points)[to_host(problem.pt_idx)[sel]].astype(np.float64))
    cam = torch.from_numpy(to_host(cameras)[camera].astype(np.float64))
    proj = project_bal(cam, pts).numpy()

    fig, ax = plt.subplots(figsize=(7, 6))
    ax.scatter(obs[:, 0], obs[:, 1], s=10, c="#4477aa", label="measured")
    ax.scatter(proj[:, 0], proj[:, 1], s=10, c="#cc3311", marker="x", label="reprojected")
    for k in range(min(len(sel), 400)):
        ax.plot([obs[k, 0], proj[k, 0]], [obs[k, 1], proj[k, 1]], c="gray", lw=0.4, alpha=0.5)
    err = np.sqrt(((obs - proj) ** 2).sum(-1))
    ax.set_title(title or f"camera {camera}: reprojection "
                          f"(rmse {float(np.sqrt((err**2).mean())):.2f}px)")
    ax.invert_yaxis()
    ax.legend(fontsize=8)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_convergence(result, path: str, *, title: str = "LM convergence") -> str:
    """Cost / λ / CG-iteration histories of an LMResult."""
    plt = _plt()
    cost = to_host(result.cost_history).astype(np.float64)
    lam = to_host(result.lam_history).astype(np.float64)
    cg = to_host(result.cg_history)
    n = int(result.iterations)
    it = np.arange(1, n + 1)

    fig, axes = plt.subplots(3, 1, figsize=(7, 8), sharex=True)
    axes[0].semilogy(it, np.maximum(cost[:n], 1e-30), c="#4477aa")
    axes[0].set_ylabel("cost")
    axes[0].set_title(title)
    axes[1].semilogy(it, np.maximum(lam[:n], 1e-30), c="#cc3311")
    axes[1].set_ylabel("λ")
    axes[2].bar(it, cg[:n], color="#228833")
    axes[2].set_ylabel("CG iters")
    axes[2].set_xlabel("LM iteration (linear solves)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
