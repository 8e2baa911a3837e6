"""Image-sequence input: a synthetic renderer and TUM/KITTI readers.

Counterpart of ``tpu_ba/io/sequences.py``:

* :func:`render_blob_sequence` renders multi-lobe keypoint sprites of a known
  3-D scene along a known trajectory (an SfM ground truth). The scene, the
  trajectory and the noise are the reference's numpy draws in the same
  order; the render is PyTorch on the device.
* :func:`read_tum_sequence` / :func:`read_kitti_sequence` read the real
  formats (TUM rgb.txt + groundtruth.txt; KITTI odometry image_0/times/calib).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_ba_torch.core import resolve_device
from tpu_ba_torch.geometry.rotations import matrix_to_aa, rotate_aa

# lobes rendered per chunk: bounds the (chunk, H, W) temporaries (at 240×320,
# 1,024 lobes are 315 MB each); the chunks' images are added in chunk order
RENDER_CHUNK = 1024


def render_blob_sequence(n_frames: int = 8, n_points: int = 300,
                         H: int = 240, W: int = 320,
                         fx: float = 280.0, fy: float = 280.0,
                         seed: int = 0, blob_sigma: float = 1.2,
                         noise: float = 0.01, device=None):
    """Render a synthetic tracked-keypoint sequence (+z pinhole convention)
    on ``device`` (default: the CUDA card, see ``resolve_device``).

    Returns (frames (F, H, W) float32 numpy in [0, 1], gt) with gt holding
    the true poses (F, 6), points (P, 3) and intrinsics (fx, fy, cx, cy).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cx, cy = W / 2.0, H / 2.0

    # points in a slab in front of the cameras
    points = np.stack([
        rng.uniform(-3.0, 3.0, n_points),
        rng.uniform(-2.2, 2.2, n_points),
        rng.uniform(5.0, 9.0, n_points),
    ], axis=-1)
    # each point renders as a distinctive multi-lobe sprite, so normalized
    # patch descriptors can tell the points apart
    n_lobes = 5
    ring_ang = rng.uniform(0, 2 * np.pi, (n_points, n_lobes))
    ring_rad = rng.uniform(2.2, 3.8, (n_points, n_lobes))
    lobe_off = np.stack([ring_rad * np.cos(ring_ang), ring_rad * np.sin(ring_ang)], -1)
    lobe_off[:, 0, :] = 0.0  # dominant central lobe keeps the corner on-point
    lobe_amp = rng.uniform(0.15, 0.4, (n_points, n_lobes))
    lobe_amp[:, 0] = 1.0

    # sideways arc trajectory looking at the slab center
    target = np.array([0.0, 0.0, 7.0])
    Rs = np.zeros((n_frames, 3, 3))
    centers = np.zeros((n_frames, 3))
    for f in range(n_frames):
        s = (f / max(n_frames - 1, 1) - 0.5)
        center = np.array([3.0 * s, 0.6 * s, 0.4 * np.abs(s)])
        # +z convention: view direction maps to +z ⇒ rows [x, y, +d]
        d = target - center
        d = d / np.linalg.norm(d)
        up = np.array([0.0, 1.0, 0.0])
        x_cam = np.cross(up, d)  # right-handed with +z forward
        x_cam /= np.linalg.norm(x_cam)
        y_cam = np.cross(d, x_cam)
        Rs[f] = np.stack([x_cam, y_cam, d])
        centers[f] = center
    poses = np.zeros((n_frames, 6))
    poses[:, 0:3] = matrix_to_aa(torch.as_tensor(Rs)).numpy()
    poses[:, 3:6] = -np.einsum("fij,fj->fi", Rs, centers)

    # render: sum of per-point sprites at projected locations
    f32 = dict(dtype=torch.float32, device=device)
    pts = torch.as_tensor(points, **f32)
    off = torch.as_tensor(lobe_off.reshape(-1, 2), **f32)            # (P·L, 2)
    amp = torch.as_tensor(lobe_amp.reshape(-1), **f32)               # (P·L,)
    yy, xx = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")

    def render(aa, t):
        P = rotate_aa(aa[None, :], pts) + t[None, :]
        z = torch.clamp(P[:, 2], min=1e-3)
        u = fx * P[:, 0] / z + cx
        v = fy * P[:, 1] / z + cy
        vis = (u > 4) & (u < W - 5) & (v > 4) & (v < H - 5) & (P[:, 2] > 0.5)
        uu = torch.repeat_interleave(u, n_lobes) + off[:, 0]
        vv = torch.repeat_interleave(v, n_lobes) + off[:, 1]
        w = torch.repeat_interleave(vis.to(torch.float32), n_lobes) * amp
        img = torch.zeros((H, W), **f32)
        for a in range(0, uu.shape[0], RENDER_CHUNK):
            sl = slice(a, a + RENDER_CHUNK)
            d2 = (xx[None] - uu[sl, None, None]) ** 2 + (yy[None] - vv[sl, None, None]) ** 2
            img = img + torch.sum(w[sl, None, None] * torch.exp(-d2 / (2 * blob_sigma ** 2)),
                                  dim=0)
        return torch.clamp(img, 0.0, 1.0)

    poses32 = torch.as_tensor(poses, **f32)
    frames = torch.stack([render(poses32[f, 0:3], poses32[f, 3:6])
                          for f in range(n_frames)]).cpu().numpy()
    frames += noise * rng.standard_normal(frames.shape).astype(np.float32)
    frames = np.clip(frames, 0.0, 1.0).astype(np.float32)

    gt = {"poses": poses, "points": points, "K": (fx, fy, cx, cy)}
    return frames, gt


def _read_gray(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32) / 255.0


def read_tum_sequence(root: str, max_frames: int | None = None):
    """Read a TUM RGB-D style sequence directory: ``rgb.txt`` (timestamp
    filename per line) and optional ``groundtruth.txt`` (t tx ty tz qx qy qz
    qw). Returns (frames (F, H, W) float32 grayscale, gt dict)."""
    entries = []
    with open(os.path.join(root, "rgb.txt")) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, path = line.split()[:2]
            entries.append((float(ts), os.path.join(root, path)))
    if max_frames:
        entries = entries[:max_frames]
    frames = np.stack([_read_gray(p) for _, p in entries])
    gt = {"timestamps": np.asarray([t for t, _ in entries])}
    gt_txt = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_txt):
        rows = []
        with open(gt_txt) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(v) for v in line.split()])
        gt["trajectory"] = np.asarray(rows)  # t tx ty tz qx qy qz qw
    return frames, gt


def read_kitti_sequence(root: str, max_frames: int | None = None):
    """Read a KITTI odometry sequence directory: ``image_0/*.png``,
    ``times.txt``, ``calib.txt`` (P0 row). Returns (frames, gt dict)."""
    img_dir = os.path.join(root, "image_0")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".png"))
    if max_frames:
        names = names[:max_frames]
    frames = np.stack([_read_gray(os.path.join(img_dir, n)) for n in names])
    gt = {}
    times = os.path.join(root, "times.txt")
    if os.path.exists(times):
        gt["timestamps"] = np.loadtxt(times)
    calib = os.path.join(root, "calib.txt")
    if os.path.exists(calib):
        with open(calib) as fh:
            for line in fh:
                if line.startswith("P0:"):
                    P0 = np.asarray([float(v) for v in line.split()[1:]]).reshape(3, 4)
                    gt["K"] = (P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2])
    return frames, gt
