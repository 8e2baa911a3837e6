"""Feature detection and description — Harris corners + normalized patches.

Counterpart of ``tpu_ba/sfm/features.py``: convolutions and window maxima
over the whole image and a fixed number of corners, on the image's device.
``jax.lax.conv`` (a cross-correlation) is ``F.conv2d``, ``mode="edge"``
padding is ``"replicate"``, and the SAME window maximum with −∞ padding is
``max_pool2d`` (which pads with −∞).

Top-K keeps the reference's order among equal scores: XLA's TopK is stable,
so the −∞ slots of a frame with fewer peaks than corners come in index order.
``torch.topk`` leaves ties in no stated order (and CPU and CUDA differ), so
``top_k_stable`` takes a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k_stable(x, k: int):
    """The k largest entries along the last axis and their indices, ties in
    index order (the order of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _conv(x, k):
    """VALID cross-correlation of a padded (H', W') image with a 2-D kernel."""
    return F.conv2d(x[None, None], k[None, None])[0, 0]


def _sobel(img):
    """Image gradients via 3×3 Sobel. img: (H, W) → (gx, gy)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device) / 8.0
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return _conv(pad, kx), _conv(pad, kx.T.contiguous())


def _box_filter(x, radius: int):
    """Mean filter with (2r+1)² window via two 1-D convs."""
    k = torch.ones(2 * radius + 1, dtype=x.dtype, device=x.device) / (2 * radius + 1)
    xp = F.pad(x[None, None], (0, 0, radius, radius), mode="replicate")[0, 0]
    x1 = _conv(xp, k[:, None])
    xp = F.pad(x1[None, None], (radius, radius, 0, 0), mode="replicate")[0, 0]
    return _conv(xp, k[None, :])


def detect_harris(img, max_corners: int = 512, k: float = 0.04,
                  nms_radius: int = 4, window_radius: int = 2):
    """Harris corner detector with non-max suppression and a fixed top-K.

    img: (H, W) float tensor. Returns (xy (K, 2) [x, y], score (K,)).
    Weak/padded slots have score ≤ 0.
    """
    gx, gy = _sobel(img)
    Ixx = _box_filter(gx * gx, window_radius)
    Iyy = _box_filter(gy * gy, window_radius)
    Ixy = _box_filter(gx * gy, window_radius)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    R = det - k * tr * tr

    # non-max suppression: keep pixels equal to their window max
    w = 2 * nms_radius + 1
    Rmax = F.max_pool2d(R[None, None], w, stride=1, padding=nms_radius)[0, 0]
    is_peak = (R >= Rmax) & (R > 0)
    neg_inf = torch.full_like(R, -torch.inf)
    score = torch.where(is_peak, R, neg_inf)

    # kill a border band (descriptor windows must fit)
    H, W = img.shape
    border = 8
    inside = torch.zeros_like(is_peak)
    inside[border:H - border, border:W - border] = True
    score = torch.where(inside, score, neg_inf)

    top_scores, top_idx = top_k_stable(score.reshape(-1), max_corners)
    ys = top_idx // W
    xs = top_idx % W

    # sub-pixel refinement: quadratic fit of the Harris response around the
    # peak (dx = −0.5 R'/R'' per axis, clamped to ±0.5)
    def offset(rm, rc, rp):
        denom = rm - 2 * rc + rp
        big = torch.abs(denom) > 1e-12
        d = torch.where(big, 0.5 * (rm - rp) / torch.where(big, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
        return torch.clamp(d, -0.5, 0.5)

    rc = R[ys, xs]
    dxs = offset(R[ys, torch.clamp(xs - 1, min=0)], rc, R[ys, torch.clamp(xs + 1, max=W - 1)])
    dys = offset(R[torch.clamp(ys - 1, min=0), xs], rc, R[torch.clamp(ys + 1, max=H - 1), xs])
    xy = torch.stack([xs.to(torch.float32) + dxs, ys.to(torch.float32) + dys], dim=-1)
    return xy, top_scores


def describe_patches(img, xy, patch_radius: int = 4):
    """Normalized intensity-patch descriptors at integer corner locations.

    img: (H, W); xy: (K, 2) → (K, (2r+1)²) zero-mean unit-norm descriptors.
    """
    r = patch_radius
    d = 2 * r + 1
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - r, 0, img.shape[1] - d)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - r, 0, img.shape[0] - d)
    a = torch.arange(d, device=img.device)
    rows = (y0[:, None] + a)[:, :, None]                # (K, d, 1)
    cols = (x0[:, None] + a)[:, None, :]                # (K, 1, d)
    patch = img[rows, cols].reshape(xy.shape[0], -1)
    patch = patch - torch.mean(patch, dim=-1, keepdim=True)
    return patch / (torch.linalg.norm(patch, dim=-1, keepdim=True) + 1e-8)
