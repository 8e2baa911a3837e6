"""BAL (Bundle Adjustment in the Large) problem files, and stand-in problems
at the published BAL counts of cameras, points and observations.

Counterpart of ``tpu_ba/io/bal.py``. The file format::

    <num_cameras> <num_points> <num_observations>
    <cam_idx> <pt_idx> <x> <y>          # × num_observations
    <camera params, 9 lines each>        # aa(3), t(3), f, k1, k2
    <point coords, 3 lines each>

``load_bal`` parses one (plain text through the native parser of
``io/native.py`` by default, ``.gz`` or ``use_native=False`` through the
Python tokenizer), ``save_bal`` writes the same bytes as the reference's,
``normalize_bal`` centres and scales a scene, ``find_bal_file`` looks one up.

``make_bal_like_problem`` synthesizes the stand-ins, with the reference's
two covisibility structures: ``covis="ring"``, cameras along a closed vehicle
loop, points in a band around it, each point seen by a window of nearby
cameras (the Ladybug structure: camera covisibility collapses to a few index
offsets); and ``covis="community"``, a photo collection of a landmark, as
real BAL Trafalgar and Venice are (``_community_scene``: no structure in the
camera order, far more than 32 distinct index offsets). Numpy drawn from
``np.random.default_rng(seed)`` in the reference's order, so both packages
generate byte-identical problems; the ``data/cache/*.npz`` cache uses the
reference's key and format, so either package's cache serves the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_ba_torch.core import BAProblem, make_problem, resolve_device, to_host
from tpu_ba_torch.io.synthetic import (_cross_np, _look_at_rotation,
                                       _matrix_to_aa_np, _project_bal_np)

# (n_cameras, n_points, n_observations) of the canonical BAL problems
BAL_DATASET_DIMS = {
    "ladybug-49": (49, 7776, 31843),
    "ladybug-1723": (1723, 156502, 678718),
    "trafalgar-257": (257, 65132, 225911),
    "venice-1778": (1778, 993923, 5001946),
}


# rows formatted per write by save_bal: bounds the Python objects alive at once
_SAVE_ROWS = 1 << 16


def load_bal(path: str, *, dtype=torch.float32, pad_multiple: int = 1024,
             normalize: bool = False, use_native: bool = True, device=None) -> BAProblem:
    """Parse a BAL text file (optionally gzipped) into a BAProblem on
    ``device`` (default: the CUDA card, see ``resolve_device``). Plain text
    goes through the native parser unless ``use_native`` is false; a
    ``.gz`` file through the Python tokenizer, the oracle."""
    if use_native and not path.endswith(".gz"):
        from tpu_ba_torch.io.native import parse_bal_native

        cams, pts, obs_2d, cam_idx, pt_idx = parse_bal_native(path)
    else:
        if path.endswith(".gz"):
            import gzip

            with gzip.open(path, "rt") as fh:
                text = fh.read()
        else:
            with open(path) as fh:
                text = fh.read()
        vals = np.array(text.split(), dtype=np.float64)
        n_cams, n_pts, n_obs = int(vals[0]), int(vals[1]), int(vals[2])
        off = 3
        obs_block = vals[off: off + 4 * n_obs].reshape(n_obs, 4)
        off += 4 * n_obs
        cams = vals[off: off + 9 * n_cams].reshape(n_cams, 9)
        off += 9 * n_cams
        pts = vals[off: off + 3 * n_pts].reshape(n_pts, 3)
        cam_idx = obs_block[:, 0].astype(np.int32)
        pt_idx = obs_block[:, 1].astype(np.int32)
        obs_2d = obs_block[:, 2:4]
    if normalize:
        cams, pts = normalize_bal(cams, pts)
    return make_problem(cams, pts, obs_2d, cam_idx, pt_idx, model="bal", dtype=dtype,
                        pad_multiple=pad_multiple, device=device)


def _write_rows(fh, fmt: str, rows: np.ndarray) -> None:
    """``fmt`` applied to each row of ``rows``, a block of rows per write."""
    for i in range(0, rows.shape[0], _SAVE_ROWS):
        block = rows[i:i + _SAVE_ROWS]
        fh.write((fmt * block.shape[0]) % tuple(block.ravel().tolist()))


def save_bal(path: str, problem: BAProblem) -> None:
    """Write a BAProblem (unpadded part) in BAL text format: the bytes
    ``tpu_ba.io.bal.save_bal`` writes, every value in ``%.16e`` of its f64
    value (which an f32 value survives a parse and rounding back)."""
    n_obs = problem.n_obs
    obs = np.empty((n_obs, 4), np.float64)       # indices are exact in f64
    obs[:, 0] = to_host(problem.cam_idx[:n_obs])
    obs[:, 1] = to_host(problem.pt_idx[:n_obs])
    obs[:, 2:] = to_host(problem.obs_2d[:n_obs])
    with open(path, "w") as fh:
        fh.write(f"{problem.n_cameras} {problem.n_points} {n_obs}\n")
        _write_rows(fh, "%d %d %.16e %.16e\n", obs)
        for params in (problem.cameras, problem.points):
            _write_rows(fh, "%.16e\n", to_host(params).astype(np.float64).reshape(-1, 1))


def normalize_bal(cams, pts):
    """Center/scale the scene for f32 conditioning: the point cloud's median
    to the origin and its median absolute deviation (L1 over the axes) to
    100, the standard BAL normalization. The camera translations follow, so
    reprojections are unchanged: X' = s(X − m), t' = s(t + R m), since the
    projection divides out a global scale. Numpy in, numpy out."""
    cams = to_host(cams).copy()
    pts = to_host(pts).copy()
    med = np.median(pts, axis=0)
    dev = np.median(np.abs(pts - med).sum(axis=1))
    scale = 100.0 / max(dev, 1e-12)
    aa = cams[:, 0:3]                               # Rodrigues, all cameras at once
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    k = aa / np.where(theta < 1e-12, 1.0, theta)
    medb = np.broadcast_to(med, aa.shape)
    ct, st = np.cos(theta), np.sin(theta)
    Rmed = medb * ct + _cross_np(k, medb) * st + k * (k @ med)[:, None] * (1.0 - ct)
    Rmed = np.where(theta < 1e-12, medb, Rmed)
    cams[:, 3:6] = scale * (cams[:, 3:6] + Rmed)
    pts = scale * (pts - med)
    return cams, pts


def find_bal_file(name: str, search_dirs=("data",)) -> str | None:
    """The path of BAL problem ``name`` (``problem-<name>.txt[.gz]`` or
    ``<name>.txt[.gz]``) in the first of ``search_dirs`` that has it, or
    None."""
    candidates = [f"problem-{name}.txt", f"problem-{name}.txt.gz", f"{name}.txt",
                  f"{name}.txt.gz"]
    for d in search_dirs:
        for c in candidates:
            p = os.path.join(d, c)
            if os.path.exists(p):
                return p
    return None


def make_bal_like_problem(
    name: str,
    *,
    pixel_noise: float = 1.0,
    cam_perturb: float = 0.02,
    point_perturb: float = 0.05,
    intrinsics_perturb: float = 0.0,
    outlier_frac: float = 0.0,
    seed: int = 0,
    dtype=torch.float32,
    pad_multiple: int = 1024,
    covis: str = "ring",
    device=None,
):
    """Synthesize the stand-in for BAL problem ``name`` with covisibility
    ``covis`` ("ring" or "community") and its exact observation count.
    Returns (problem, ground_truth dict). The cache lives under
    ``data/cache/`` relative to the working directory."""
    device = resolve_device(device)
    if name not in BAL_DATASET_DIMS:
        raise KeyError(f"unknown BAL stand-in {name!r}; have {sorted(BAL_DATASET_DIMS)}")
    if covis not in ("ring", "community"):
        raise ValueError(f"covis must be 'ring' or 'community', got {covis!r}")
    n_cams, n_pts, n_obs = BAL_DATASET_DIMS[name]

    ctag = "" if covis == "ring" else f"_{covis}"
    cache_key = (f"balstandin_{name}{ctag}_s{seed}_n{pixel_noise}_c{cam_perturb}"
                 f"_p{point_perturb}_i{intrinsics_perturb}_o{outlier_frac}")
    cache_path = os.path.join("data", "cache", cache_key + ".npz")
    if os.path.exists(cache_path):
        z = np.load(cache_path)
        problem = make_problem(
            z["cams0"], z["points0"], z["obs"], z["cam_idx"], z["pt_idx"],
            model="bal", dtype=dtype, pad_multiple=pad_multiple, device=device)
        ground_truth = {"cameras": z["cams_gt"], "points": z["points_gt"],
                        "pixel_noise": pixel_noise, "n_obs": int(z["cam_idx"].shape[0])}
        return problem, ground_truth

    rng = np.random.default_rng(seed)
    finish = dict(pixel_noise=pixel_noise, cam_perturb=cam_perturb, point_perturb=point_perturb,
                  intrinsics_perturb=intrinsics_perturb, outlier_frac=outlier_frac, dtype=dtype,
                  pad_multiple=pad_multiple, device=device)

    if covis == "community":
        cams_gt, points_gt, cam_idx, pt_idx = _community_scene(rng, n_cams, n_pts, n_obs)
        return _finish_bal_like(rng, cams_gt, points_gt, cam_idx, pt_idx, cache_path, **finish)

    # trajectory: closed loop of radius R with lateral wobble
    s = 2 * np.pi * np.arange(n_cams) / n_cams
    R_loop = 30.0
    centers = np.stack(
        [R_loop * np.cos(s), 0.2 * rng.standard_normal(n_cams), R_loop * np.sin(s)],
        axis=-1,
    )

    # points scattered in an annulus around the loop, biased outward
    ang = 2 * np.pi * rng.random(n_pts)
    rad = R_loop + rng.normal(8.0, 3.0, n_pts)
    height = rng.normal(1.0, 2.0, n_pts)
    points_gt = np.stack([rad * np.cos(ang), height, rad * np.sin(ang)], axis=-1)

    cams_gt = np.zeros((n_cams, 9))
    for i in range(n_cams):
        # look outward from the loop at the point band
        target = centers[i] * np.array([1.3, 0.0, 1.3])
        Rm = _look_at_rotation(centers[i], target)
        cams_gt[i, 0:3] = _matrix_to_aa_np(Rm)
        cams_gt[i, 3:6] = -Rm @ centers[i]
        cams_gt[i, 6] = 400.0 * (1.0 + 0.05 * rng.standard_normal())
        cams_gt[i, 7] = -1e-7 * rng.random()
        cams_gt[i, 8] = 1e-13 * rng.random()

    # visibility: candidate cameras in an angular window around each point,
    # kept where the point is in front of the camera (−z) at a sane pixel
    pt_ang = np.arctan2(points_gt[:, 2], points_gt[:, 0])
    cam_ang = np.arctan2(centers[:, 2], centers[:, 0])
    k_target = max(int(np.ceil(n_obs / n_pts)), 2)
    k_window = min(n_cams, 2 * k_target + 4)
    cam_order = np.argsort(cam_ang)
    nearest_pos = np.searchsorted(cam_ang[cam_order], pt_ang) % n_cams
    offsets = np.arange(k_window) - k_window // 2
    window = cam_order[(nearest_pos[:, None] + offsets[None, :]) % n_cams]  # (P, k)

    cand_cam = window.reshape(-1).astype(np.int32)
    cand_pt = np.repeat(np.arange(n_pts, dtype=np.int32), k_window)
    valid = _projects_validly(cams_gt[cand_cam], points_gt[cand_pt], 1500.0)

    # rank candidates per point: valid first, then nearest in window order
    valid_mat = valid.reshape(n_pts, k_window)
    rank = np.argsort(~valid_mat, axis=1, kind="stable")[:, :k_target]  # (P, k_t)
    chosen_valid = np.take_along_axis(valid_mat, rank, axis=1)
    cam_idx = np.take_along_axis(window, rank, axis=1)[chosen_valid].astype(np.int32)
    pt_idx = np.repeat(np.arange(n_pts, dtype=np.int32), k_target).reshape(
        n_pts, k_target)[chosen_valid]

    cam_idx, pt_idx = _match_observation_count(rng, cam_idx, pt_idx, n_obs)
    return _finish_bal_like(rng, cams_gt, points_gt, cam_idx, pt_idx, cache_path, **finish)


def _projects_validly(cams, pts, max_pixel: float):
    """Per (camera, point) row: the point lies in front of the camera (BAL
    looks down −z) and projects within ``max_pixel`` of the centre."""
    aa, t = cams[:, 0:3], cams[:, 3:6]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    k_ax = aa / np.where(theta < 1e-12, 1.0, theta)
    c, s = np.cos(theta), np.sin(theta)
    P = (pts * c + _cross_np(k_ax, pts) * s
         + k_ax * np.sum(k_ax * pts, 1, keepdims=True) * (1 - c) + t)
    uv = _project_bal_np(cams, pts)
    return (P[:, 2] < -1.0) & (np.abs(uv) < max_pixel).all(axis=1)


def _finish_bal_like(rng, cams_gt, points_gt, cam_idx, pt_idx, cache_path, *, pixel_noise,
                     cam_perturb, point_perturb, intrinsics_perturb, outlier_frac, dtype,
                     pad_multiple, device):
    """Shared tail of the stand-in generators: project, add noise and
    outliers, perturb the initial estimate, cache, build the BAProblem."""
    n_cams, n_pts = cams_gt.shape[0], points_gt.shape[0]
    obs = _project_bal_np(cams_gt[cam_idx], points_gt[pt_idx])
    obs += pixel_noise * rng.standard_normal(obs.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * obs.shape[0])
        out_idx = rng.choice(obs.shape[0], n_out, replace=False)
        obs[out_idx] += rng.normal(0.0, 40.0, (n_out, 2))  # gross outliers

    cams0 = cams_gt.copy()
    cams0[:, 0:3] += cam_perturb * rng.standard_normal((n_cams, 3))
    cams0[:, 3:6] += cam_perturb * 5.0 * rng.standard_normal((n_cams, 3))
    if intrinsics_perturb > 0:
        cams0[:, 6] *= 1.0 + intrinsics_perturb * rng.standard_normal(n_cams)
        cams0[:, 7] = 0.0  # start distortion from zero: must be re-estimated
        cams0[:, 8] = 0.0
    points0 = points_gt + point_perturb * rng.standard_normal((n_pts, 3))

    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    np.savez_compressed(
        cache_path, cams0=cams0, points0=points0, obs=obs,
        cam_idx=cam_idx, pt_idx=pt_idx, cams_gt=cams_gt, points_gt=points_gt,
    )

    problem = make_problem(cams0, points0, obs, cam_idx, pt_idx, model="bal",
                           dtype=dtype, pad_multiple=pad_multiple, device=device)
    ground_truth = {"cameras": cams_gt, "points": points_gt,
                    "pixel_noise": pixel_noise, "n_obs": int(cam_idx.shape[0])}
    return problem, ground_truth


def _match_observation_count(rng, cam_idx, pt_idx, n_obs: int):
    """Trim extras or duplicate valid pairs to the exact observation count."""
    total = cam_idx.shape[0]
    if total > n_obs:
        keep = rng.permutation(total)[:n_obs]
        keep.sort()
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]
    elif total < n_obs:
        extra = rng.integers(0, total, n_obs - total)
        cam_idx = np.concatenate([cam_idx, cam_idx[extra]])
        pt_idx = np.concatenate([pt_idx, pt_idx[extra]])
    return cam_idx, pt_idx


def _community_scene(rng, n_cams: int, n_pts: int, n_obs: int):
    """Community-photo-collection scene: the covisibility of real BAL
    Trafalgar and Venice (unordered photos of a landmark).

    Plaza model: points on a surrounding wall (an annulus), cameras clustered
    at Zipf-weighted hotspots inside the plaza, each looking outward at a
    random wall bearing. A point's observers are sampled from the cameras
    whose view cone covers it, weighted by a per-camera Zipf popularity:
    power-law camera degrees, covisible pairs spread over the whole
    angular-overlap graph. Camera ids are shuffled at the end, so index order
    carries no structure and the distinct index offsets number about
    ``n_cams``, not ≤ 32: no banded or track layout applies. The random
    stream is the reference's, draw for draw."""
    R_wall = 30.0
    ang_p = 2 * np.pi * rng.random(n_pts)
    rad_p = np.maximum(rng.normal(R_wall, 3.0, n_pts), 10.0)
    height = rng.normal(1.0, 2.0, n_pts)
    points_gt = np.stack([rad_p * np.cos(ang_p), height, rad_p * np.sin(ang_p)], axis=-1)

    # cameras: hotspot-clustered positions inside the plaza
    n_hot = max(8, n_cams // 40)
    hot_ang = 2 * np.pi * rng.random(n_hot)
    hot_rad = 10.0 * np.sqrt(rng.random(n_hot))
    hot_xy = np.stack([hot_rad * np.cos(hot_ang), hot_rad * np.sin(hot_ang)], axis=-1)
    hot_w = (1.0 + np.arange(n_hot)) ** -1.1
    hot_w = rng.permutation(hot_w / hot_w.sum())
    cam_hot = rng.choice(n_hot, n_cams, p=hot_w)
    pos = np.stack([
        hot_xy[cam_hot, 0] + 1.5 * rng.standard_normal(n_cams),
        0.3 * rng.standard_normal(n_cams),
        hot_xy[cam_hot, 1] + 1.5 * rng.standard_normal(n_cams),
    ], axis=-1)
    # each camera photographs a random wall bearing
    view_ang = 2 * np.pi * rng.random(n_cams)

    cams_gt = np.zeros((n_cams, 9))
    targets = np.stack([R_wall * np.cos(view_ang), np.zeros(n_cams),
                        R_wall * np.sin(view_ang)], axis=-1)
    for i in range(n_cams):
        Rm = _look_at_rotation(pos[i], targets[i])
        cams_gt[i, 0:3] = _matrix_to_aa_np(Rm)
        cams_gt[i, 3:6] = -Rm @ pos[i]
        cams_gt[i, 6] = 400.0 * (1.0 + 0.05 * rng.standard_normal())
        cams_gt[i, 7] = -1e-7 * rng.random()
        cams_gt[i, 8] = 1e-13 * rng.random()

    # per-camera Zipf popularity (a few photos dominate)
    pop = (1.0 + np.arange(n_cams)) ** -0.9
    pop = rng.permutation(pop / pop.sum())

    # candidates by angular visibility, in wall-bearing bins: a camera with
    # view angle φ covers the bearings within ±half_fov of φ
    half_fov = np.deg2rad(50.0)
    n_bins = 720
    bin_of_pt = np.minimum((ang_p / (2 * np.pi) * n_bins).astype(np.int64), n_bins - 1)
    k_target = max(int(np.ceil(n_obs / n_pts)) + 1, 2)

    cand_cam = np.zeros((n_pts, k_target), np.int64)
    bin_centers = (np.arange(n_bins) + 0.5) * 2 * np.pi / n_bins
    for b in range(n_bins):
        pts_b = np.nonzero(bin_of_pt == b)[0]
        if pts_b.size == 0:
            continue
        d = np.abs((view_ang - bin_centers[b] + np.pi) % (2 * np.pi) - np.pi)
        elig = np.nonzero(d < half_fov)[0]
        if elig.size == 0:
            elig = np.argsort(d)[:8]
        # Gumbel top-k: weighted sampling without replacement per point
        g = np.log(pop[elig])[None, :] + rng.gumbel(size=(pts_b.size, elig.size))
        kk = min(k_target, elig.size)
        top = np.argpartition(-g, kk - 1, axis=1)[:, :k_target]
        chosen = elig[top[:, :kk]]
        if kk < k_target:  # repeat the last choice; validity sorts out duplicates
            chosen = np.concatenate(
                [chosen, np.broadcast_to(chosen[:, -1:], (pts_b.size, k_target - kk))], axis=1)
        cand_cam[pts_b] = chosen

    # validity by actual projection
    cand_pt = np.repeat(np.arange(n_pts, dtype=np.int64), k_target)
    valid = _projects_validly(cams_gt[cand_cam.reshape(-1)], points_gt[cand_pt], 800.0)
    valid_mat = valid.reshape(n_pts, k_target)
    rank = np.argsort(~valid_mat, axis=1, kind="stable")
    chosen_valid = np.take_along_axis(valid_mat, rank, axis=1)
    cam_idx = np.take_along_axis(cand_cam, rank, axis=1)[chosen_valid]
    pt_idx = np.broadcast_to(np.arange(n_pts, dtype=np.int64)[:, None],
                             (n_pts, k_target))[chosen_valid]
    cam_idx, pt_idx = _match_observation_count(rng, cam_idx, pt_idx, n_obs)

    # shuffle camera ids: index order must carry no spatial structure
    relabel = rng.permutation(n_cams)
    cams_gt = cams_gt[np.argsort(relabel)]
    cam_idx = relabel[cam_idx]
    return cams_gt, points_gt, cam_idx.astype(np.int32), pt_idx.astype(np.int32)
