"""Incremental structure-from-motion pipeline.

Counterpart of ``tpu_ba/sfm/incremental.py``: feature detect + match →
two-view init → triangulate → PnP register → windowed/global BA. The frame
loop and the track bookkeeping are numpy on the host (scene growth is data
dependent); detection, matching, both RANSACs, triangulation and the BA run
as PyTorch on the device, the BA through the port's ``solve``
(``schur_pcg``). Arrays cross between the two in the dtypes the reference
gives them (f32 for image-space work and the map, f64 for the poses).

Random state: one CPU ``torch.Generator`` seeded from ``SfMConfig.seed``
draws every RANSAC's index sets, in call order.

Convention bridge: the SfM stages work in +z pinhole normalized coordinates;
BA runs on the BAL model via the D = diag(−1,−1,1) conjugation
(R_bal = D·R, t_bal = D·t, pixels centered at the principal point).

The report's per-stage split (``stage_split``): the port compiles nothing,
so each stage's first call is its ``compile_attr_s`` class (the cold call:
first use of every kernel and allocation) and the rest are warm. The
reference classes a call as compile-bound when it exceeds max(5×median, 1 s),
which puts a stage of one or two calls in the warm class.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_ba_torch.core import LMConfig, make_problem, resolve_device
from tpu_ba_torch.geometry.rotations import aa_to_matrix, matrix_to_aa
from tpu_ba_torch.residuals.reprojection import residuals_bal
from tpu_ba_torch.sfm.features import describe_patches, detect_harris
from tpu_ba_torch.sfm.matching import match_descriptors
from tpu_ba_torch.sfm.pnp import pnp_ransac
from tpu_ba_torch.sfm.triangulate import triangulate_pairwise
from tpu_ba_torch.sfm.twoview import decompose_essential, estimate_essential_ransac
from tpu_ba_torch.solver.lm import solve

_D_FLIP = np.diag([-1.0, -1.0, 1.0])


@dataclasses.dataclass
class SfMConfig:
    max_corners: int = 512
    ransac_hypotheses: int = 2048
    essential_thresh: float = 5e-6     # squared Sampson dist, normalized coords (~0.6px)
    pnp_thresh: float = 2e-4           # squared reproj, normalized coords (~4px)
    min_pnp_inliers: int = 8
    ba_window: int = 6                 # windowed BA over the last N frames
    ba_iters: int = 8
    final_ba_iters: int = 30
    seed: int = 0


@dataclasses.dataclass
class SfMResult:
    poses: np.ndarray          # (F, 6) [aa, t] +z pinhole convention
    points: np.ndarray         # (P, 3)
    track_frame: np.ndarray    # (O,) frame index per observation
    track_point: np.ndarray    # (O,) point index per observation
    track_xy: np.ndarray       # (O, 2) pixel observation
    registered: np.ndarray     # (F,) bool
    final_cost: float
    report: dict


def _normalize(xy, K):
    fx, fy, cx, cy = K
    return (xy - np.array([cx, cy])) / np.array([fx, fy])


def _aa_to_matrix_np(aa):
    return aa_to_matrix(torch.as_tensor(np.asarray(aa))).numpy()


def _matrix_to_aa_np(R):
    return matrix_to_aa(torch.as_tensor(np.asarray(R))).numpy()


def _to_bal_camera(aa, t, f):
    """(+z pinhole pose, focal) → 9-param BAL camera (k1=k2=0)."""
    Rb = _D_FLIP @ _aa_to_matrix_np(aa)
    tb = _D_FLIP @ np.asarray(t)
    return np.concatenate([_matrix_to_aa_np(Rb), tb, [f, 0.0, 0.0]])


def _from_bal_camera(cam):
    R = _D_FLIP @ _aa_to_matrix_np(cam[0:3])
    t = _D_FLIP @ cam[3:6]
    return _matrix_to_aa_np(R), t


def _bal_residuals(cams, pts, uv, ci, pi, device):
    """Residuals (O, 2) of the BAL model in f32 on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    return residuals_bal(torch.as_tensor(cams, **f32), torch.as_tensor(pts, **f32),
                         torch.as_tensor(uv, **f32),
                         torch.as_tensor(ci, dtype=torch.int64, device=device),
                         torch.as_tensor(pi, dtype=torch.int64, device=device))


def _bundle_adjust(poses, points, obs_f, obs_p, obs_xy, K, frames_subset,
                   iters, registered, device, prune_px: float = 6.0):
    """Run BA over the given frame subset (and the points they see).

    Returns updated (poses, points, keep) with ``keep`` (O,) False on the
    observations pruned as gross outliers (> ``prune_px`` after the solve).
    """
    fx, fy, cx, cy = K
    f_avg = 0.5 * (fx + fy)
    sel = np.isin(obs_f, frames_subset) & registered[obs_f]
    if sel.sum() < 12:
        return poses, points, np.ones(obs_f.shape[0], bool)
    fsub = np.asarray(sorted(set(obs_f[sel].tolist())))
    fmap = {f: i for i, f in enumerate(fsub)}
    psub = np.asarray(sorted(set(obs_p[sel].tolist())))
    pmap = {p: i for i, p in enumerate(psub)}

    cams = np.stack([_to_bal_camera(poses[f, 0:3], poses[f, 3:6], f_avg) for f in fsub])
    pts = points[psub]
    ci = np.asarray([fmap[f] for f in obs_f[sel]], np.int32)
    pi = np.asarray([pmap[p] for p in obs_p[sel]], np.int32)
    uv = (obs_xy[sel] - np.array([cx, cy]))  # centered pixels

    # model="pinhole": K is known, so solve() freezes the intrinsic columns
    # (6, 7, 8) exactly and the BA optimizes fixed-K pinhole cameras
    problem = make_problem(cams.astype(np.float32), pts.astype(np.float32),
                           uv.astype(np.float32), ci, pi,
                           pad_multiple=1024, model="pinhole", device=device)
    cfg = LMConfig(max_iters=iters, linear_solver="schur_pcg",
                   cg_max_iters=50, cg_tol=1e-3, init_lambda=1e-3,
                   robust_kind=1, robust_scale=2.0)  # Huber, ~2px
    res = solve(problem, cfg)
    new_cams = res.cameras.cpu().numpy().astype(np.float64)
    new_pts = res.points.cpu().numpy().astype(np.float64)

    for f in fsub:
        aa, t = _from_bal_camera(new_cams[fmap[f]])
        poses[f, 0:3] = aa
        poses[f, 3:6] = t
    points[psub] = new_pts

    # prune gross-outlier observations (wrong associations poison later BA)
    r = _bal_residuals(new_cams, new_pts, uv, ci, pi, device).cpu().numpy()
    bad_local = np.sum(r * r, axis=1) > prune_px ** 2
    keep = np.ones(obs_f.shape[0], bool)
    keep[np.where(sel)[0][bad_local]] = False
    return poses, points, keep


def run_incremental_sfm(frames, K, config: SfMConfig | None = None, *,
                        device=None) -> SfMResult:
    """Full incremental SfM on a grayscale image sequence.

    frames: (F, H, W) float array; K: (fx, fy, cx, cy); runs on ``device``
    (default: the CUDA card, see ``resolve_device``).
    """
    device = resolve_device(device)
    cfg = config or SfMConfig()
    F = frames.shape[0]
    gen = torch.Generator().manual_seed(cfg.seed)
    f32 = dict(dtype=torch.float32, device=device)

    def dev32(a):
        return torch.as_tensor(np.array(a), **f32)    # a copy: broadcast views are read-only

    def host(t):
        return t.cpu().numpy()

    # per-call wall time of each pipeline stage (report["stage_s"], ["stage_split"])
    stage_calls: dict = {}
    t_last = [time.perf_counter()]

    def tick(stage: str):
        now = time.perf_counter()
        stage_calls.setdefault(stage, []).append(now - t_last[0])
        t_last[0] = now

    # 1. detect + describe all frames
    kps, scores, descs = [], [], []
    for f in range(F):
        img = dev32(frames[f])
        xy, sc = detect_harris(img, max_corners=cfg.max_corners)
        descs.append(describe_patches(img, xy))
        kps.append(host(xy))
        scores.append(sc)
        tick("detect_describe")

    # 2. match consecutive frames
    matches = []  # per pair: (idx2 (K,), valid (K,))
    for f in range(F - 1):
        idx2, val = match_descriptors(descs[f], descs[f + 1], scores[f], scores[f + 1])
        matches.append((host(idx2), host(val)))
        tick("match")

    # 3. two-view initialization from frames (0, 1)
    idx2, val = matches[0]
    x1 = _normalize(kps[0], K)
    x2 = _normalize(kps[1][idx2], K)
    x1_d, x2_d = dev32(x1), dev32(x2)
    E, inl, n_inl = estimate_essential_ransac(
        gen, x1_d, x2_d, torch.as_tensor(val, device=device),
        n_hypotheses=cfg.ransac_hypotheses, inlier_thresh=cfg.essential_thresh)
    R1, t1, _ = decompose_essential(E, x1_d, x2_d, inl)
    R1, t1, inl = host(R1), host(t1), host(inl)

    poses = np.zeros((F, 6))
    registered = np.zeros(F, bool)
    registered[0] = registered[1] = True
    poses[1, 0:3] = _matrix_to_aa_np(R1)
    poses[1, 3:6] = t1

    # triangulate the inlier matches of the init pair
    eye34 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    P2 = np.concatenate([R1, t1[:, None]], axis=1)
    sel = np.where(inl)[0]
    X = host(triangulate_pairwise(dev32(np.broadcast_to(eye34, (len(sel), 3, 4))),
                                  dev32(np.broadcast_to(P2, (len(sel), 3, 4))),
                                  dev32(x1[sel]), dev32(x2[sel])))
    depth_ok = (X[:, 2] > 1e-3) & (X @ R1[2] + t1[2] > 1e-3) & np.isfinite(X).all(1)
    sel = sel[depth_ok]
    X = X[depth_ok]

    # the map lives in flat numpy arrays — pts_arr (P, 3), desc_arr (P, D) —
    # grown per frame; kp2pt[f, k] = point id of keypoint k in frame f
    # (−1 = none); observations grow in array chunks
    pts_arr = np.asarray(X)
    kp2pt = np.full((F, cfg.max_corners), -1, np.int64)
    obs_f, obs_p, obs_xy = [], [], []   # lists of chunk arrays
    descs_np = [host(d) for d in descs]
    n0 = len(sel)
    kp2pt[0, sel] = np.arange(n0)
    kp2pt[1, idx2[sel]] = np.arange(n0)
    obs_f.append(np.repeat(np.arange(2), n0))
    obs_p.append(np.tile(np.arange(n0), 2))
    obs_xy.append(np.concatenate([kps[0][sel], kps[1][idx2[sel]]]))
    desc_arr = np.asarray(descs_np[1][idx2[sel]], np.float32)

    report = {"init_inliers": int(n_inl), "init_points": int(pts_arr.shape[0]), "pnp": []}
    tick("two_view_init")

    # 4. incremental registration
    for f in range(2, F):
        idx2, val = matches[f - 1]
        # 2D-3D correspondences: match the map's point descriptors directly
        # against this frame's descriptors (robust to broken frame chains)
        map_cap = cfg.max_corners * 8
        n_map = min(desc_arr.shape[0], map_cap)
        map_lo = desc_arr.shape[0] - n_map    # most recent points win
        Dmap = np.zeros((map_cap, descs_np[0].shape[1]), np.float32)
        Dmap[:n_map] = desc_arr[map_lo:]
        map_score = np.full(map_cap, -1.0, np.float32)
        map_score[:n_map] = 1.0
        m_idx2, m_val = match_descriptors(dev32(Dmap), descs[f], dev32(map_score), scores[f],
                                          ratio=0.85)
        m_idx2, m_val = host(m_idx2), host(m_val)
        # point-id → keypoint map as a flat array: map matches first, then
        # chain correspondences through frame f-1's tracks override them
        # (adjacent-frame matches are the cleanest)
        corr_arr = np.full(pts_arr.shape[0], -1, np.int64)
        sel_m = np.nonzero(m_val[:n_map])[0]
        corr_arr[map_lo + sel_m] = m_idx2[sel_m]
        prev_pids = kp2pt[f - 1]
        chain = np.nonzero(val & (prev_pids >= 0))[0]
        corr_arr[prev_pids[chain]] = idx2[chain]
        c3d = np.nonzero(corr_arr >= 0)[0]
        c2d = corr_arr[c3d]
        tick("map_match")
        if len(c3d) < cfg.min_pnp_inliers:
            report["pnp"].append({"frame": f, "registered": False,
                                  "reason": f"only {len(c3d)} 2d-3d"})
            continue
        Xc = pts_arr[c3d]
        xc = _normalize(kps[f][np.asarray(c2d)], K)
        # pad to the fixed RANSAC shape
        Kmax = cfg.max_corners
        Xp = np.zeros((Kmax, 3)); Xp[: len(c3d)] = Xc
        xp = np.zeros((Kmax, 2)); xp[: len(c3d)] = xc
        vp = np.zeros(Kmax, bool); vp[: len(c3d)] = True
        aa, t, inl_p, n_in = pnp_ransac(
            gen, dev32(Xp), dev32(xp), torch.as_tensor(vp, device=device),
            n_hypotheses=cfg.ransac_hypotheses, inlier_thresh=cfg.pnp_thresh)
        n_in = int(n_in)
        tick("pnp_ransac")
        if n_in < cfg.min_pnp_inliers:
            report["pnp"].append({"frame": f, "registered": False,
                                  "reason": f"{n_in} pnp inliers"})
            continue
        poses[f, 0:3], poses[f, 3:6] = host(aa), host(t)
        registered[f] = True
        inl_p = host(inl_p)

        # record observations of matched existing points in frame f; refresh
        # the point's descriptor to its freshest appearance
        inliers = np.nonzero(inl_p[: len(c3d)])[0]
        pid_in = c3d[inliers]
        k_in = c2d[inliers]
        kp2pt[f, k_in] = pid_in
        obs_f.append(np.full(len(pid_in), f))
        obs_p.append(pid_in)
        obs_xy.append(kps[f][k_in])
        desc_arr[pid_in] = descs_np[f][k_in]

        # triangulate brand-new tracks between frame f-1 (consecutive matches
        # only exist for it) and f
        prev_f = f - 1
        if registered[prev_f]:
            fresh = val & (kp2pt[prev_f] < 0) & (kp2pt[f, idx2] < 0)
            new_prev = np.nonzero(fresh)[0]
            new_cur = idx2[fresh].astype(np.int64)
            if new_prev.size:
                Ra = _aa_to_matrix_np(poses[prev_f, 0:3])
                Rb_ = _aa_to_matrix_np(poses[f, 0:3])
                Pa = np.concatenate([Ra, poses[prev_f, 3:6][:, None]], 1)
                Pb = np.concatenate([Rb_, poses[f, 3:6][:, None]], 1)
                xa = _normalize(kps[prev_f][new_prev], K)
                xb = _normalize(kps[f][new_cur], K)
                Xn = host(triangulate_pairwise(
                    dev32(np.broadcast_to(Pa, (new_prev.size, 3, 4))),
                    dev32(np.broadcast_to(Pb, (new_prev.size, 3, 4))), dev32(xa), dev32(xb)))
                za = Xn @ Ra[2] + poses[prev_f, 5]
                zb = Xn @ Rb_[2] + poses[f, 5]
                # reprojection gate in both views (normalized coords)
                Pa_c = Xn @ Ra.T + poses[prev_f, 3:6]
                Pb_c = Xn @ Rb_.T + poses[f, 3:6]
                ea = np.sum((Pa_c[:, 0:2] / np.maximum(Pa_c[:, 2:3], 1e-6) - xa) ** 2, 1)
                eb = np.sum((Pb_c[:, 0:2] / np.maximum(Pb_c[:, 2:3], 1e-6) - xb) ** 2, 1)
                gate = (2.0 / (0.5 * (K[0] + K[1]))) ** 2  # ~2px
                ok = (za > 1e-3) & (zb > 1e-3) & np.isfinite(Xn).all(1) \
                    & (np.linalg.norm(Xn, axis=1) < 1e4) & (ea < gate) & (eb < gate)
                oki = np.nonzero(ok)[0]
                if oki.size:
                    pids = pts_arr.shape[0] + np.arange(oki.size)
                    pts_arr = np.concatenate([pts_arr, Xn[oki]])
                    np_prev = new_prev[oki]
                    np_cur = new_cur[oki]
                    kp2pt[prev_f, np_prev] = pids
                    kp2pt[f, np_cur] = pids
                    obs_f.append(np.concatenate([np.full(oki.size, prev_f),
                                                 np.full(oki.size, f)]))
                    obs_p.append(np.tile(pids, 2))
                    obs_xy.append(np.concatenate([kps[prev_f][np_prev], kps[f][np_cur]]))
                    desc_arr = np.concatenate(
                        [desc_arr, np.asarray(descs_np[f][np_cur], np.float32)])

        report["pnp"].append({"frame": f, "registered": True, "inliers": n_in})

        tick("triangulate_book")
        # windowed BA (+ gross-outlier observation pruning)
        window = [w for w in range(max(0, f - cfg.ba_window + 1), f + 1) if registered[w]]
        flat_f = np.concatenate(obs_f)
        flat_p = np.concatenate(obs_p)
        flat_xy = np.concatenate(obs_xy)
        poses, pts_arr, keep = _bundle_adjust(
            poses, pts_arr, flat_f, flat_p, flat_xy, K, np.asarray(window),
            cfg.ba_iters, registered, device)
        obs_f = [flat_f[keep]]
        obs_p = [flat_p[keep]]
        obs_xy = [flat_xy[keep]]
        tick("windowed_ba")

    # 5. final global BA (two rounds: prune then re-solve)
    all_frames = np.where(registered)[0]
    obs_f = np.concatenate(obs_f)
    obs_p = np.concatenate(obs_p)
    obs_xy = np.concatenate(obs_xy)
    for _round in range(2):
        poses, pts_arr, keep = _bundle_adjust(
            poses, pts_arr, obs_f, obs_p, obs_xy, K, all_frames,
            cfg.final_ba_iters, registered, device)
        if keep.all():
            break
        obs_f, obs_p, obs_xy = obs_f[keep], obs_p[keep], obs_xy[keep]

    # final cost
    fx, fy, cx, cy = K
    f_avg = 0.5 * (fx + fy)
    sel = registered[obs_f]
    fsub = {f: i for i, f in enumerate(sorted(set(obs_f[sel].tolist())))}
    cams = np.stack([_to_bal_camera(poses[f, 0:3], poses[f, 3:6], f_avg) for f in fsub])
    ci = np.asarray([fsub[f] for f in obs_f[sel]], np.int32)
    pi = obs_p[sel].astype(np.int32)
    uv = obs_xy[sel] - np.array([cx, cy])
    r = _bal_residuals(cams, pts_arr, uv, ci, pi, device)
    final_cost = float(0.5 * torch.sum(r * r))
    tick("final_ba_and_cost")
    report["n_points"] = int(pts_arr.shape[0])
    report["n_obs"] = len(obs_f)
    report["registered_frames"] = int(registered.sum())
    report["stage_s"] = {k: round(sum(v), 3) for k, v in stage_calls.items()}
    split = {}
    warm_total = cold_total = 0.0
    for k, calls in stage_calls.items():
        warm = calls[1:]
        split[k] = {
            "n": len(calls),
            "median_ms": round(float(np.median(calls)) * 1e3, 2),
            "max_s": round(max(calls), 3),
            "warm_total_s": round(sum(warm), 3),
            "compile_attr_s": round(calls[0], 3),
            "n_compile_class": 1,
        }
        warm_total += sum(warm)
        cold_total += calls[0]
    report["stage_split"] = split
    report["warm_total_s"] = round(warm_total, 3)
    report["compile_attr_s"] = round(cold_total, 3)
    report["warm_s_per_frame"] = round(warm_total / max(F, 1), 3)

    return SfMResult(
        poses=poses, points=pts_arr,
        track_frame=obs_f, track_point=obs_p, track_xy=obs_xy,
        registered=registered, final_cost=final_cost, report=report,
    )
