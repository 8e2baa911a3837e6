"""The port's SfM front end against ``tpu_ba``'s: Harris corners, patch
descriptors and matching on the reference's rendered frames, triangulation,
the eight-point fit, Sampson distance, the essential decomposition, both
RANSACs given the reference's own draws, PnP's DLT and Gauss-Newton, the
renderer and the TUM / KITTI readers.

The image-space stages run in float64 on both sides, so corner order,
scores and descriptors agree to rounding (1e-12) and the slots beyond the
frame's peaks (score −∞) must come in the same index order. RANSAC draws:
the port's scoring (``essential_from_samples``, ``pnp_from_samples``) is fed
the index sets ``jax.random.choice`` draws from the reference's split keys
(``replay_draws``). SVD null vectors have an arbitrary sign, so E is compared
up to sign.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ba.io.sequences as ref_seq
import tpu_ba.sfm.features as ref_feat
import tpu_ba.sfm.matching as ref_match
import tpu_ba.sfm.pnp as ref_pnp
import tpu_ba.sfm.triangulate as ref_tri
import tpu_ba.sfm.twoview as ref_two
import tpu_ba_torch.io.sequences as seq
import tpu_ba_torch.sfm.features as feat
import tpu_ba_torch.sfm.matching as match
import tpu_ba_torch.sfm.pnp as pnp
import tpu_ba_torch.sfm.triangulate as tri
import tpu_ba_torch.sfm.twoview as two
from tpu_ba.geometry.rotations import aa_to_matrix

from test_sfm import _synthetic_two_view

torch.set_num_threads(1)

TOL = 1e-12


def replay_draws(key, valid, n_hypotheses, sample_size, dtype):
    """The (n_hypotheses, sample_size) index sets the reference's RANSAC
    draws from ``key``: split into one key per hypothesis, then
    ``jax.random.choice`` without replacement, p = valid / Σ valid in the
    dtype of the RANSAC's coordinates."""
    v = jnp.asarray(np.asarray(valid))
    p = v.astype(dtype)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    K = v.shape[0]
    idx = jax.vmap(lambda k: jax.random.choice(k, K, shape=(sample_size,), replace=False, p=p))(
        jax.random.split(key, n_hypotheses))
    return torch.as_tensor(np.array(idx), dtype=torch.int64)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def frames():
    """Two adjacent frames of the reference's renderer, as float64."""
    f, _ = ref_seq.render_blob_sequence(n_frames=3, n_points=80, seed=2)
    return f[:2].astype(np.float64)


@pytest.fixture(scope="module")
def corners(frames):
    out = []
    for img in frames:
        xy, sc = ref_feat.detect_harris(jnp.asarray(img), max_corners=256)
        d = ref_feat.describe_patches(jnp.asarray(img), xy)
        out.append((np.asarray(xy), np.asarray(sc), np.asarray(d)))
    return out


def _harris_close(img, xy_ref, sc_ref, max_corners):
    xy, sc = feat.detect_harris(_t(img), max_corners=max_corners)
    n_peaks = int(np.isfinite(sc_ref).sum())
    np.testing.assert_array_equal(np.isfinite(sc.numpy()), np.isfinite(sc_ref))
    np.testing.assert_allclose(sc.numpy()[:n_peaks], sc_ref[:n_peaks], rtol=TOL)
    # the −∞ slots come in index order: their pixels are the reference's
    np.testing.assert_allclose(xy.numpy(), xy_ref, rtol=0, atol=TOL)
    return n_peaks


def test_harris_matches_reference_padded_slots_included(frames, corners):
    for img, (xy_ref, sc_ref, _) in zip(frames, corners):
        _harris_close(img, xy_ref, sc_ref, 256)
    # a small frame with fewer peaks than slots
    small, _ = ref_seq.render_blob_sequence(n_frames=1, n_points=20, H=60, W=80, seed=5)
    img = small[0].astype(np.float64)
    xy_ref, sc_ref = ref_feat.detect_harris(jnp.asarray(img), max_corners=128)
    n_peaks = _harris_close(img, np.asarray(xy_ref), np.asarray(sc_ref), 128)
    assert 5 < n_peaks < 100


def test_top_k_stable_keeps_index_order_on_ties():
    x = torch.tensor([1.0, -np.inf, 3.0, 3.0, -np.inf, 2.0, -np.inf])
    vals, idx = feat.top_k_stable(x, 6)
    assert idx.tolist() == [2, 3, 5, 0, 1, 4]
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 6)
    assert idx.tolist() == np.asarray(ref_idx).tolist()


def test_describe_patches_matches_reference(frames, corners):
    for img, (xy, _, d_ref) in zip(frames, corners):
        d = feat.describe_patches(_t(img), _t(xy))
        np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=TOL)


def test_match_descriptors_matches_reference(corners):
    (_, s1, d1), (_, s2, d2) = corners
    idx2, valid = match.match_descriptors(_t(d1), _t(d2), _t(s1), _t(s2))
    ref_idx2, ref_valid = ref_match.match_descriptors(*(jnp.asarray(a) for a in (d1, d2, s1, s2)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(ref_idx2))
    assert idx2.dtype == torch.int32 and valid.sum() >= 25
    # the map-matching form: padded map rows (score −1) and the wider ratio
    map_score = np.where(np.arange(256) < 200, 1.0, -1.0)
    idx2, valid = match.match_descriptors(_t(d1), _t(d2), _t(map_score), _t(s2), ratio=0.85)
    ref_idx2, ref_valid = ref_match.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(map_score), jnp.asarray(s2), ratio=0.85)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(ref_idx2))


def _two_view(seed=0, n=100, noise=1e-4, n_bad=12):
    """The reference test's two-view scene with corrupted and invalid rows."""
    X, R, t, x1, x2 = _synthetic_two_view(n=n, seed=seed, noise=noise)
    rng = np.random.default_rng(seed + 100)
    x2 = x2.copy()
    x2[:n_bad] += rng.normal(0, 0.05, (n_bad, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    return X, R, t, x1, x2, valid


def test_triangulation_matches_reference():
    X, R, t, x1, x2 = _synthetic_two_view(noise=1e-4)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    P2 = np.concatenate([R, t[:, None]], 1)
    out = tri.triangulate_points(_t(P1), _t(P2), _t(x1), _t(x2)).numpy()
    ref = np.asarray(ref_tri.triangulate_points(*(jnp.asarray(a) for a in (P1, P2, x1, x2))))
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)
    Pi, Pj = np.broadcast_to(P1, (100, 3, 4)), np.broadcast_to(P2, (100, 3, 4))
    out = tri.triangulate_pairwise(_t(Pi), _t(Pj), _t(x1), _t(x2)).numpy()
    ref = np.asarray(ref_tri.triangulate_pairwise(*(jnp.asarray(a) for a in (Pi, Pj, x1, x2))))
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)


def _same_up_to_sign(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b))
    np.testing.assert_allclose(s * a, b, rtol=0, atol=tol * np.abs(b).max())


def test_eight_point_sampson_and_decompose_match_reference():
    _, R, t, x1, x2, valid = _two_view()
    sel = np.arange(20, 28)
    E = two._eight_point(_t(x1[sel]), _t(x2[sel]))
    E_ref = ref_two._eight_point(jnp.asarray(x1[sel]), jnp.asarray(x2[sel]))
    _same_up_to_sign(E.numpy(), E_ref, 1e-9)
    d = two.sampson_distance(E, _t(x1), _t(x2)).numpy()
    d_ref = np.asarray(ref_two.sampson_distance(E_ref, jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=1e-15)
    inl = _t(d < 1e-4)
    R_e, t_e, n = two.decompose_essential(E, _t(x1), _t(x2), inl)
    R_r, t_r, n_r = ref_two.decompose_essential(E_ref, jnp.asarray(x1), jnp.asarray(x2),
                                                jnp.asarray(inl.numpy()))
    assert int(n) == int(n_r) > 60
    np.testing.assert_allclose(R_e.numpy(), np.asarray(R_r), atol=1e-8)
    np.testing.assert_allclose(t_e.numpy(), np.asarray(t_r), atol=1e-8)


def test_essential_ransac_matches_reference_given_its_draws():
    _, R, t, x1, x2, valid = _two_view(seed=3)
    key = jax.random.PRNGKey(7)
    E_r, inl_r, n_r = ref_two.estimate_essential_ransac(
        key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), n_hypotheses=64,
        inlier_thresh=1e-6)
    idx = replay_draws(key, valid, 64, 8, jnp.float64)
    assert all(set(row) <= set(np.nonzero(valid)[0]) for row in idx.tolist())
    E, inl, n = two.essential_from_samples(idx, _t(x1), _t(x2), _t(valid), inlier_thresh=1e-6)
    assert int(n) == int(n_r) > 70
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_r))
    _same_up_to_sign(E.numpy(), E_r, 1e-8)


def test_sample_index_sets_draw_valid_rows_without_replacement():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[torch.tensor([3, 7, 8, 20, 21, 30, 41, 42, 43, 49])] = True
    g = torch.Generator().manual_seed(0)
    idx = two.sample_index_sets(g, valid, 300, 8)
    assert idx.shape == (300, 8)
    for row in idx.tolist():
        assert len(set(row)) == 8 and all(valid[i] for i in row)
    counts = np.bincount(idx.reshape(-1).numpy(), minlength=50)[valid.numpy()]
    assert counts.min() > 150                  # uniform: 240 each on average
    again = two.sample_index_sets(torch.Generator().manual_seed(0), valid, 300, 8)
    assert torch.equal(idx, again)
    # fewer valid rows than the sample: the valid ones, then invalid in index order
    few = two.sample_index_sets(g, valid[:9], 4, 6)
    assert all(sorted(r[:3]) == [3, 7, 8] and r[3:] == [0, 1, 2] for r in few.tolist())


def _pnp_scene(seed=3, n=120):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)], -1)
    aa = np.array([0.1, -0.2, 0.05])
    t = np.array([0.3, -0.1, 0.5])
    R = np.asarray(aa_to_matrix(jnp.asarray(aa)))
    Xc = X @ R.T + t
    x = Xc[:, 0:2] / Xc[:, 2:3] + 1e-4 * rng.standard_normal((n, 2))
    x[:10] += rng.normal(0, 0.05, (10, 2))
    valid = np.ones(n, bool)
    valid[-4:] = False
    return X, x, valid, aa, t


def test_dlt_and_gauss_newton_match_reference():
    X, x, valid, aa, t = _pnp_scene()
    sel = np.arange(20, 26)
    R, tt = pnp._dlt_pnp(_t(X[sel]), _t(x[sel]))
    R_r, t_r = ref_pnp._dlt_pnp(jnp.asarray(X[sel]), jnp.asarray(x[sel]))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_r), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t_r), atol=1e-9)
    # batched over hypotheses as the RANSAC calls it
    Rb, tb = pnp._dlt_pnp(_t(np.stack([X[sel], X[sel + 30]])), _t(np.stack([x[sel], x[sel + 30]])))
    np.testing.assert_allclose(Rb[0].numpy(), R.numpy(), atol=1e-12)
    w = valid.astype(np.float64)
    w[:10] = 0.0
    a0, t0 = aa + 0.02, t - 0.03
    out = pnp._gn_refine(_t(a0), _t(t0), _t(X), _t(x), _t(w))
    ref = jax.jit(ref_pnp._gn_refine)(*(jnp.asarray(a) for a in (a0, t0, X, x, w)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[0].numpy(), aa, atol=1e-3)
    e = pnp._reproj_errors(_t(np.asarray(R_r)), _t(np.asarray(t_r)), _t(X), _t(x))
    e_r = ref_pnp._reproj_errors(R_r, t_r, jnp.asarray(X), jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=1e-9, atol=1e-18)


def test_pnp_ransac_matches_reference_given_its_draws():
    X, x, valid, aa, t = _pnp_scene(seed=4)
    key = jax.random.PRNGKey(11)
    aa_r, t_r, inl_r, n_r = ref_pnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(x),
                                               jnp.asarray(valid), n_hypotheses=32,
                                               inlier_thresh=1e-6)
    idx = replay_draws(key, valid, 32, 6, jnp.float64)
    a, tt, inl, n = pnp.pnp_from_samples(idx, _t(X), _t(x), _t(valid), inlier_thresh=1e-6)
    assert int(n) == int(n_r) > 90
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_r))
    np.testing.assert_allclose(a.numpy(), np.asarray(aa_r), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t_r), rtol=0, atol=1e-9)


def test_render_matches_reference():
    kw = dict(n_frames=3, n_points=40, H=60, W=80, seed=3)
    f_ref, gt_ref = ref_seq.render_blob_sequence(**kw)
    f, gt = seq.render_blob_sequence(device="cpu", **kw)
    assert f.dtype == np.float32 and f.shape == f_ref.shape
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gt["points"], gt_ref["points"])
    np.testing.assert_allclose(gt["poses"], gt_ref["poses"], rtol=0, atol=1e-12)
    assert gt["K"] == gt_ref["K"]


def _write_png(path, img):
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def test_tum_and_kitti_readers_match_reference(tmp_path):
    imgs = np.random.default_rng(8).random((3, 20, 30)).astype(np.float32)
    tum = tmp_path / "tum"
    os.makedirs(tum / "rgb")
    with open(tum / "rgb.txt", "w") as fh:
        fh.write("# timestamp filename\n")
        for i, img in enumerate(imgs):
            _write_png(tum / "rgb" / f"{i}.png", img)
            fh.write(f"{0.1 * i:.6f} rgb/{i}.png\n")
    with open(tum / "groundtruth.txt", "w") as fh:
        fh.write("# t tx ty tz qx qy qz qw\n0.0 1 2 3 0 0 0 1\n0.1 1.5 2 3 0 0 0.1 0.995\n")
    kitti = tmp_path / "kitti"
    os.makedirs(kitti / "image_0")
    for i, img in enumerate(imgs):
        _write_png(kitti / "image_0" / f"{i:06d}.png", img)
    np.savetxt(kitti / "times.txt", 0.1 * np.arange(3))
    with open(kitti / "calib.txt", "w") as fh:
        fh.write("P0: 280 0 160 0 0 281 120 0 0 0 1 0\nP1: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    for root, port, ref in ((tum, seq.read_tum_sequence, ref_seq.read_tum_sequence),
                            (kitti, seq.read_kitti_sequence, ref_seq.read_kitti_sequence)):
        for max_frames in (None, 2):
            f, gt = port(str(root), max_frames)
            f_ref, gt_ref = ref(str(root), max_frames)
            np.testing.assert_array_equal(f, f_ref)
            assert f.dtype == np.float32 and gt.keys() == gt_ref.keys()
            for k in gt:
                np.testing.assert_array_equal(gt[k], gt_ref[k])
    assert gt["K"] == (280.0, 281.0, 160.0, 120.0)
