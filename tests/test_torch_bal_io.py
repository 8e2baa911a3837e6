"""BAL and scene files in the port against ``tpu_ba.io``: ``save_bal`` writes
the reference's bytes; ``load_bal``, through the native parser and the
Python tokenizer, reads what the reference's Python tokenizer reads (exact
in f32; in f64 within 1e-14, the reference's own bound for its native
parser); ``normalize_bal`` against the reference at 1e-12 with reprojections
unchanged; ``find_bal_file``; scenes in .npz and .mat crossing between the
packages; the native parser's build."""

import gzip
import shutil

import numpy as np
import pytest
import torch

from tpu_ba.core import make_problem as ref_make_problem
from tpu_ba.io.bal import load_bal as ref_load_bal
from tpu_ba.io.bal import normalize_bal as ref_normalize_bal
from tpu_ba.io.bal import save_bal as ref_save_bal
from tpu_ba.io.scene import load_scene as ref_load_scene
from tpu_ba.io.scene import save_scene as ref_save_scene
from tpu_ba_torch.core import problem_to_numpy
from tpu_ba_torch.geometry.cameras import project_bal
from tpu_ba_torch.io import native
from tpu_ba_torch.io.bal import find_bal_file, load_bal, normalize_bal, save_bal
from tpu_ba_torch.io.scene import load_scene, save_scene
from tpu_ba_torch.io.synthetic import make_synthetic_problem
from tpu_ba_torch.kernels._lib import BUILD_DIR

torch.set_num_threads(1)

FIELDS = ("cameras", "points", "obs_2d", "cam_idx", "pt_idx", "mask")
DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64)}


def _problem(dtype=torch.float64):
    """A small problem: 6 cameras, 50 points, 3 observations a point."""
    p, _ = make_synthetic_problem(6, 50, obs_per_point=3, seed=4, pad_multiple=8, dtype=dtype,
                                  device="cpu")
    return p


def _ref_problem(p):
    """The same problem as tpu_ba holds it."""
    a = problem_to_numpy(p)
    n = p.n_obs
    return ref_make_problem(a["cameras"], a["points"], a["obs_2d"][:n], a["cam_idx"][:n],
                            a["pt_idx"][:n], dtype=a["cameras"].dtype, pad_multiple=8)


def _assert_fields(port, ref, rtol=0.0):
    for k in FIELDS:
        a, b = getattr(port, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert (port.n_cameras, port.n_points, port.n_obs) == (ref.n_cameras, ref.n_points, ref.n_obs)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_save_bal_writes_the_reference_bytes(tmp_path, dtype):
    p = _problem(DTYPES[dtype][0])
    save_bal(str(tmp_path / "port.txt"), p)
    ref_save_bal(str(tmp_path / "ref.txt"), _ref_problem(p))
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "ref.txt").read_bytes()
    assert port.count(b"\n") == 1 + p.n_obs + 9 * p.n_cameras + 3 * p.n_points


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_load_bal_matches_the_reference(tmp_path, dtype, use_native):
    tdt, ndt = DTYPES[dtype]
    p = _problem(tdt)
    path = str(tmp_path / "p.txt")
    save_bal(path, p)
    port = load_bal(path, dtype=tdt, pad_multiple=8, use_native=use_native, device="cpu")
    ref = ref_load_bal(path, dtype=ndt, pad_multiple=8, use_native=False)
    _assert_fields(port, ref, rtol=1e-14 if (use_native and dtype == "f64") else 0.0)
    if dtype == "f32":            # an f32 value survives %.16e, either parser
        for k in FIELDS:
            assert torch.equal(getattr(port, k), getattr(p, k)), k


def test_gz_loads_through_the_python_tokenizer(tmp_path):
    p = _problem()
    save_bal(str(tmp_path / "p.txt"), p)
    with open(tmp_path / "p.txt", "rb") as src, gzip.open(tmp_path / "p.txt.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    port = load_bal(str(tmp_path / "p.txt.gz"), dtype=torch.float64, pad_multiple=8,
                    device="cpu")
    _assert_fields(port, ref_load_bal(str(tmp_path / "p.txt.gz"), dtype=np.float64,
                                      pad_multiple=8))
    with pytest.raises(ValueError, match="plain text"):
        native.parse_bal_native(str(tmp_path / "p.txt.gz"))


def test_normalize_bal_matches_the_reference_and_keeps_reprojections():
    p = _problem()
    cams, pts = p.cameras.numpy().copy(), p.points.numpy() * 7.0 + 3.0
    cams[0, :3] = 0.0                                 # the θ = 0 branch of Rodrigues
    cams_in, pts_in = cams.copy(), pts.copy()
    c1, p1 = normalize_bal(cams, pts)
    assert np.array_equal(cams, cams_in) and np.array_equal(pts, pts_in)   # inputs untouched
    c2, p2 = ref_normalize_bal(cams, pts)
    np.testing.assert_allclose(c1, c2, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(p1, p2, rtol=1e-12, atol=1e-12)
    assert abs(np.median(np.abs(p1 - np.median(p1, axis=0)).sum(axis=1)) - 100.0) < 1e-9
    ci, pi = p.cam_idx.long(), p.pt_idx.long()
    before = project_bal(torch.from_numpy(cams)[ci], torch.from_numpy(pts)[pi])
    after = project_bal(torch.from_numpy(c1)[ci], torch.from_numpy(p1)[pi])
    torch.testing.assert_close(after, before, rtol=1e-9, atol=1e-9)


def test_load_bal_normalizes_and_find_bal_file_looks_up(tmp_path, monkeypatch):
    p = _problem()
    (tmp_path / "data").mkdir()
    (tmp_path / "other").mkdir()
    save_bal(str(tmp_path / "other" / "problem-tiny-6.txt"), p)
    monkeypatch.chdir(tmp_path)
    assert find_bal_file("tiny-6") is None                         # default: data/ only
    found = find_bal_file("tiny-6", search_dirs=("data", "other"))
    assert found == "other/problem-tiny-6.txt"
    shutil.copy(found, "data/tiny-6.txt")
    assert find_bal_file("tiny-6", search_dirs=("data", "other")) == "data/tiny-6.txt"
    port = load_bal(found, dtype=torch.float64, pad_multiple=8, normalize=True, device="cpu")
    ref = ref_load_bal(found, dtype=np.float64, pad_multiple=8, normalize=True, use_native=False)
    _assert_fields(port, ref, rtol=1e-12)


@pytest.mark.parametrize("ext", [".npz", ".mat"])
@pytest.mark.parametrize("writer", ["tpu_ba", "port"])
def test_scenes_cross_between_packages(tmp_path, ext, writer):
    p = _problem(torch.float32)
    path = str(tmp_path / f"scene{ext}")
    if writer == "port":
        save_scene(path, p)
    else:
        ref_save_scene(path, _ref_problem(p))
    port = load_scene(path, pad_multiple=8, device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(port, k), getattr(p, k)), k
    assert port.model == "bal" and port.n_obs == p.n_obs
    _assert_fields(port, ref_load_scene(path, pad_multiple=8))
    with pytest.raises(ValueError, match="extension"):
        save_scene(str(tmp_path / "scene.txt"), p)


def test_native_parser_builds_under_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library lands in build/tpu_ba_torch/, named by its source; a
    source g++ rejects raises with g++'s output, and load_bal does not fall
    back to the Python tokenizer."""
    assert native.library_path().parent == BUILD_DIR
    assert BUILD_DIR.parts[-2:] == ("build", "tpu_ba_torch")
    p = _problem()
    path = str(tmp_path / "p.txt")
    save_bal(path, p)
    bad = tmp_path / "bal_parser.cpp"
    bad.write_text("int bal_parse( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_bal(path, device="cpu")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.undo()
    with pytest.raises(OSError, match="native BAL parser failed"):
        native.parse_bal_native(str(tmp_path / "missing.txt"))
