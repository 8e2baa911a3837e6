"""The port's incremental SfM end to end against ``tpu_ba``'s, and its
``sfm`` command line.

Both pipelines run at a small size (5 rendered frames of 120 points, 128
corners, 256 RANSAC hypotheses, 3 windowed and 5 final BA iterations) on the
reference's frames, in the dtypes the reference gives each stage (f32 image
work and BA). The port's sampler replays the reference's draws (every RANSAC
call splits the reference's key once, in call order), so the two runs make
the same decisions: the same frames registered, the same map points and
observations (their frame and point indices equal, pixels within 1e-4). The
f32 BA differs in rounding, so poses agree to 1e-3 and the final cost to a
relative 1e-3.
"""

import json

import numpy as np
import pytest
import torch

import tpu_ba.sfm.incremental as ref_inc
import tpu_ba_torch.sfm.incremental as inc
import tpu_ba_torch.sfm.twoview as two
from tpu_ba.io.sequences import render_blob_sequence

from test_torch_sfm import replay_draws

torch.set_num_threads(1)

CFG = dict(max_corners=128, ransac_hypotheses=256, ba_iters=3, final_ba_iters=5, seed=0)


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    frames, gt = render_blob_sequence(n_frames=5, n_points=120, seed=4)
    ref = ref_inc.run_incremental_sfm(frames, gt["K"], ref_inc.SfMConfig(**CFG))
    key = [jax.random.PRNGKey(CFG["seed"])]
    calls = []

    def replay(generator, valid, n_hypotheses, sample_size):
        key[0], k1 = jax.random.split(key[0])
        calls.append(sample_size)
        return replay_draws(k1, valid.cpu().numpy(), n_hypotheses, sample_size, jnp.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(two, "sample_index_sets", replay)
        port = inc.run_incremental_sfm(frames, gt["K"], inc.SfMConfig(**CFG), device="cpu")
    return ref, port, calls


def test_incremental_sfm_makes_the_reference_decisions(runs):
    ref, port, calls = runs
    assert calls == [8] + [6] * (len(calls) - 1) and len(calls) >= 4
    for k in ("init_inliers", "init_points", "n_points", "n_obs", "registered_frames", "pnp"):
        assert port.report[k] == ref.report[k], k
    assert port.report["registered_frames"] == 5 and port.report["n_points"] > 50
    np.testing.assert_array_equal(port.registered, ref.registered)
    np.testing.assert_array_equal(port.track_frame, ref.track_frame)
    np.testing.assert_array_equal(port.track_point, ref.track_point)
    np.testing.assert_allclose(port.track_xy, ref.track_xy, rtol=0, atol=1e-4)
    assert port.points.dtype == ref.points.dtype and port.poses.dtype == ref.poses.dtype


def test_incremental_sfm_lands_where_the_reference_does(runs):
    ref, port, _ = runs
    assert abs(port.final_cost - ref.final_cost) <= 1e-3 * ref.final_cost, \
        (port.final_cost, ref.final_cost)
    np.testing.assert_allclose(port.poses, ref.poses, rtol=0, atol=1e-3)
    np.testing.assert_allclose(port.points, ref.points, rtol=0,
                               atol=1e-3 * np.abs(ref.points).max())
    rmse = np.sqrt(2 * port.final_cost / port.report["n_obs"])
    assert rmse < 2.0


def test_incremental_sfm_report_keeps_the_reference_keys(runs):
    ref, port, _ = runs
    assert port.report.keys() == ref.report.keys()
    assert port.report["stage_s"].keys() == ref.report["stage_s"].keys()
    for k, v in port.report["stage_split"].items():
        assert v.keys() == ref.report["stage_split"][k].keys()
        # the port's split: the first call of a stage against the rest
        assert v["n_compile_class"] == 1
    total = sum(port.report["stage_s"].values())
    assert abs(port.report["warm_total_s"] + port.report["compile_attr_s"] - total) < 0.05


def test_cli_sfm_writes_a_bal_file_load_bal_reads(tmp_path, capsys):
    from tpu_ba_torch.cli import main
    from tpu_ba_torch.io.bal import load_bal

    out = tmp_path / "scene.txt"
    assert main(["sfm", "--frames", "4", "--points", "100", "--corners", "128",
                 "--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["registered_frames"] >= 3 and rep["rmse_px"] < 2.0
    prob = load_bal(str(out), use_native=False, device="cpu")
    assert (prob.n_cameras, prob.n_obs) == (rep["registered_frames"], rep["n_obs"])
    assert prob.n_points == rep["n_points"]
