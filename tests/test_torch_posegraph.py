"""The port's pose graph against ``tpu_ba``'s: the cost, the LM solve on the
reference test's circle (n = 30, with and without square-root information),
the SfM bridge and the ``posegraph`` subcommands of both command lines.

Both packages run in float64 on the same inputs. The solves must take the
same number of iterations and land within 1e-9 of each other (node entries,
final cost relative); the reference's runs, whose jit compiles take most of
this file's time, are shared: the module-scoped fixture calls the reference
solve as its bridge does (30 nodes, 31 edges, ``max_iters=30`` given), so the
bridge test reuses the compiled program.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ba.cli as ref_cli
import tpu_ba.posegraph as ref_pg
import tpu_ba.sfm.posegraph_bridge as ref_bridge
import tpu_ba_torch.cli as cli
import tpu_ba_torch.posegraph as pg
import tpu_ba_torch.posegraph.solver as pg_solver
import tpu_ba_torch.sfm.posegraph_bridge as bridge
from tpu_ba.geometry.se3 import se3_compose, se3_exp, se3_relative
from tpu_ba.sfm.incremental import SfMResult

from test_posegraph import _circle_graph

torch.set_num_threads(1)

TOL = 1e-9


def _graph():
    gt, ei, ej, meas = _circle_graph(n=30, noise=0.03, seed=1)
    init = gt + 0.1 * np.random.default_rng(2).standard_normal(gt.shape)
    init[0] = gt[0]
    sqrt_info = np.tile(np.eye(6)[None], (len(ei), 1, 1)) * 2.0
    sqrt_info[:, 0, 3] = 0.3              # not diagonal: rows mix rotation and translation
    return init, ei, ej, meas, sqrt_info


@pytest.fixture(scope="module")
def ref_solves():
    init, ei, ej, meas, sqrt_info = _graph()
    j = jnp.asarray
    out = {}
    for name, si in (("plain", ()), ("weighted", (j(sqrt_info),))):
        nodes, cost, it = ref_pg.solve_pose_graph(j(init), j(ei), j(ej), j(meas), *si,
                                                  max_iters=30)
        out[name] = (np.asarray(nodes), float(cost), int(it))
    return out


def test_pose_graph_cost_matches_reference():
    init, ei, ej, meas, sqrt_info = _graph()
    j, t = jnp.asarray, torch.as_tensor
    ref_cost = jax.jit(ref_pg.pose_graph_cost)
    for si in (None, sqrt_info):
        ref = float(ref_cost(j(init), j(ei), j(ej), j(meas), None if si is None else j(si)))
        out = pg.pose_graph_cost(t(init), t(ei), t(ej), t(meas), None if si is None else t(si))
        assert abs(out.item() - ref) <= 1e-12 * ref, (out.item(), ref)


@pytest.mark.parametrize("name", ["plain", "weighted"])
def test_solve_pose_graph_matches_reference(ref_solves, name):
    init, ei, ej, meas, sqrt_info = _graph()
    nodes, cost, it = pg.solve_pose_graph(init, ei, ej, meas,
                                          sqrt_info if name == "weighted" else None,
                                          device="cpu")
    ref_nodes, ref_cost, ref_it = ref_solves[name]
    assert it == ref_it
    assert nodes.dtype == torch.float64 and nodes.device.type == "cpu"
    np.testing.assert_allclose(nodes.numpy(), ref_nodes, rtol=0, atol=TOL)
    assert abs(cost.item() - ref_cost) <= TOL * ref_cost
    c0 = pg.pose_graph_cost(torch.as_tensor(init), ei, ej, torch.as_tensor(meas),
                            torch.as_tensor(sqrt_info) if name == "weighted" else None)
    assert cost.item() < 0.1 * c0.item()


def test_assembly_plan_passes_hold_each_block_once():
    """Every (row, column) block and gradient row is written once a pass, so
    the fixed-order assembly has no colliding writes; the passes hold every
    contribution once."""
    _, ei, ej, _, _ = _graph()
    N = 30
    h_passes, g_passes = pg_solver._assembly_plan(ei.astype(np.int64), ej.astype(np.int64),
                                                  N, "cpu")
    for passes, n_src in ((h_passes, 4 * len(ei)), (g_passes, 2 * len(ei))):
        srcs = torch.cat([s for s, _ in passes])
        assert sorted(srcs.tolist()) == list(range(n_src))
        for _, key in passes:
            assert key.unique().numel() == key.numel()
    # the diagonal block of node 0 has 3 contributions per endpoint role + anchor
    assert len(h_passes) == 3 and len(g_passes) == 3


def test_sfm_bridge_matches_reference():
    """A drifted 30-frame trajectory (one unregistered) with two loop-closure
    edges, through both bridges."""
    rng = np.random.default_rng(5)
    n = 31
    gt = np.zeros((n, 6))
    for i in range(n):
        ang = 2 * np.pi * i / n
        gt[i] = [0, ang, 0, np.cos(ang), 0, np.sin(ang)]
    poses = gt + np.cumsum(0.02 * rng.standard_normal((n, 6)), axis=0)
    registered = np.ones(n, bool)
    registered[7] = False
    res = SfMResult(poses=poses, points=np.zeros((1, 3)), track_frame=np.zeros(1, int),
                    track_point=np.zeros(1, int), track_xy=np.zeros((1, 2)),
                    registered=registered, final_cost=0.0, report={})
    extra = [(n - 1, 0, np.asarray(se3_relative(jnp.asarray(gt[n - 1]), jnp.asarray(gt[0])))),
             (15, 0, np.asarray(se3_relative(jnp.asarray(gt[15]), jnp.asarray(gt[0]))))]
    for a, b in zip(bridge.sfm_to_pose_graph(res, extra), ref_bridge.sfm_to_pose_graph(res, extra)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    out, cost, it = bridge.refine_sfm_with_pose_graph(res, extra, device="cpu")
    ref, ref_cost, ref_it = ref_bridge.refine_sfm_with_pose_graph(res, extra)
    assert it == ref_it
    np.testing.assert_allclose(out.poses, ref.poses, rtol=0, atol=TOL)
    assert abs(cost - ref_cost) <= TOL * ref_cost
    assert np.linalg.norm(out.poses[-1, 3:6] - gt[-1, 3:6]) < \
        np.linalg.norm(poses[-1, 3:6] - gt[-1, 3:6])


def test_cli_posegraph_matches_reference(capsys):
    args = ["posegraph", "--nodes", "12", "--noise", "0.02", "--max-iters", "20"]
    assert ref_cli.main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert (out["nodes"], out["iterations"]) == (ref["nodes"], ref["iterations"])
    for k in ("initial_cost", "final_cost"):
        assert abs(out[k] - ref[k]) <= TOL * ref[k], (k, out[k], ref[k])
    assert out["final_cost"] < 0.1 * out["initial_cost"]


def test_exp_compose_of_the_cli_ring_matches_reference():
    """The measurement model the command line builds its ring from."""
    rng = np.random.default_rng(0)
    from tpu_ba_torch.geometry import se3 as port_se3

    for _ in range(5):
        xi, gi, gj = rng.standard_normal(6) * 0.03, rng.standard_normal(6), rng.standard_normal(6)
        ref = np.asarray(se3_compose(se3_exp(jnp.asarray(xi)),
                                     se3_relative(jnp.asarray(gi), jnp.asarray(gj))))
        t = torch.as_tensor
        out = port_se3.se3_compose(port_se3.se3_exp(t(xi)), port_se3.se3_relative(t(gi), t(gj)))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
