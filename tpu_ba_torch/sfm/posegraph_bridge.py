"""Bridge: SfM trajectory → pose graph → refined trajectory.

Counterpart of ``tpu_ba/sfm/posegraph_bridge.py``: an
:class:`~tpu_ba_torch.sfm.incremental.SfMResult` trajectory becomes a pose
graph (odometry edges between consecutive registered frames, plus
caller-supplied loop-closure edges), the SE(3) LM of
``tpu_ba_torch/posegraph`` refines it, and the poses are written back.

The odometry measurements are taken from the estimates themselves, so the
refinement is a no-op without extra constraints: its value is distributing
the correction of loop-closure edges over the whole trajectory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ba_torch.core import resolve_device
from tpu_ba_torch.geometry.se3 import se3_relative
from tpu_ba_torch.posegraph import solve_pose_graph


def sfm_to_pose_graph(res, extra_edges=None):
    """Build pose-graph arrays from an SfMResult.

    extra_edges: optional list of (i, j, z_ij (6,)) loop-closure constraints
    (frame indices into the original sequence).
    Returns (nodes (N,6), ei, ej, meas, frame_ids) with N = registered count.
    """
    reg = np.where(res.registered)[0]
    fmap = {f: i for i, f in enumerate(reg)}
    nodes = res.poses[reg].copy()
    nodes_t = torch.as_tensor(nodes)

    ei = [fmap[a] for a in reg[1:]]
    ej = [fmap[b] for b in reg[:-1]]
    meas = list(se3_relative(nodes_t[ei], nodes_t[ej]).numpy())
    if extra_edges:
        for i, j, z in extra_edges:
            if i in fmap and j in fmap:
                ei.append(fmap[i])
                ej.append(fmap[j])
                meas.append(np.asarray(z))
    return (nodes, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(meas), reg)


def refine_sfm_with_pose_graph(res, extra_edges=None, max_iters: int = 30, *, device=None):
    """Run pose-graph LM over an SfM trajectory on ``device`` (default: the
    CUDA card, see ``resolve_device``); returns (a new SfMResult with refined
    poses, final cost, iterations). Points are not retriangulated: run a
    global BA afterwards for that."""
    device = resolve_device(device)
    nodes, ei, ej, meas, reg = sfm_to_pose_graph(res, extra_edges)
    new_nodes, cost, iters = solve_pose_graph(nodes, ei, ej, meas, max_iters=max_iters,
                                              device=device)
    poses = res.poses.copy()
    poses[reg] = new_nodes.cpu().numpy()
    return dataclasses.replace(res, poses=poses), float(cost), int(iters)
