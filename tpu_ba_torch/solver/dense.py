"""Dense normal-equation solver: the correctness oracle for the Schur paths.

Counterpart of ``tpu_ba/solver/dense.py``: assemble the full damped normal
equations and solve them directly. For tests and tiny problems; the matrix is
(C·dc + 3P) square.

H is written in a fixed order, so a solve repeats bit for bit on the card:
the camera and point blocks are written once each, and the coupling blocks
of the observations that share a (camera, point) cell are added in passes,
the k-th observation of every cell in pass k (the pose graph's
``_rank_passes``), no cell twice in a pass.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ba_torch.posegraph.solver import _rank_passes
from tpu_ba_torch.solver.normal import BlockSystem, damp_blocks


def dense_hessian(B: BlockSystem, lam, diag_floor: float, diag_ceil: float):
    """The damped H ((C·dc + 3P) square) and the gradient g from the blocks.
    The lane-major blocks (W (3dc, O), V (9, P)) go back to one block per
    observation and point for the scatter."""
    C, dc, _ = B.U.shape
    P, O = B.V.shape[-1], B.W.shape[-1]
    n = C * dc + P * 3
    dev = B.U.device
    Ul, Vl_t = damp_blocks(B, lam, diag_floor, diag_ceil)
    Vl = Vl_t.T.reshape(P, 3, 3)
    W_aos = B.W.T.reshape(O, dc, 3)

    H = torch.zeros((n, n), dtype=B.U.dtype, device=dev)
    ar_dc, ar3 = torch.arange(dc, device=dev), torch.arange(3, device=dev)
    arC, arP = torch.arange(C, device=dev), torch.arange(P, device=dev)

    def put(rows, cols, vals, add=False):   # cells distinct within one call
        rows, cols = torch.broadcast_tensors(rows, cols)
        H.index_put_((rows, cols), H[rows, cols] + vals if add else vals)

    put(arC[:, None, None] * dc + ar_dc[None, :, None],
        arC[:, None, None] * dc + ar_dc[None, None, :], Ul)
    put(C * dc + arP[:, None, None] * 3 + ar3[None, :, None],
        C * dc + arP[:, None, None] * 3 + ar3[None, None, :], Vl)
    ci = B.cam_idx.cpu().numpy().astype(np.int64)
    cells = ci * P + B.pt_idx.cpu().numpy().astype(np.int64)
    for src, cell in _rank_passes(cells, dev):
        oi = (cell // P)[:, None, None] * dc + ar_dc[None, :, None]
        oj = C * dc + (cell % P)[:, None, None] * 3 + ar3[None, None, :]
        put(oi, oj, W_aos[src], add=True)
        put(oj, oi, W_aos[src], add=True)     # the transposed blocks, cell for cell

    g = torch.cat([B.gc.reshape(-1), B.gp.T.reshape(-1)])
    return H, g


def solve_dense(B: BlockSystem, lam, diag_floor: float = 1e-6, diag_ceil: float = 1e32):
    """Solve the damped normal equations H δ = −g directly.
    Returns (δ_cameras (C, dc), δ_points (P, 3))."""
    C, dc, _ = B.U.shape
    P = B.V.shape[-1]
    H, g = dense_hessian(B, lam, diag_floor, diag_ceil)
    delta = torch.linalg.solve(H, -g)
    return delta[:C * dc].reshape(C, dc), delta[C * dc:].reshape(P, 3)
