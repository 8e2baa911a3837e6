"""Metrics / observability: JSONL event log and profiler traces.

Counterpart of ``tpu_ba/bench/metrics.py``: the same JSONL records (one
event a line, with its wall-clock offset ``t``) and, in place of
``jax.profiler``, ``torch.profiler`` traces for TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import time

from tpu_ba_torch.core import to_host


class MetricsLogger:
    """Append-only JSONL event logger with wall-clock stamps; a logger
    without a path records nothing."""

    def __init__(self, path: str | None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.t0 = time.time()

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"event": event, "t": round(time.time() - self.t0, 6), **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_lm_result(self, res, *, wall_s: float | None = None, label: str = "") -> None:
        """Record a finished LMResult, with its per-iteration cost trace."""
        self.log(
            "lm_solve", label=label,
            iterations=int(res.iterations), accepted=int(res.accepted),
            initial_cost=float(res.initial_cost), final_cost=float(res.cost),
            grad_inf_norm=float(res.grad_inf_norm), lam=float(res.lam),
            converged=bool(res.converged), wall_s=wall_s,
            cost_history=to_host(res.cost_history).astype("float64").tolist(),
        )

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """A ``torch.profiler`` trace of the block, written to ``logdir`` for
    TensorBoard (CPU activity, and CUDA activity where a card is present);
    no-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
