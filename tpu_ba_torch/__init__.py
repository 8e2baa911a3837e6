"""tpu_ba_torch — the bundle adjuster of ``tpu_ba`` ported to PyTorch and CUDA.

``tpu_ba`` (JAX/Pallas on a TPU) stays the reference; this package keeps its
module names, so ``tpu_ba_torch/solver/schur.py`` is the counterpart of
``tpu_ba/solver/schur.py``. Plain tensor code is PyTorch on an explicit
device; the Pallas kernels on the path become hand-written CUDA kernels for
Hopper (``tpu_ba_torch/csrc/``), each with a plain PyTorch version that CPU
tensors take. This package never imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# the reference pins full f32 matmul precision (tpu_ba/__init__.py); state
# the same here: no TF32 in matmuls or convolutions
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from tpu_ba_torch.core import BAProblem, LMConfig, LMResult, make_problem  # noqa: E402,F401
