"""open_vins_tpu_torch — the PyTorch/CUDA port of the VIO estimator.

A second package beside the JAX reference `open_vins_tpu/`.  It imports
`torch`, numpy and scipy only, never JAX and never the reference package.
Entry points take `device=None`, which means the CUDA device; the tests pass
`device="cpu"` explicitly and nothing falls back to the CPU on its own.

The current slice covers the closed-loop MSCKF-only filter (`max_slam=0`,
rk4 or discrete integration): `models.runner.run_filter` calls
`models.manager.step_frame` once per camera frame, and every EKF update's
covariance downdate runs the hand-written Hopper kernel of
`ops/csrc/symmetric_downdate.cu` (see `ops/kernels.py`).
"""

import torch as _torch

# Covariance algebra cannot take TF32 products (about three decimal digits);
# the reference forces f32 "highest" precision for the same reason.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> _torch.device:
    """`None` means the CUDA device; raise if it is asked for and absent."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "explicitly to run on the CPU")
    return dev
