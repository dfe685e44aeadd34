"""open_vins_tpu_torch — the PyTorch/CUDA port of the VIO estimator.

A second package beside the JAX reference `open_vins_tpu/`.  It imports
`torch`, numpy and scipy only, never JAX and never the reference package.
Entry points take `device=None`, which means the CUDA device; the tests pass
`device="cpu"` explicitly and nothing falls back to the CPU on its own.

The port runs the closed-loop filter on staged frames:
`models.runner.run_filter` calls `models.manager.step_frame` once per camera
frame.  It covers OpenVINS's MSCKF-only mode (`max_slam=0`) and the bench's
operating point: SLAM landmarks in the GLOBAL_3D representation with the
joint batched delayed init, the joint "qr" vision update, and the rk4,
discrete or analytical (ACI²) integrators.  Two hand-written Hopper kernels
(see `ops/kernels.py`): every EKF update's covariance downdate runs
`ops/csrc/symmetric_downdate.cu`, and the Householder TSQR compression
(`models.update_helper.compress_system`) runs its row blocks through
`ops/csrc/householder_qr_blocks.cu`.
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
