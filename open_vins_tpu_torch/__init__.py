"""open_vins_tpu_torch — the PyTorch/CUDA port of the VIO estimator.

A second package beside the JAX reference `open_vins_tpu/`.  It imports
`torch`, numpy and scipy only, never JAX and never the reference package.
Entry points take `device=None`, which means the CUDA device; the tests pass
`device="cpu"` explicitly and nothing falls back to the CPU on its own.

The port stages its own sensor streams (`sim/`: the SE(3) B-spline,
trajectory files and the seeded simulator, whose random numbers come from
numpy's PCG64 so that one seed stages the same stream on the CPU and the
card) and runs the closed-loop filter on them: `models.runner.run_filter`
calls `models.manager.step_frame` once per camera frame, and
`run_filter_from` starts from a given state, which `runner.auto_init_state`
finds by the reference's own routed initialization (`init/`: static,
dynamic, the router, the background initializer).  It covers OpenVINS's
MSCKF-only mode (`max_slam=0`) and the bench's operating point: SLAM
landmarks in any of the six representations (`models.landmark_rep`, with
`change_anchors`) and aruco landmarks, the joint batched delayed init,
every joint update form and the sequential ordering, ZUPT, and the rk4,
discrete or analytical (ACI²) integrators.  `runner.run_ensemble` runs bench.py's
seed ensemble: B streams stepped as one batched step, `step_frame` under
`torch.func.vmap`.  The image front end (`frontend/`: pyramidal KLT,
fundamental-matrix RANSAC whose hypotheses come from a seeded
`torch.Generator`, the KLT and descriptor trackers) and the sprite renderer
(`sim/render.py`) run bench.py's rendered images->pose pipeline:
`runner.run_filter_rendered` renders every camera each frame, tracks the
images and steps the filter on the tracker's packets.  Two hand-written
Hopper kernels (see `ops/kernels.py`, custom ops with vmap rules, so a
batched call is one launch): every EKF update's covariance downdate runs
`ops/csrc/symmetric_downdate.cu`, and the Householder TSQR compression
(`models.update_helper.compress_system`) runs its row blocks through
`ops/csrc/householder_qr_blocks.cu`.

The parallel layer (`parallel/`) runs on `torch.distributed`, one process
per rank: the row-sharded EKF update, the distributed Schur BA, the
sliding-window refinement and the multi-rank dry run
(`python -m open_vins_tpu_torch.parallel.dryrun`).  The host utilities
(`utils/`: the OpenVINS YAML loader, checkpoints, the timing CSV, profiler
traces, the native sensor hub; `eval/traj_io`; `frontend/aruco` and
`frontend/visualization`) complete the JAX package's modules.
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
