"""Wrappers of the port's hand-written Hopper kernels, each beside its plain
PyTorch version.

A CPU tensor goes to the plain version (it is the kernel's oracle and what
the CPU tests run).  A CUDA tensor launches the kernel on the current stream
or raises: there is no fallback.  Each wrapper counts its launches in a
plain integer attribute (`symmetric_downdate.launches`).
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.ops import _build


def symmetric_downdate_ref(P, K, PHt):
    """sym(P − K·PHtᵀ), plain PyTorch."""
    cov = P - K @ PHt.mT
    return 0.5 * (cov + cov.mT)


def _check_downdate_args(P, K, PHt):
    for name, t in (("P", P), ("K", K), ("PHt", PHt)):
        if t.dtype != torch.float32:
            raise TypeError(f"symmetric_downdate: {name} must be float32, "
                            f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"symmetric_downdate: {name} must be 2-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"symmetric_downdate: {name} must be contiguous")
    D = P.shape[0]
    if P.shape != (D, D) or K.shape[0] != D or K.shape != PHt.shape:
        raise ValueError("symmetric_downdate: need P [D,D] and K, PHt [D,m]; "
                         f"got {tuple(P.shape)}, {tuple(K.shape)}, "
                         f"{tuple(PHt.shape)}")
    if not (P.device == K.device == PHt.device):
        raise ValueError("symmetric_downdate: P, K and PHt must lie on one "
                         f"device, got {P.device}, {K.device}, {PHt.device}")


def symmetric_downdate(P, K, PHt):
    """sym(P − K·PHtᵀ) = ½(P+Pᵀ) − ½(K·PHtᵀ + PHt·Kᵀ) — the covariance store
    of every EKF update (P [D,D], K and PHt [D,m], float32, contiguous).

    On CUDA it runs `csrc/symmetric_downdate.cu`, which replaces the TPU
    kernel `_downdate_kernel` of open_vins_tpu/ops/pallas_kernels.py.
    """
    _check_downdate_args(P, K, PHt)
    if P.device.type == "cpu":
        return symmetric_downdate_ref(P, K, PHt)
    if P.device.type != "cuda":
        raise ValueError(f"symmetric_downdate: unsupported device {P.device}")
    D, m = K.shape
    out = torch.empty_like(P)
    lib = _build.load("symmetric_downdate")
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = lib.symmetric_downdate_f32(P.data_ptr(), K.data_ptr(),
                                         PHt.data_ptr(), out.data_ptr(),
                                         D, m, stream)
    if err != 0:
        raise RuntimeError(f"symmetric_downdate kernel launch failed: "
                           f"cudaError {err}")
    symmetric_downdate.launches += 1
    return out


symmetric_downdate.launches = 0
