"""Wrappers of the port's hand-written Hopper kernels, each beside its plain
PyTorch version.

A CPU tensor goes to the plain version (it is the kernel's oracle and what
the CPU tests run).  A CUDA tensor launches the kernel on the current stream
or raises: there is no fallback.  Each wrapper counts its launches in a
plain integer attribute (`symmetric_downdate.launches`,
`householder_qr_blocks.launches`).
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


def same_operand(K, PHt):
    """True when K and PHt are one tensor: the same storage offset, shape and
    strides.  An equal copy or another view of K's storage is not."""
    return (K.data_ptr() == PHt.data_ptr() and K.shape == PHt.shape
            and K.stride() == PHt.stride())


def symmetric_downdate(P, K, PHt):
    """sym(P − K·PHtᵀ) = ½(P+Pᵀ) − ½(K·PHtᵀ + PHt·Kᵀ) — the covariance store
    of every EKF update (P [D,D], K and PHt [D,m], float32, contiguous).

    On CUDA it runs `csrc/symmetric_downdate.cu`, which replaces the TPU
    kernel `_downdate_kernel` of open_vins_tpu/ops/pallas_kernels.py; when
    K and PHt are one tensor (`same_operand`) the kernel forms the single
    product K·Kᵀ.
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
                                         D, m, int(same_operand(K, PHt)),
                                         stream)
    if err != 0:
        raise RuntimeError(f"symmetric_downdate kernel launch failed: "
                           f"cudaError {err}")
    symmetric_downdate.launches += 1
    return out


symmetric_downdate.launches = 0


_QR_PANEL = 32  # NBMAX of csrc/householder_qr_blocks.cu


def householder_qr_blocks_ref(A_blocks):
    """R factors [g, n, n] of a column-by-column Householder QR of each
    [B, n] row block, plain PyTorch — the TPU kernel's algorithm: sign +1
    when α ≥ 0, scale = 2/‖v‖² only when ‖v‖² > 1e-30 (a zero column is an
    identity reflector), the top n rows kept and the strict lower triangle
    set to exactly 0."""
    g, B, n = A_blocks.shape
    A = A_blocks
    ridx = torch.arange(B, device=A.device)[:, None]  # [B, 1]
    for j in range(n):
        x = torch.where(ridx >= j, A[:, :, j:j + 1], 0.0)  # [g, B, 1]
        normx = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        alpha = A[:, j:j + 1, j:j + 1]
        beta = -torch.where(alpha >= 0, 1.0, -1.0) * normx
        v = x - torch.where(ridx == j, beta, 0.0)
        vn2 = torch.sum(v * v, dim=1, keepdim=True)
        scale = torch.where(vn2 > 1e-30, 2.0 / vn2, 0.0)
        A = A - scale * (v @ (v.mT @ A))
    return torch.triu(A[:, :n, :])


def _check_qr_args(A_blocks):
    if A_blocks.dtype != torch.float32:
        raise TypeError("householder_qr_blocks: A_blocks must be float32, "
                        f"got {A_blocks.dtype}")
    if A_blocks.dim() != 3:
        raise ValueError("householder_qr_blocks: A_blocks must be [g, B, n], "
                         f"got shape {tuple(A_blocks.shape)}")
    g, B, n = A_blocks.shape
    if g < 1 or n < 1 or B < n:
        raise ValueError("householder_qr_blocks: need g >= 1, n >= 1 and "
                         f"B >= n; got [g, B, n] = {[g, B, n]}")
    if not A_blocks.is_contiguous():
        raise ValueError("householder_qr_blocks: A_blocks must be contiguous")


def householder_qr_blocks(A_blocks):
    """R factors [g, n, n] of the row blocks A_blocks [g, B, n] (float32,
    contiguous, B >= n): upper triangular, strict lower triangle exactly 0.

    On CUDA it runs `csrc/householder_qr_blocks.cu` (blocked Householder in
    compact WY form: a panel kernel and a trailing-update kernel per panel of
    32 columns, all on the current stream, counted as one launch), which
    replaces the TPU kernel `_house_qr_block_kernel` of
    open_vins_tpu/ops/pallas_kernels.py.
    """
    _check_qr_args(A_blocks)
    if A_blocks.device.type == "cpu":
        return householder_qr_blocks_ref(A_blocks)
    if A_blocks.device.type != "cuda":
        raise ValueError("householder_qr_blocks: unsupported device "
                         f"{A_blocks.device}")
    g, B, n = A_blocks.shape
    out = torch.empty((g, n, n), dtype=A_blocks.dtype, device=A_blocks.device)
    work = torch.empty_like(A_blocks)  # each block's working copy
    # a panel's reflectors V [B, 32] and triangular factor T [32, 32]
    vt = torch.empty((g, B * _QR_PANEL + _QR_PANEL ** 2),
                     dtype=A_blocks.dtype, device=A_blocks.device)
    lib = _build.load("householder_qr_blocks")
    with torch.cuda.device(A_blocks.device):
        stream = torch.cuda.current_stream(A_blocks.device).cuda_stream
        err = lib.householder_qr_blocks_f32(A_blocks.data_ptr(),
                                            work.data_ptr(), vt.data_ptr(),
                                            out.data_ptr(), g, B, n, stream)
    if err != 0:
        raise RuntimeError("householder_qr_blocks kernel launch failed: "
                           f"cudaError {err}")
    householder_qr_blocks.launches += 1
    return out


householder_qr_blocks.launches = 0
