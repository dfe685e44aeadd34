"""Peaks of one NVIDIA H100 SXM and the least time a kernel's work can take
on it.

Published peaks (NVIDIA's data sheet, dense, at the 700 W limit): 67
TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3.  The
bound of a call is the larger of its operations over the first and its
bytes over the second (inputs read once, the output written once), the
arithmetic of PERF.md's kernel table.
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def downdate_work(D: int, m: int, same: bool = True, batch: int = 1):
    """(flops, bytes) of `symmetric_downdate` over `batch` problems
    P [D, D], K and PHt [D, m], float32: with K = PHt the kernel forms the
    upper triangle of K·Kᵀ, D(D+1)/2 entries of 2m operations each, and
    reads P and K; with K ≠ PHt it forms the whole product and reads
    both."""
    flops = D * (D + 1) * m if same else 2 * D * D * m
    words = 2 * D * D + (1 if same else 2) * D * m
    return batch * flops, batch * 4 * words


def bound_s(flops: float, nbytes: float):
    """(least seconds, "operations" or "bytes") on one H100."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
