"""Closed-form small-matrix algebra: 3×3 adjugate solve and inverse,
upper-triangular 3×3 inverse, symmetric 3×3 eigenvalues, and the
unrolled-Cholesky quadratic form of the χ² gates.

Counterpart of `open_vins_tpu/ops/smallmat.py`.  The same arithmetic in the
same order, so that gates near their thresholds decide alike in both
packages.
"""

from __future__ import annotations

import torch


def solve3(A, b, eps: float = 1e-12):
    """Solve A x = b for [..., 3, 3] A and [..., 3] b by the adjugate.

    Singular systems return a large-but-finite result (determinant clamped
    at eps); callers gate on conditioning."""
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = a22 * a33 - a23 * a32
    c12 = a13 * a32 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c21 = a23 * a31 - a21 * a33
    c22 = a11 * a33 - a13 * a31
    c23 = a13 * a21 - a11 * a23
    c31 = a21 * a32 - a22 * a31
    c32 = a12 * a31 - a11 * a32
    c33 = a11 * a22 - a12 * a21
    det = a11 * c11 + a12 * c21 + a13 * c31
    det = torch.where(torch.abs(det) < eps, torch.sign(det) * eps + eps, det)
    b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2]
    x1 = (c11 * b1 + c12 * b2 + c13 * b3) / det
    x2 = (c21 * b1 + c22 * b2 + c23 * b3) / det
    x3 = (c31 * b1 + c32 * b2 + c33 * b3) / det
    return torch.stack([x1, x2, x3], dim=-1)


def inv3(A, eps: float = 1e-12):
    """Inverse of [..., 3, 3] A by the adjugate, with `solve3`'s determinant
    clamp.  It stands in for the reference's `jnp.linalg.inv` (an LU
    solve): the two agree to rounding, and this one neither raises on a
    singular input nor waits on the device as `torch.linalg.inv` does."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    cols = [solve3(A, eye[j].expand(A.shape[:-1]), eps) for j in range(3)]
    return torch.stack(cols, dim=-1)


def chi2_quadform(S, b, floor: float = 1e-20):
    """γ = bᵀ S⁻¹ b for SPD [..., m, m] S by an unrolled Cholesky:
    γ = ‖L⁻¹ b‖², with no back-substitution.  `floor` guards the sqrt for
    degenerate inputs (callers gate on finiteness)."""
    m = S.shape[-1]
    L = torch.zeros_like(S)
    idx = torch.arange(m, device=S.device)
    for j in range(m):
        # s_i = S[i,j] - sum_k L[i,k] L[j,k]; entries k >= j are still zero
        s = S[..., :, j] - torch.sum(L * L[..., j:j + 1, :], dim=-1)
        d = torch.sqrt(torch.clamp(s[..., j], min=floor))
        col = s / d[..., None]
        L = L + (col * (idx >= j))[..., None] * (idx == j)
    y = torch.zeros_like(b)
    for i in range(m):
        yi = (b[..., i] - torch.sum(L[..., i, :] * y, dim=-1)) / L[..., i, i]
        y = y + yi[..., None] * (idx == i)
    return torch.sum(y * y, dim=-1)


def inv_upper3(U, eps: float = 1e-12):
    """Inverse of upper-triangular [..., 3, 3] U in closed form; diagonals
    are clamped at ±eps (callers gate degenerate systems separately)."""
    def _safe(d):
        s = torch.where(d < 0, -1.0, 1.0)
        return torch.where(torch.abs(d) < eps, s * eps, d)

    u11 = _safe(U[..., 0, 0])
    u22 = _safe(U[..., 1, 1])
    u33 = _safe(U[..., 2, 2])
    u12, u13, u23 = U[..., 0, 1], U[..., 0, 2], U[..., 1, 2]
    v11, v22, v33 = 1.0 / u11, 1.0 / u22, 1.0 / u33
    v12 = -u12 * v11 * v22
    v23 = -u23 * v22 * v33
    v13 = (u12 * u23 - u13 * u22) * v11 * v22 * v33
    z = torch.zeros_like(v11)
    return torch.stack([
        torch.stack([v11, v12, v13], dim=-1),
        torch.stack([z, v22, v23], dim=-1),
        torch.stack([z, z, v33], dim=-1),
    ], dim=-2)


def eigvalsh3(A):
    """Eigenvalues (ascending, [..., 3]) of symmetric [..., 3, 3] A by the
    trigonometric closed form (Smith 1961)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-38))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)  # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)  # smallest
    e2 = 3.0 * q - e1 - e3
    tiny = p2 < 1e-30  # near-spherical: all eigenvalues = q
    e1 = torch.where(tiny, q, e1)
    e2 = torch.where(tiny, q, e2)
    e3 = torch.where(tiny, q, e3)
    return torch.stack([e3, e2, e1], dim=-1)
