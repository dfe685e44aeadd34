"""Batched 8-point fundamental-matrix RANSAC on normalized coordinates.

Counterpart of `open_vins_tpu/frontend/ransac.py` (TrackKLT.cpp:829-886:
cv::findFundamentalMat RANSAC on undistorted normalized points with the
threshold 2/max focal length): a fixed number of hypotheses, each the
normalized 8-point solution of one 8-subset (nullvector by twice-iterated
Gram-Schmidt, rank 2 enforced in closed form), all evaluated at once on
[K, ...] tensors; the hypothesis with the most inliers under the Sampson
distance wins.

The reference draws its 8-subsets by Gumbel top-k from `jax.random`, which
the port cannot reproduce, so drawing and deciding are separate here:
`draw_sets` takes its numbers from a `torch.Generator` that the caller
holds and seeds (`sampler` wraps one for the trackers), and
`ransac_from_sets` decides on given sets.  Handed the reference's sets, the
port decides as the reference does.
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.ops import smallmat

NUM_HYP = 64
# fixed projection seed of _null9's row complement (the reference's): it
# only needs a non-negligible component along the nullvector
_SEED9 = (0.31, -0.47, 0.22, 0.55, -0.13, 0.41, -0.29, 0.17, 0.23)


def _null9(A):
    """Unit nullvector of [..., 8, 9] A: twice-iterated classical
    Gram-Schmidt orthonormalizes the rows, then a fixed seed is projected
    onto their complement.  A rank-deficient sample returns one vector of
    its nullspace (a degenerate hypothesis that loses the vote)."""
    qs = []
    for i in range(A.shape[-2]):
        r = A[..., i, :]
        for _ in range(2):
            for q in qs:
                r = r - torch.sum(q * r, dim=-1, keepdim=True) * q
        n = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        qs.append(torch.where(n > 1e-12, r, torch.zeros_like(r))
                  / torch.clamp(n, min=1e-30))
    v = torch.as_tensor(_SEED9, dtype=A.dtype, device=A.device)
    v = v.expand(A.shape[:-2] + (9,))
    for _ in range(2):
        for q in qs:
            v = v - torch.sum(q * v, dim=-1, keepdim=True) * q
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def _rank2_project(F):
    """[..., 3, 3] F without its smallest singular direction: F(I − v₃v₃ᵀ),
    v₃ the smallest eigenvector of FᵀF from the cross product of the two
    most independent rows of FᵀF − λ₃I.  A near-rank-1 F stays as it is."""
    G = F.mT @ F
    lam = smallmat.eigvalsh3(G)[..., 0]
    B = G - lam[..., None, None] * torch.eye(3, dtype=F.dtype,
                                             device=F.device)
    cands = torch.stack([
        torch.linalg.cross(B[..., 0, :], B[..., 1, :]),
        torch.linalg.cross(B[..., 0, :], B[..., 2, :]),
        torch.linalg.cross(B[..., 1, :], B[..., 2, :]),
    ], dim=-2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    pick = torch.argmax(norms, dim=-1)
    v3 = torch.gather(cands, -2, pick[..., None, None].expand(
        pick.shape + (1, 3)))[..., 0, :]
    n = torch.linalg.vector_norm(v3, dim=-1)
    v3 = v3 / torch.clamp(n, min=1e-30)[..., None]
    proj = F - (F @ v3[..., None]) * v3[..., None, :]
    return torch.where((n > 1e-12)[..., None, None], proj, F)


def _hartley(p):
    """Isotropic normalization (Hartley '97) of [..., n, 2] points: center
    at the mean, mean radius √2.  Returns (normalized points, T [..., 3, 3])
    with p̃_h = T p_h."""
    c = torch.mean(p, dim=-2)
    d = p - c[..., None, :]
    s = (2.0 ** 0.5) / torch.clamp(torch.mean(torch.linalg.vector_norm(
        d, dim=-1), dim=-1), min=1e-12)
    z = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([torch.stack([s, z, -s * c[..., 0]], -1),
                     torch.stack([z, s, -s * c[..., 1]], -1),
                     torch.stack([z, z, one], -1)], -2)
    return s[..., None, None] * d, T


def _eight_point(p0, p1):
    """Normalized 8-point: p0, p1 [..., 8, 2] -> F [..., 3, 3] with
    p1ᵀ F p0 = 0."""
    q0, T0 = _hartley(p0)
    q1, T1 = _hartley(p1)
    x0, y0 = q0[..., 0], q0[..., 1]
    x1, y1 = q1[..., 0], q1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], dim=-1)  # [..., 8, 9]
    F = _rank2_project(_null9(A).reshape(A.shape[:-2] + (3, 3)))
    return T1.mT @ F @ T0


def _sampson_dist(F, p0, p1):
    """Sampson distances [..., N] of correspondences p0, p1 [N, 2] under
    F [..., 3, 3]."""
    ones = torch.ones_like(p0[:, :1])
    x0 = torch.cat([p0, ones], dim=1)  # [N, 3]
    x1 = torch.cat([p1, ones], dim=1)
    Fx0 = x0 @ F.mT  # [..., N, 3]
    Ftx1 = x1 @ F
    num = torch.sum(x1 * Fx0, dim=-1) ** 2
    den = (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2
           + Ftx1[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def draw_sets(mask, gen: torch.Generator, num_hyp: int = NUM_HYP):
    """[num_hyp, 8] random 8-subsets of the valid indices of mask [N], by
    Gumbel top-k (the reference's scheme) on numbers from `gen`, which lies
    on mask's device."""
    u = torch.rand((num_hyp, mask.shape[0]), generator=gen,
                   device=mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    score = torch.where(mask, g, torch.full_like(g, -torch.inf))
    return torch.topk(score, 8, dim=-1).indices


def sampler(gen: torch.Generator, num_hyp: int = NUM_HYP):
    """The trackers' source of hypothesis sets: mask [N] -> [num_hyp, 8]."""
    return lambda mask: draw_sets(mask, gen, num_hyp)


def ransac_from_sets(p0, p1, mask, sets, thresh):
    """RANSAC inlier mask of correspondences p0 -> p1 ([N, 2] normalized)
    on the given hypothesis sets [K, 8].

    thresh: the inlier threshold on the Sampson distance in normalized
    units (squared inside).  Returns (inlier_mask [N], best_F [3, 3]); with
    fewer than 12 valid correspondences every valid one passes."""
    valid_thresh = thresh ** 2
    Fs = _eight_point(p0[sets], p1[sets])  # [K, 3, 3]
    inl = (_sampson_dist(Fs, p0, p1) < valid_thresh) & mask  # [K, N]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)
    F = Fs[best]
    inliers = (_sampson_dist(F, p0, p1) < valid_thresh) & mask
    enough = torch.sum(mask) >= 12
    return torch.where(enough, inliers, mask), F
