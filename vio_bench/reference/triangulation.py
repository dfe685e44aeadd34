"""Batched feature triangulation: linear solve + damped Gauss-Newton.

A frozen copy of the port's `models/triangulation.py` (FeatureInitializer
parity, FeatureInitializer.cpp:30-422): anchor-frame linear triangulation
with condition and depth gates, then Levenberg-damped Gauss-Newton in the
anchor's inverse-depth coordinates (α, β, ρ).  Every function works on a
batch of F features at once ([F, O, ...] observation arrays).  The
Gauss-Newton loop runs a fixed `max_runs` iterations with the same accept
and reject masks as the reference and never exits early.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from vio_bench.reference import margin
from vio_bench.reference.state import TensorRecord
from vio_bench.plain import lie, smallmat


class TriangulationOptions(NamedTuple):
    """FeatureInitializerOptions parity."""

    refine: bool = True
    triangulate_1d: bool = False  # depth-only along the anchor bearing
    max_runs: int = 5
    init_lamda: float = 1e-3
    max_lamda: float = 1e10
    min_dx: float = 1e-6
    min_dcost: float = 1e-6
    lam_mult: float = 10.0
    min_dist: float = 0.10
    max_dist: float = 60.0
    max_cond_number: float = 10000.0


@dataclasses.dataclass
class FeatureObs(TensorRecord):
    """Observation sets in camera frames, batched over F features:
    R_GtoC [F, O, 3, 3], p_CinG [F, O, 3], uvn [F, O, 2], mask [F, O]."""

    R_GtoC: torch.Tensor
    p_CinG: torch.Tensor
    uvn: torch.Tensor
    mask: torch.Tensor


def _anchor_index(mask):
    """Newest valid observation per feature (-1 if none)."""
    O = mask.shape[-1]
    idx = torch.arange(O, device=mask.device)
    return torch.where(mask, idx, -1).amax(dim=-1)


def _take(x, a):
    """x[f, a[f]] per feature; zeros where a = -1 (the reference's one-hot
    lookup)."""
    a_c = torch.clamp(a, min=0)
    idx = a_c.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + x.shape[2:])
    val = torch.gather(x, 1, idx)[:, 0]
    ok = (a >= 0).reshape((-1,) + (1,) * (val.dim() - 1))
    return torch.where(ok, val, 0.0)


def _anchor_frame(obs: FeatureObs, a):
    """(R_GtoA [F,3,3], p_AinG [F,3], R_AtoC [F,O,3,3], p_CinA [F,O,3],
    b_A [F,O,3]): anchor pose, per-obs pose and unit bearing in the anchor."""
    R_GtoA = _take(obs.R_GtoC, a)
    p_AinG = _take(obs.p_CinG, a)
    R_AtoC = obs.R_GtoC @ R_GtoA.mT[:, None]
    p_CinA = (R_GtoA[:, None] @ (obs.p_CinG - p_AinG[:, None])[..., None]
              )[..., 0]
    b_C = torch.cat([obs.uvn, torch.ones_like(obs.uvn[..., :1])], dim=-1)
    b_C = b_C / torch.linalg.vector_norm(b_C, dim=-1, keepdim=True)
    b_A = (R_AtoC.mT @ b_C[..., None])[..., 0]
    return R_GtoA, p_AinG, R_AtoC, p_CinA, b_A


def _note_depth(p_A, mask, opts: TriangulationOptions):
    margin.note("depth", p_A[:, 2], opts.min_dist, mask, margin.DEPTH)
    margin.note("depth", p_A[:, 2], opts.max_dist, mask, margin.DEPTH)


def triangulate_linear(obs: FeatureObs, opts: TriangulationOptions):
    """3D linear triangulation in the anchor frame (single_triangulation,
    FeatureInitializer.cpp:30-112): rows N_o (p - p_o) = 0 with
    N_o = skew(bearing), solved through the 3×3 normal equations and gated
    on their condition number and on depth.
    Returns (p_G [F,3], valid [F], p_A [F,3], anchor [F])."""
    a = _anchor_index(obs.mask)
    R_GtoA, p_AinG, R_AtoC, p_CinA, b_A = _anchor_frame(obs, a)
    N = lie.skew(b_A)  # [F,O,3,3]
    w = obs.mask[..., None, None].to(b_A.dtype)
    NtN = N.mT @ N
    AtA = torch.sum(w * NtN, dim=1)
    Atb = torch.sum(w * (N.mT @ (N @ p_CinA[..., None])), dim=1)[..., 0]

    evals = smallmat.eigvalsh3(AtA)
    cond = evals[..., -1] / torch.clamp(evals[..., 0], min=1e-18)
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    p_A = smallmat.solve3(AtA + 1e-12 * eye, Atb)

    n_obs = obs.mask.sum(dim=-1)
    margin.note("cond", cond, opts.max_cond_number, n_obs >= 2, margin.COND)
    _note_depth(p_A, n_obs >= 2, opts)
    valid = ((n_obs >= 2) & (cond < opts.max_cond_number)
             & (p_A[:, 2] > opts.min_dist) & (p_A[:, 2] < opts.max_dist)
             & torch.isfinite(p_A).all(dim=-1))
    p_G = (R_GtoA.mT @ p_A[..., None])[..., 0] + p_AinG
    return p_G, valid, p_A, a


def triangulate_linear_1d(obs: FeatureObs, opts: TriangulationOptions):
    """Depth-only linear triangulation along the anchor bearing
    (single_triangulation_1d, FeatureInitializer.cpp:114-195).
    Returns (p_G [F,3], valid [F], p_A [F,3], anchor [F])."""
    a = _anchor_index(obs.mask)
    R_GtoA, p_AinG, R_AtoC, p_CinA, b_A = _anchor_frame(obs, a)
    bearing_A = _take(b_A, a)
    O = obs.mask.shape[-1]
    not_anchor = obs.mask & (torch.arange(O, device=a.device)[None]
                             != a[:, None])
    w = not_anchor.to(b_A.dtype)
    Bb = torch.linalg.cross(b_A, bearing_A[:, None].expand_as(b_A), dim=-1)
    Bp = torch.linalg.cross(b_A, p_CinA, dim=-1)
    A = torch.sum(w * torch.sum(Bb * Bb, dim=-1), dim=-1)
    b = torch.sum(w * torch.sum(Bb * Bp, dim=-1), dim=-1)
    depth = b / torch.where(torch.abs(A) > 1e-12, A, 1e-12)
    p_A = depth[:, None] * bearing_A
    n_obs = obs.mask.sum(dim=-1)
    valid = ((n_obs >= 2) & (p_A[:, 2] > opts.min_dist)
             & (p_A[:, 2] < opts.max_dist) & torch.isfinite(p_A).all(dim=-1))
    p_G = (R_GtoA.mT @ p_A[..., None])[..., 0] + p_AinG
    return p_G, valid, p_A, a


def refine_gauss_newton(obs: FeatureObs, p_A, anchor,
                        opts: TriangulationOptions):
    """Damped GN in anchor inverse depth (α, β, ρ) = (x/z, y/z, 1/z)
    (single_gaussnewton, FeatureInitializer.cpp:197-422), `max_runs` fixed
    iterations.  Returns (p_A_refined [F,3], base_cost [F], final_cost [F]).
    """
    _, _, R_AtoC, p_CinA, _ = _anchor_frame(obs, anchor)
    w = obs.mask.to(p_A.dtype)[..., None]  # [F,O,1]
    offs = -(R_AtoC @ p_CinA[..., None])[..., 0]  # [F,O,3]
    dtype, dev = p_A.dtype, p_A.device
    eye = torch.eye(3, dtype=dtype, device=dev)

    def residual(x):
        """r [F,O,2] and the pieces of its Jacobian."""
        ab1 = torch.stack([x[:, 0], x[:, 1], torch.ones_like(x[:, 0])], -1)
        h = (R_AtoC @ ab1[:, None, :, None])[..., 0] + x[:, 2, None, None] * offs
        big = torch.abs(h[..., 2]) > 1e-9
        hz = torch.where(big, h[..., 2], 1e-9)
        r = (h[..., :2] / hz[..., None] - obs.uvn) * w
        return r, h, hz, big

    def cost_of(r):
        return torch.sum(r * r, dim=(1, 2))

    def jacobian(h, hz, big):
        """∂r/∂(α, β, ρ): [F, 2O, 3] (forward-mode rule of the reference)."""
        dh = torch.stack([R_AtoC[..., :, 0], R_AtoC[..., :, 1], offs],
                         dim=-1)  # [F,O,3(h comp),3(param)]
        dhz = torch.where(big[..., None], dh[..., 2, :], 0.0)  # [F,O,3]
        inv_hz2 = hz ** -2
        dpred = (dh[..., :2, :] / hz[..., None, None]
                 + (-dhz[..., None, :] * h[..., :2, None])
                 * inv_hz2[..., None, None])  # [F,O,2,3]
        J = dpred * w[..., None]
        return J.reshape(J.shape[0], -1, 3)

    z = torch.clamp(p_A[:, 2], min=1e-6)
    x = torch.stack([p_A[:, 0] / z, p_A[:, 1] / z, 1.0 / z], dim=-1)
    r, _, _, _ = residual(x)
    cost0 = cost_of(r)
    cost = cost0
    lam = torch.full_like(cost0, opts.init_lamda)
    for _ in range(opts.max_runs):
        r, h, hz, big = residual(x)
        J = jacobian(h, hz, big)
        rf = r.reshape(r.shape[0], -1)
        JtJ = J.mT @ J
        Jtr = (J.mT @ rf[..., None])[..., 0]
        A = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1))
        dx = smallmat.solve3(A + 1e-12 * eye, Jtr)
        x_new = x - dx
        cost_new = cost_of(residual(x_new)[0])
        accept = cost_new < cost
        x = torch.where(accept[:, None], x_new, x)
        lam = torch.where(accept, lam / opts.lam_mult, lam * opts.lam_mult)
        lam = torch.clamp(lam, 1e-12, opts.max_lamda)
        cost = torch.where(accept, cost_new, cost)
    rho = torch.where(torch.abs(x[:, 2]) > 1e-6, x[:, 2], 1e-6)
    p_A_new = torch.stack([x[:, 0] / rho, x[:, 1] / rho, 1.0 / rho], dim=-1)
    return p_A_new, cost0, cost


def triangulate_batch(obs: FeatureObs, opts: TriangulationOptions):
    """Linear triangulation + optional GN refinement + gates for F features.
    Returns (p_G [F,3], valid [F])."""
    if opts.triangulate_1d:
        p_G, valid, p_A, a = triangulate_linear_1d(obs, opts)
    else:
        p_G, valid, p_A, a = triangulate_linear(obs, opts)
    if opts.refine:
        p_A2, cost0, cost = refine_gauss_newton(obs, p_A, a, opts)
        _note_depth(p_A2, obs.mask.sum(dim=-1) >= 2, opts)
        ok = ((p_A2[:, 2] > opts.min_dist) & (p_A2[:, 2] < opts.max_dist)
              & torch.isfinite(p_A2).all(dim=-1) & (cost <= cost0 + 1e-9))
        p_A = torch.where(ok[:, None], p_A2, p_A)
        # plain indexing, as the reference: an empty feature (a = -1) reads
        # the last observation slot
        a_w = (a % obs.mask.shape[-1]).long()
        f = torch.arange(a.shape[0], device=a.device)
        R_GtoA = obs.R_GtoC[f, a_w]
        p_AinG = obs.p_CinG[f, a_w]
        p_G = torch.where(ok[:, None],
                          (R_GtoA.mT @ p_A[..., None])[..., 0] + p_AinG, p_G)
    return p_G, valid
