"""Landmark parameterizations and the anchor-change transform.

Counterpart of `open_vins_tpu/models/landmark_rep.py`
(ov_core::LandmarkRepresentation, LandmarkRepresentation.h:38-45; the
representation Jacobians of UpdaterHelper::get_feature_jacobian_representation,
UpdaterHelper.cpp:32-190; UpdaterSLAM::perform_anchor_change,
UpdaterSLAM.cpp:481-647, as an exact covariance row transform).  Every
function is batched over leading dimensions; `rep` is a string.

The anchor is a (clone slot, camera) pair; the anchor camera frame A has
R_GtoA = R_ItoC R_GtoI_A and p_AinG = p_I_A − R_ItoG_A R_ItoCᵀ p_IinC.
λ is the stored 3-vector:
  GLOBAL_3D                     λ = p_FinG
  GLOBAL_FULL_INVERSE_DEPTH     λ = (θ, φ, ρ) of p_FinG
  ANCHORED_3D                   λ = p_FinA
  ANCHORED_FULL_INVERSE_DEPTH   λ = (θ, φ, ρ) of p_FinA
  ANCHORED_MSCKF_INVERSE_DEPTH  λ = (α, β, ρ), p_FinA = (α/ρ, β/ρ, 1/ρ)
  ANCHORED_INVERSE_DEPTH_SINGLE λ = (ρ, b_x, b_y), p_FinA = (b_x, b_y, 1)/ρ
with (θ, φ, ρ) ↦ (1/ρ)(cos θ sin φ, sin θ sin φ, cos φ).  Of the 1-dof
ANCHORED_INVERSE_DEPTH_SINGLE only ρ is a state variable; the bearing is
data (`updater_slam`).
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.ops import lie, smallmat

GLOBAL_3D = "GLOBAL_3D"
GLOBAL_FULL_INVERSE_DEPTH = "GLOBAL_FULL_INVERSE_DEPTH"
ANCHORED_3D = "ANCHORED_3D"
ANCHORED_FULL_INVERSE_DEPTH = "ANCHORED_FULL_INVERSE_DEPTH"
ANCHORED_MSCKF_INVERSE_DEPTH = "ANCHORED_MSCKF_INVERSE_DEPTH"
ANCHORED_INVERSE_DEPTH_SINGLE = "ANCHORED_INVERSE_DEPTH_SINGLE"


def is_anchored(rep: str) -> bool:
    return rep.startswith("ANCHORED")


def is_single(rep: str) -> bool:
    """True for the 1-dof representation (only ρ is in the state)."""
    return rep == ANCHORED_INVERSE_DEPTH_SINGLE


def needs_lam_jacobian(rep: str) -> bool:
    """True when λ is not the plain global xyz (∂p_FinG/∂λ ≠ I)."""
    return rep != GLOBAL_3D


def _safe(x):
    """x, with |x| ≤ 1e-8 replaced by 1e-8 (the reference's guard)."""
    return torch.where(torch.abs(x) > 1e-8, x, 1e-8)


def _stack3x3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _spherical_to_xyz(lam):
    th, phi, rho = lam[..., 0], lam[..., 1], _safe(lam[..., 2])
    return (1.0 / rho)[..., None] * torch.stack(
        [torch.cos(th) * torch.sin(phi), torch.sin(th) * torch.sin(phi),
         torch.cos(phi)], dim=-1)


def _xyz_to_spherical(p):
    n = torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1e-8)
    phi = torch.arccos(torch.clamp(p[..., 2] / n, -1.0, 1.0))
    th = torch.atan2(p[..., 1], p[..., 0])
    return torch.stack([th, phi, 1.0 / n], dim=-1)


def _spherical_jacobian(lam):
    """∂p/∂(θ, φ, ρ) (UpdaterHelper.cpp:58-70)."""
    th, phi, rho = lam[..., 0], lam[..., 1], _safe(lam[..., 2])
    s_t, c_t = torch.sin(th), torch.cos(th)
    s_p, c_p = torch.sin(phi), torch.cos(phi)
    inv = 1.0 / rho
    inv2 = inv * inv
    return _stack3x3([
        [-inv * s_t * s_p, inv * c_t * c_p, -inv2 * c_t * s_p],
        [inv * c_t * s_p, inv * s_t * c_p, -inv2 * s_t * s_p],
        [torch.zeros_like(inv), -inv * s_p, -inv2 * c_p],
    ])


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def anchor_frame(q_clone, p_clone, q_ext, p_ext):
    """(R_GtoA [..., 3, 3], p_AinG [..., 3]) of the anchor camera."""
    R_GtoI = lie.quat_2_rot(q_clone)
    R_ItoC = lie.quat_2_rot(q_ext)
    return R_ItoC @ R_GtoI, p_clone - _mv(R_GtoI.mT, _mv(R_ItoC.mT, p_ext))


def lam_to_pFinA(rep: str, lam):
    if rep in (ANCHORED_3D, GLOBAL_3D):
        return lam
    if rep == ANCHORED_MSCKF_INVERSE_DEPTH:
        rho = _safe(lam[..., 2])
        return torch.stack([lam[..., 0] / rho, lam[..., 1] / rho, 1.0 / rho],
                           dim=-1)
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        rho = _safe(lam[..., 0])
        return (1.0 / rho)[..., None] * torch.stack(
            [lam[..., 1], lam[..., 2], torch.ones_like(rho)], dim=-1)
    if rep in (ANCHORED_FULL_INVERSE_DEPTH, GLOBAL_FULL_INVERSE_DEPTH):
        return _spherical_to_xyz(lam)
    raise ValueError(rep)


def pFinA_to_lam(rep: str, p_FinA):
    if rep in (ANCHORED_3D, GLOBAL_3D):
        return p_FinA
    x, y, z = p_FinA[..., 0], p_FinA[..., 1], _safe(p_FinA[..., 2])
    if rep == ANCHORED_MSCKF_INVERSE_DEPTH:
        return torch.stack([x / z, y / z, 1.0 / z], dim=-1)
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        return torch.stack([1.0 / z, x / z, y / z], dim=-1)
    if rep in (ANCHORED_FULL_INVERSE_DEPTH, GLOBAL_FULL_INVERSE_DEPTH):
        return _xyz_to_spherical(p_FinA)
    raise ValueError(rep)


def to_global(rep: str, lam, q_clone, p_clone, q_ext, p_ext):
    """λ -> p_FinG given the anchor pose (ignored by the GLOBAL_* reps)."""
    if rep == GLOBAL_3D:
        return lam
    if rep == GLOBAL_FULL_INVERSE_DEPTH:
        return _spherical_to_xyz(lam)
    R_GtoA, p_AinG = anchor_frame(q_clone, p_clone, q_ext, p_ext)
    return _mv(R_GtoA.mT, lam_to_pFinA(rep, lam)) + p_AinG


def from_global(rep: str, p_FinG, q_clone, p_clone, q_ext, p_ext):
    """p_FinG -> λ given the anchor pose."""
    if rep == GLOBAL_3D:
        return p_FinG
    if rep == GLOBAL_FULL_INVERSE_DEPTH:
        return _xyz_to_spherical(p_FinG)
    R_GtoA, p_AinG = anchor_frame(q_clone, p_clone, q_ext, p_ext)
    return pFinA_to_lam(rep, _mv(R_GtoA, p_FinG - p_AinG))


def d_pFinG_d_lam(rep: str, lam, q_clone, q_ext):
    """[..., 3, 3] representation Jacobian ∂p_FinG/∂λ
    (UpdaterHelper.cpp:32-190)."""
    if rep == GLOBAL_3D:
        return torch.eye(3, dtype=lam.dtype, device=lam.device).expand(
            lam.shape[:-1] + (3, 3))
    if rep == GLOBAL_FULL_INVERSE_DEPTH:
        return _spherical_jacobian(lam)
    R_AtoG = (lie.quat_2_rot(q_ext) @ lie.quat_2_rot(q_clone)).mT
    if rep == ANCHORED_3D:
        return R_AtoG.expand(lam.shape[:-1] + (3, 3))
    if rep == ANCHORED_FULL_INVERSE_DEPTH:
        return R_AtoG @ _spherical_jacobian(lam)
    zero = torch.zeros_like(lam[..., 0])
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        # only the depth slot is state: ∂p_FinA/∂ρ = −b/ρ² with the fixed
        # bearing b = (b_x, b_y, 1); the bearing slots are data (zero
        # columns, UpdaterHelper.cpp:175-186)
        rho = _safe(lam[..., 0])
        b = torch.stack([lam[..., 1], lam[..., 2], torch.ones_like(rho)], -1)
        col = _mv(R_AtoG, -(1.0 / rho ** 2)[..., None] * b)
        return torch.stack([col, torch.zeros_like(col),
                            torch.zeros_like(col)], dim=-1)
    # MSCKF inverse depth: ∂p_FinA/∂(α, β, ρ)
    rho = _safe(lam[..., 2])
    d = _stack3x3([[1.0 / rho, zero, -lam[..., 0] / rho ** 2],
                   [zero, 1.0 / rho, -lam[..., 1] / rho ** 2],
                   [zero, zero, -1.0 / rho ** 2]])
    return R_AtoG @ d


def d_pFinG_d_anchor(rep: str, lam, q_clone, q_ext, p_ext):
    """(∂p_FinG/∂δθ_A, ∂p_FinG/∂δp_A), each [..., 3, 3], with respect to the
    anchor clone: with u = R_ItoCᵀ (p_FinA − p_IinC), −R_ItoG_A ⌊u⌋ and I
    (evaluated at FEJ values by the callers, UpdaterHelper.cpp:87-96)."""
    shape = lam.shape[:-1] + (3, 3)
    if not is_anchored(rep):
        z = torch.zeros(shape, dtype=lam.dtype, device=lam.device)
        return z, z
    R_GtoI = lie.quat_2_rot(q_clone)
    R_ItoC = lie.quat_2_rot(q_ext)
    u = _mv(R_ItoC.mT, lam_to_pFinA(rep, lam) - p_ext)
    eye = torch.eye(3, dtype=lam.dtype, device=lam.device).expand(shape)
    return -R_GtoI.mT @ lie.skew(u), eye


def anchor_change_jacobians(rep: str, lam_old, q_old, p_old, q_new, p_new,
                            q_ext, p_ext):
    """The exact transform that moves a landmark to a new anchor.

    Returns (lam_new, J_lam [..., 3, 3], J_xold [..., 3, 6],
    J_xnew [..., 3, 6]) with
        δλ_new = J_lam δλ_old + J_xold [δθ, δp]_old + J_xnew [δθ, δp]_new
    (UpdaterSLAM::perform_anchor_change, UpdaterSLAM.cpp:505-647, through
    dλ_n = (∂p_G/∂λ_n)⁻¹ (dp_G − (∂p_G/∂x_n) dx_n))."""
    p_G = to_global(rep, lam_old, q_old, p_old, q_ext, p_ext)
    lam_new = from_global(rep, p_G, q_new, p_new, q_ext, p_ext)
    dpG_dlam_o = d_pFinG_d_lam(rep, lam_old, q_old, q_ext)
    dth_o, dp_o = d_pFinG_d_anchor(rep, lam_old, q_old, q_ext, p_ext)
    dpG_dlam_n = d_pFinG_d_lam(rep, lam_new, q_new, q_ext)
    dth_n, dp_n = d_pFinG_d_anchor(rep, lam_new, q_new, q_ext, p_ext)
    x_o = torch.cat([dth_o, dp_o], dim=-1)
    x_n = torch.cat([dth_n, dp_n], dim=-1)

    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        # 1-dof: the left pseudo-inverse of the [3, 1] depth Jacobian
        # (UpdaterSLAM.cpp:617-621); the bearing rows stay zero
        h_n = dpG_dlam_n[..., :, 0]
        inv_n = h_n / torch.clamp(torch.sum(h_n * h_n, dim=-1),
                                  min=1e-12)[..., None]  # [..., 3]
        J_lam = torch.zeros_like(dpG_dlam_o)
        J_lam[..., 0, 0] = torch.sum(inv_n * dpG_dlam_o[..., :, 0], dim=-1)
        J_xold = torch.zeros_like(x_o)
        J_xnew = torch.zeros_like(x_n)
        J_xold[..., 0, :] = (inv_n[..., None, :] @ x_o)[..., 0, :]
        J_xnew[..., 0, :] = -(inv_n[..., None, :] @ x_n)[..., 0, :]
        return lam_new, J_lam, J_xold, J_xnew

    eye = torch.eye(3, dtype=lam_old.dtype, device=lam_old.device)
    inv_n = smallmat.inv3(dpG_dlam_n + 1e-12 * eye)
    return lam_new, inv_n @ dpG_dlam_o, inv_n @ x_o, -(inv_n @ x_n)
