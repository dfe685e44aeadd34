"""The landmark representations the reference follows, and the exact
transform that moves an anchored landmark to a new anchor clone.

A frozen copy of the port's `models/landmark_rep.py`
(ov_core::LandmarkRepresentation; the representation Jacobians of
UpdaterHelper::get_feature_jacobian_representation, UpdaterHelper.cpp:32-190;
UpdaterSLAM::perform_anchor_change, UpdaterSLAM.cpp:481-647), cut to the two
representations `manager.check_config` admits for SLAM landmarks:

  GLOBAL_3D                     λ = p_FinG
  ANCHORED_MSCKF_INVERSE_DEPTH  λ = (α, β, ρ), p_FinA = (α/ρ, β/ρ, 1/ρ)

The anchor is a (clone slot, camera) pair; the anchor camera frame A has
R_GtoA = R_ItoC R_GtoI_A and p_AinG = p_I_A − R_ItoG_A R_ItoCᵀ p_IinC.
"""

from __future__ import annotations

import torch

from vio_bench.plain import lie, smallmat

GLOBAL_3D = "GLOBAL_3D"
ANCHORED_MSCKF_INVERSE_DEPTH = "ANCHORED_MSCKF_INVERSE_DEPTH"
FOLLOWED = (GLOBAL_3D, ANCHORED_MSCKF_INVERSE_DEPTH)


def is_anchored(rep: str) -> bool:
    return rep == ANCHORED_MSCKF_INVERSE_DEPTH


def _safe(x):
    """x, with |x| ≤ 1e-8 replaced by 1e-8 (the port's guard)."""
    return torch.where(torch.abs(x) > 1e-8, x, 1e-8)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def anchor_frame(q_clone, p_clone, q_ext, p_ext):
    """(R_GtoA [..., 3, 3], p_AinG [..., 3]) of the anchor camera."""
    R_GtoI = lie.quat_2_rot(q_clone)
    R_ItoC = lie.quat_2_rot(q_ext)
    return R_ItoC @ R_GtoI, p_clone - _mv(R_GtoI.mT, _mv(R_ItoC.mT, p_ext))


def _lam_to_pFinA(lam):
    rho = _safe(lam[..., 2])
    return torch.stack([lam[..., 0] / rho, lam[..., 1] / rho, 1.0 / rho],
                       dim=-1)


def _pFinA_to_lam(p):
    z = _safe(p[..., 2])
    return torch.stack([p[..., 0] / z, p[..., 1] / z, 1.0 / z], dim=-1)


def to_global(rep: str, lam, q_clone, p_clone, q_ext, p_ext):
    """λ -> p_FinG given the anchor pose (ignored by GLOBAL_3D)."""
    if not is_anchored(rep):
        return lam
    R_GtoA, p_AinG = anchor_frame(q_clone, p_clone, q_ext, p_ext)
    return _mv(R_GtoA.mT, _lam_to_pFinA(lam)) + p_AinG


def from_global(rep: str, p_FinG, q_clone, p_clone, q_ext, p_ext):
    """p_FinG -> λ given the anchor pose."""
    if not is_anchored(rep):
        return p_FinG
    R_GtoA, p_AinG = anchor_frame(q_clone, p_clone, q_ext, p_ext)
    return _pFinA_to_lam(_mv(R_GtoA, p_FinG - p_AinG))


def d_pFinG_d_lam(rep: str, lam, q_clone, q_ext):
    """[..., 3, 3] ∂p_FinG/∂λ (UpdaterHelper.cpp:32-190)."""
    if not is_anchored(rep):
        return torch.eye(3, dtype=lam.dtype).expand(lam.shape[:-1] + (3, 3))
    R_AtoG = (lie.quat_2_rot(q_ext) @ lie.quat_2_rot(q_clone)).mT
    rho = _safe(lam[..., 2])
    zero = torch.zeros_like(rho)
    d = torch.stack([
        torch.stack([1.0 / rho, zero, -lam[..., 0] / rho ** 2], dim=-1),
        torch.stack([zero, 1.0 / rho, -lam[..., 1] / rho ** 2], dim=-1),
        torch.stack([zero, zero, -1.0 / rho ** 2], dim=-1)], dim=-2)
    return R_AtoG @ d


def d_pFinG_d_anchor(rep: str, lam, q_clone, q_ext, p_ext):
    """(∂p_FinG/∂δθ_A, ∂p_FinG/∂δp_A), each [..., 3, 3], with respect to the
    anchor clone: with u = R_ItoCᵀ (p_FinA − p_IinC), −R_ItoG_A ⌊u⌋ and I;
    zero for GLOBAL_3D."""
    shape = lam.shape[:-1] + (3, 3)
    if not is_anchored(rep):
        z = torch.zeros(shape, dtype=lam.dtype)
        return z, z
    R_GtoI = lie.quat_2_rot(q_clone)
    R_ItoC = lie.quat_2_rot(q_ext)
    u = _mv(R_ItoC.mT, _lam_to_pFinA(lam) - p_ext)
    return -R_GtoI.mT @ lie.skew(u), torch.eye(3, dtype=lam.dtype).expand(
        shape)


def _inv3(A):
    """Inverse of [..., 3, 3] A by the adjugate, column by column."""
    eye = torch.eye(3, dtype=A.dtype)
    return torch.stack([smallmat.solve3(A, eye[j].expand(A.shape[:-1]))
                        for j in range(3)], dim=-1)


def anchor_change_jacobians(rep: str, lam_old, q_old, p_old, q_new, p_new,
                            q_ext, p_ext):
    """The exact transform that moves a landmark to a new anchor: (lam_new,
    J_lam [..., 3, 3], J_xold [..., 3, 6], J_xnew [..., 3, 6]) with
        δλ_new = J_lam δλ_old + J_xold [δθ, δp]_old + J_xnew [δθ, δp]_new
    through dλ_n = (∂p_G/∂λ_n)⁻¹ (dp_G − (∂p_G/∂x_n) dx_n)."""
    p_G = to_global(rep, lam_old, q_old, p_old, q_ext, p_ext)
    lam_new = from_global(rep, p_G, q_new, p_new, q_ext, p_ext)
    dth_o, dp_o = d_pFinG_d_anchor(rep, lam_old, q_old, q_ext, p_ext)
    dth_n, dp_n = d_pFinG_d_anchor(rep, lam_new, q_new, q_ext, p_ext)
    inv_n = _inv3(d_pFinG_d_lam(rep, lam_new, q_new, q_ext)
                  + 1e-12 * torch.eye(3, dtype=lam_old.dtype))
    return (lam_new, inv_n @ d_pFinG_d_lam(rep, lam_old, q_old, q_ext),
            inv_n @ torch.cat([dth_o, dp_o], dim=-1),
            -(inv_n @ torch.cat([dth_n, dp_n], dim=-1)))
