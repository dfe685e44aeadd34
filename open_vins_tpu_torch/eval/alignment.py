"""Trajectory alignment: none / posyaw / se3 / sim3 (Umeyama).

Capability parity with ov_eval alignment (AlignTrajectory.h:46-115,
AlignUtils): closed-form Umeyama alignment with optional scale, the
yaw-only variant used for VIO (4-dof gauge freedom), and single-pose
alignment variants.

Pure numpy — evaluation is offline/host-side (same as the reference).
A copy of `open_vins_tpu/eval/alignment.py`: the port imports nothing of the
reference package.
"""

from __future__ import annotations

import numpy as np


def umeyama(est_p, gt_p, with_scale=False):
    """Closed-form s,R,t minimizing ||gt - (s R est + t)||² (Umeyama 1991).

    Returns (s, R [3,3], t [3]).
    """
    est = np.asarray(est_p, dtype=np.float64)
    gt = np.asarray(gt_p, dtype=np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    Sigma = gc.T @ ec / len(est)
    U, d, Vt = np.linalg.svd(Sigma)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec**2).sum() / len(est)
        s = float(np.trace(np.diag(d) @ S) / max(var_e, 1e-18))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def align_posyaw(est_p, gt_p):
    """Position + yaw-only alignment (the VIO gauge: 4 dof).

    AlignUtils::get_best_yaw parity: rotation restricted to z-axis.
    """
    est = np.asarray(est_p, dtype=np.float64)
    gt = np.asarray(gt_p, dtype=np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    # best yaw maximizes tr(R_z A) with A = Σ ec gcᵀ:
    # yaw* = atan2(A01 - A10, A00 + A11)
    A_m = ec.T @ gc
    yaw = np.arctan2(A_m[0, 1] - A_m[1, 0], A_m[0, 0] + A_m[1, 1])
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    t = mu_g - R @ mu_e
    return 1.0, R, t


def align_se3_single(est_p, gt_p, est_R0, gt_R0):
    """First-pose SE(3) alignment (AlignTrajectory se3_single): the gauge is
    fixed from the first pose pair only — R = R_g0 R_e0ᵀ, t = p_g0 − R p_e0.
    est_R0/gt_R0 are body-to-global rotations of the first poses."""
    R = np.asarray(gt_R0, np.float64) @ np.asarray(est_R0, np.float64).T
    t = np.asarray(gt_p, np.float64)[0] - R @ np.asarray(est_p, np.float64)[0]
    return 1.0, R, t


def align_posyaw_single(est_p, gt_p, est_R0, gt_R0):
    """First-pose position+yaw alignment (AlignTrajectory posyaw_single):
    only the yaw of R_g0 R_e0ᵀ is kept (4-dof VIO gauge from one pose)."""
    dR = np.asarray(gt_R0, np.float64) @ np.asarray(est_R0, np.float64).T
    yaw = np.arctan2(dR[1, 0], dR[0, 0])
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    t = np.asarray(gt_p, np.float64)[0] - R @ np.asarray(est_p, np.float64)[0]
    return 1.0, R, t


def align_trajectory(est_p, gt_p, method="se3", est_R0=None, gt_R0=None):
    """Dispatch over alignment methods (AlignTrajectory::align_trajectory).

    method: none | posyaw | se3 | sim3 | posyaw_single | se3_single.
    Returns (s, R, t) mapping est -> gt frame: p_aligned = s R p_est + t.
    The *_single variants fix the gauge from the first pose pair and need
    the first body-to-global rotations est_R0/gt_R0.
    """
    if method == "none":
        return 1.0, np.eye(3), np.zeros(3)
    if method == "posyaw":
        return align_posyaw(est_p, gt_p)
    if method == "se3":
        return umeyama(est_p, gt_p, with_scale=False)
    if method == "sim3":
        return umeyama(est_p, gt_p, with_scale=True)
    if method in ("posyaw_single", "se3_single"):
        if est_R0 is None or gt_R0 is None:
            raise ValueError(f"{method} needs est_R0/gt_R0 first rotations")
        f = align_se3_single if method == "se3_single" else align_posyaw_single
        return f(est_p, gt_p, est_R0, gt_R0)
    raise ValueError(f"unknown alignment method {method}")


def apply_alignment(est_p, est_R, s, R, t):
    """Apply (s,R,t) to positions [N,3] and rotations [N,3,3] (body-to-global)."""
    p = (s * (R @ np.asarray(est_p, dtype=np.float64).T)).T + t
    Rs = R @ np.asarray(est_R, dtype=np.float64)
    return p, Rs
