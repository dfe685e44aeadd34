"""Trajectory error metrics: ATE, RPE, NEES, summary statistics.

Capability parity with ov_eval (ResultTrajectory.h:82-148, Statistics.h:39-120,
docs/eval-metric.dox definitions):
  * ATE: RMSE of orientation (deg) and position (m) after alignment,
  * RPE: relative pose error over segment lengths (e.g. 8,16,...,48 m),
  * NEES: normalized estimation error squared from recorded covariances,
  * Statistics: rmse/mean/median/std/max/min.

Pure numpy, offline; a copy of `open_vins_tpu/eval/metrics.py` whose NEES
takes the rotation log from the port's `ops/lie.py` (in float64).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from open_vins_tpu_torch.eval.alignment import align_trajectory, apply_alignment


@dataclass
class Stats:
    rmse: float
    mean: float
    median: float
    std: float
    max: float
    min: float

    @classmethod
    def of(cls, values):
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return cls(*([float("nan")] * 6))
        return cls(
            rmse=float(np.sqrt((v**2).mean())),
            mean=float(v.mean()),
            median=float(np.median(v)),
            std=float(v.std()),
            max=float(v.max()),
            min=float(v.min()),
        )


def _rot_err_deg(R_est, R_gt):
    """Geodesic angle between rotation pairs, degrees."""
    rel = np.einsum("nij,nkj->nik", R_gt, R_est)  # R_gt R_estᵀ
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def intersect_times(t_est, t_gt, tol=0.01):
    """Match est timestamps to gt (nearest within tol) — ResultTrajectory
    timestamp intersection parity.  Returns (idx_est, idx_gt)."""
    t_est = np.asarray(t_est)
    t_gt = np.asarray(t_gt)
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    left = np.abs(t_gt[j - 1] - t_est)
    right = np.abs(t_gt[j] - t_est)
    jj = np.where(left < right, j - 1, j)
    ok = np.abs(t_gt[jj] - t_est) < tol
    return np.where(ok)[0], jj[ok]


def ate(est_p, est_R, gt_p, gt_R, method="se3"):
    """Absolute trajectory error after alignment.

    Returns (Stats ori_deg, Stats pos_m), matching error_singlerun output.
    """
    s, R, t = align_trajectory(est_p, gt_p, method)
    p_a, R_a = apply_alignment(est_p, est_R, s, R, t)
    e_pos = np.linalg.norm(np.asarray(gt_p) - p_a, axis=1)
    e_ori = _rot_err_deg(R_a, np.asarray(gt_R))
    return Stats.of(e_ori), Stats.of(e_pos)


def ate_2d(est_p, est_R, gt_p, gt_R, method="posyaw"):
    """Planar absolute trajectory error (ResultTrajectory::calculate_ate_2d,
    ResultTrajectory.h:106-117 / .cpp): after alignment, position error in
    the x-y plane only and orientation error as yaw only (degrees).

    Returns (Stats yaw_deg, Stats pos2d_m).
    """
    s, R, t = align_trajectory(est_p, gt_p, method)
    p_a, R_a = apply_alignment(est_p, est_R, s, R, t)
    gt_p = np.asarray(gt_p)
    gt_R = np.asarray(gt_R)
    e_pos = np.linalg.norm(gt_p[:, :2] - p_a[:, :2], axis=1)
    # yaw of the relative rotation (z-axis heading difference)
    rel = np.einsum("nij,nkj->nik", gt_R, R_a)  # R_gt R_estᵀ
    yaw = np.degrees(np.arctan2(rel[:, 1, 0], rel[:, 0, 0]))
    return Stats.of(np.abs(yaw)), Stats.of(e_pos)


def rpe(est_p, est_R, gt_p, gt_R, segment_lengths=(8.0, 16.0, 24.0, 32.0, 40.0, 48.0)):
    """Relative pose error over distance segments (ResultTrajectory::calculate_rpe).

    Returns {length: (Stats ori_deg, Stats pos_m)}.
    """
    gt_p = np.asarray(gt_p, dtype=np.float64)
    est_p = np.asarray(est_p, dtype=np.float64)
    gt_R = np.asarray(gt_R, dtype=np.float64)
    est_R = np.asarray(est_R, dtype=np.float64)
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(gt_p, axis=0), axis=1))])
    out = {}
    for L in segment_lengths:
        e_ori, e_pos = [], []
        for i in range(len(gt_p)):
            j = np.searchsorted(dist, dist[i] + L)
            if j >= len(gt_p):
                break
            # relative motions
            dgt_R = gt_R[i].T @ gt_R[j]
            dgt_p = gt_R[i].T @ (gt_p[j] - gt_p[i])
            des_R = est_R[i].T @ est_R[j]
            des_p = est_R[i].T @ (est_p[j] - est_p[i])
            err_R = dgt_R.T @ des_R
            tr = np.clip((np.trace(err_R) - 1.0) / 2.0, -1.0, 1.0)
            e_ori.append(np.degrees(np.arccos(tr)))
            e_pos.append(np.linalg.norm(des_p - dgt_p))
        out[L] = (Stats.of(e_ori), Stats.of(e_pos))
    return out


def nees(est_p, est_R, gt_p, gt_R, cov6):
    """Pose NEES from per-sample 6x6 covariance [θ, p] (calculate_nees parity).

    Error convention matches the filter (JPL left): δθ = -log(R_gt R_estᵀ).
    Returns (Stats ori_nees, Stats pos_nees, Stats full6_nees).
    Vectorized: one batched log map and batched solves.
    """
    import torch

    from open_vins_tpu_torch.ops import lie

    gt_R = np.asarray(gt_R, dtype=np.float64)
    est_R = np.asarray(est_R, dtype=np.float64)
    rel = np.einsum("nij,nkj->nik", gt_R, est_R)  # R_gt R_estᵀ
    dth = -lie.log_so3(torch.from_numpy(rel)).numpy()
    dp = np.asarray(gt_p, dtype=np.float64) - np.asarray(est_p, np.float64)
    P = np.asarray(cov6, dtype=np.float64) + 1e-12 * np.eye(6)
    e_o = np.einsum("ni,ni->n", dth,
                    np.linalg.solve(P[:, :3, :3], dth[..., None])[..., 0])
    e_p = np.einsum("ni,ni->n", dp,
                    np.linalg.solve(P[:, 3:, 3:], dp[..., None])[..., 0])
    e6 = np.concatenate([dth, dp], axis=1)
    e_f = np.einsum("ni,ni->n", e6,
                    np.linalg.solve(P, e6[..., None])[..., 0])
    return Stats.of(e_o), Stats.of(e_p), Stats.of(e_f)
