"""EKF core over the static state layout: χ² gate table, covariance
propagation, clone augmentation and marginalization and the Kalman update.

A frozen copy of the port's `core/ekf.py` (StateHelper parity), cut to the
reference's paths, with the covariance downdate in plain PyTorch where the
program runs its hand-written kernel.  "Marginalize" zeroes covariance
rows/cols instead of shrinking the matrix; padded measurement rows carry
H=0, res=0, R=1 so they are exact no-ops.  A singular or indefinite system
gives non-finite values, which the callers' gates and no-op selects catch.
"""

from __future__ import annotations

import numpy as np
import torch

from vio_bench.reference.layout import FilterConfig
from vio_bench.reference.state import VioState, boxplus, next_slot
from vio_bench.reference.update_helper import take_cols

_CHI2_MAX_DOF = 1024


def _build_chi2_table(q=0.95, max_dof=_CHI2_MAX_DOF):
    from scipy.stats import chi2 as _chi2

    dof = np.arange(1, max_dof + 1)
    return np.concatenate([[np.inf], _chi2.ppf(q, dof)]).astype(np.float32)


# 0.95 chi-square quantile by dof (UpdaterMSCKF.cpp:52-55), built at a
# device's first gate (scipy.stats takes seconds to import)
_chi2_on_device: dict[torch.device, torch.Tensor] = {}


def chi2_gate(dof):
    """0.95 chi-square threshold for an integer dof tensor."""
    table = _chi2_on_device.get(dof.device)
    if table is None:
        table = torch.as_tensor(_build_chi2_table(), device=dof.device)
        _chi2_on_device[dof.device] = table
    return table[torch.clamp(dof, 0, _CHI2_MAX_DOF).long()]


def propagate_covariance(cov, Phi, Qd, cfg: FilterConfig, B=None):
    """P <- Φ_full P Φ_fullᵀ + Q with Φ_full = [[Φ, B],[0, I]]: Φ on the IMU
    block, optional columns B [15,24] into the IMU-intrinsic block
    (StateHelper::EKFPropagation, StateHelper.cpp:33-114)."""
    d = cfg.imu_dim
    if B is None:
        new_ii = Phi @ cov[:d, :d] @ Phi.T + Qd
        new_ii = 0.5 * (new_ii + new_ii.T)
        new_ix = Phi @ cov[:d, d:]
        top = torch.cat([new_ii, new_ix], dim=1)
        bot = torch.cat([new_ix.T, cov[d:, d:]], dim=1)
        return torch.cat([top, bot], dim=0)

    gi, gd = cfg.imu_dw_off, cfg.imu_intr_dim
    J = torch.cat([Phi, B], dim=1)  # [15, 15+24]
    P_sel = torch.cat([cov[:d, :], cov[gi:gi + gd, :]], dim=0)
    rows_new = J @ P_sel  # [15, D]
    corner = rows_new[:, :d] @ Phi.T + rows_new[:, gi:gi + gd] @ B.T + Qd
    corner = 0.5 * (corner + corner.T)
    top = torch.cat([corner, rows_new[:, d:]], dim=1)
    bot = torch.cat([rows_new[:, d:].T, cov[d:, d:]], dim=1)
    return torch.cat([top, bot], dim=0)


def _slot_index(slot, width, offset):
    """[width] index tensor offset + width·slot + arange(width)."""
    return offset + width * slot.long() + torch.arange(width,
                                                       device=slot.device)


def augment_clone(state: VioState, cfg: FilterConfig, w_hat) -> VioState:
    """Stochastic cloning of the IMU pose into the next ring slot
    (StateHelper::augment_clone, StateHelper.cpp:579-616), without the time
    offset's column (`manager.check_config`).  The reused slot must already
    be marginalized (zero rows/cols)."""
    D = cfg.state_dim
    slot = next_slot(state, cfg)
    dtype, dev = state.cov.dtype, state.cov.device
    J = torch.zeros((6, D), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J[0:3, cfg.th_off:cfg.th_off + 3] = eye3
    J[3:6, cfg.p_off:cfg.p_off + 3] = eye3

    new_rows = J @ state.cov  # [6, D]
    corner = new_rows @ J.T  # [6, 6]
    rows = _slot_index(slot, 6, cfg.clones_off)
    cov = state.cov.index_copy(0, rows, new_rows)
    cov = cov.index_copy(1, rows, new_rows.T)
    cov[rows[:, None], rows[None, :]] = corner

    s = slot.long().reshape(1)
    return state.replace(
        cov=cov,
        clones_q=state.clones_q.index_copy(0, s, state.q[None]),
        clones_p=state.clones_p.index_copy(0, s, state.p[None]),
        clones_q_fej=state.clones_q_fej.index_copy(0, s, state.q_fej[None]),
        clones_p_fej=state.clones_p_fej.index_copy(0, s, state.p_fej[None]),
        clone_t=state.clone_t.index_copy(0, s, state.t.reshape(1)),
        clone_valid=state.clone_valid.index_fill(0, s, True),
        head=slot.to(torch.int32),
        n_clones=torch.clamp(state.n_clones + 1, max=cfg.max_clones),
    )


def marginalize_clone(state: VioState, cfg: FilterConfig, slot) -> VioState:
    """Drop a clone: zero its covariance rows/cols and free the slot
    (StateHelper::marginalize, StateHelper.cpp:271-339)."""
    off = cfg.clones_off + 6 * slot
    idx = torch.arange(cfg.state_dim, device=state.cov.device)
    keep = ~((idx >= off) & (idx < off + 6))
    cov = torch.where(keep[:, None] & keep[None, :], state.cov,
                      torch.zeros((), dtype=state.cov.dtype,
                                  device=state.cov.device))
    s = slot.long().reshape(1)
    return state.replace(
        cov=cov,
        clone_valid=state.clone_valid.index_fill(0, s, False),
        clone_t=state.clone_t.index_fill(0, s, -1.0),
        n_clones=torch.clamp(state.n_clones - 1, min=0),
    )


def active_mask(state: VioState, cfg: FilterConfig):
    """[D] bool mask of error-state entries that are currently estimated."""
    m = np.zeros(cfg.state_dim, dtype=bool)
    m[:cfg.imu_dim] = True
    if cfg.calib_cam_timeoffset:
        m[cfg.calib_dt_off] = True
    if cfg.calib_cam_extrinsics:
        m[cfg.calib_ext_off:cfg.calib_ext_off + 6 * cfg.num_cams] = True
    if cfg.calib_cam_intrinsics:
        m[cfg.calib_intr_off:cfg.calib_intr_off + 8 * cfg.num_cams] = True
    if cfg.calib_imu_intrinsics:
        m[cfg.imu_dw_off:cfg.imu_dw_off + 12] = True
        m[cfg.imu_thw_off:cfg.imu_thw_off + 3] = True
    if cfg.calib_imu_g_sensitivity:
        m[cfg.imu_tg_off:cfg.imu_tg_off + 9] = True
    mask = torch.as_tensor(m, device=state.cov.device)
    c0, c1 = cfg.clones_off, cfg.clones_off + 6 * cfg.max_clones
    s0, s1 = cfg.slam_off, cfg.slam_off + 3 * cfg.max_slam
    return torch.cat([mask[:c0],
                      torch.repeat_interleave(state.clone_valid, 6),
                      mask[c1:s0],
                      torch.repeat_interleave(state.slam_valid, 3),
                      mask[s1:]])


def set_initial_covariance(state: VioState, cfg: FilterConfig, diag):
    """Diagonal prior on the active blocks (StateHelper.cpp:199-224)."""
    mask = active_mask(state, cfg)
    return state.replace(cov=torch.diag(torch.where(mask, diag, 0.0)))


def symmetric_downdate(P, K, PHt):
    """sym(P − K·PHtᵀ)."""
    cov = P - K @ PHt.mT
    return 0.5 * (cov + cov.mT)


def kalman_update_math(cov, H, res, r_diag, ranges=None):
    """The dense update: (dx [D], new_cov [D,D]) in the one-sweep form.

    With L = chol(H P Hᵀ + R) and Y = L⁻¹[PHtᵀ | res]:
        dx = Y₁ᵀ y,   P⁺ = sym(P − Y₁ᵀ Y₁).
    `ranges`: static column support of H (rows exactly zero outside it);
    P·Hᵀ and S then contract over the support only.  A non-finite result
    turns the update into an exact no-op.
    """
    if ranges is not None:
        H_s = take_cols(H, ranges)  # [m, k]
        PHt = take_cols(cov, ranges) @ H_s.T  # [D, m]
        S = H_s @ take_cols(PHt.T, ranges).T + torch.diag(r_diag)
    else:
        PHt = cov @ H.T
        S = H @ PHt + torch.diag(r_diag)
    S = 0.5 * (S + S.T)
    L, info = torch.linalg.cholesky_ex(S)
    D = cov.shape[0]
    Yt = torch.linalg.solve_triangular(
        L, torch.cat([PHt.T, res[:, None]], dim=1), upper=False)
    Y1, y = Yt[:, :D], Yt[:, D]
    dx = Y1.T @ y
    new_cov = symmetric_downdate(cov, Y1.T, Y1.T)
    ok = ((info == 0) & torch.isfinite(dx).all()
          & torch.isfinite(new_cov).all())
    dx = torch.where(ok, dx, 0.0)
    new_cov = torch.where(ok, new_cov, cov)
    return dx, new_cov


def ekf_update(state: VioState, cfg: FilterConfig, H, res, r_diag,
               ranges=None) -> VioState:
    """Standard EKF update (StateHelper::EKFUpdate, StateHelper.cpp:116-197);
    padded rows must have H=0, res=0, r_diag=1."""
    dx, cov = kalman_update_math(state.cov, H, res, r_diag, ranges=ranges)
    return boxplus(state, cfg, dx).replace(cov=cov)
