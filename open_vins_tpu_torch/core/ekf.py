"""EKF core over the static state layout: χ² gate table, covariance
propagation, clone augmentation and marginalization, and the Kalman update
in its one-sweep form.

Counterpart of the main-path verbs of `open_vins_tpu/core/ekf.py`
(StateHelper parity).  "Marginalize" zeroes covariance rows/cols instead of
shrinking the matrix; padded measurement rows carry H=0, res=0, R=1 so they
are exact no-ops.  Ring-slot writes use index tensors, so nothing here waits
for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import VioState, boxplus, next_slot
from open_vins_tpu_torch.models.update_helper import take_cols
from open_vins_tpu_torch.ops.kernels import symmetric_downdate

_CHI2_MAX_DOF = 1024


def _build_chi2_table(q=0.95, max_dof=_CHI2_MAX_DOF):
    from scipy.stats import chi2 as _chi2

    dof = np.arange(1, max_dof + 1)
    return np.concatenate([[np.inf], _chi2.ppf(q, dof)]).astype(np.float32)


# 0.95 chi-square quantile by dof (UpdaterMSCKF.cpp:52-55), host constant
CHI2_95 = _build_chi2_table()
_chi2_on_device: dict[torch.device, torch.Tensor] = {}


def chi2_gate(dof):
    """0.95 chi-square threshold for an integer dof tensor."""
    table = _chi2_on_device.get(dof.device)
    if table is None:
        table = torch.as_tensor(CHI2_95, device=dof.device)
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
    (StateHelper::augment_clone, StateHelper.cpp:579-616).  The reused slot
    must already be marginalized (zero rows/cols)."""
    D = cfg.state_dim
    slot = next_slot(state, cfg)
    dtype, dev = state.cov.dtype, state.cov.device
    J = torch.zeros((6, D), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J[0:3, cfg.th_off:cfg.th_off + 3] = eye3
    J[3:6, cfg.p_off:cfg.p_off + 3] = eye3
    if cfg.calib_cam_timeoffset:
        J[:, cfg.calib_dt_off] = torch.cat([w_hat, state.v])

    new_rows = J @ state.cov  # [6, D]
    corner = new_rows @ J.T  # [6, 6]
    rows = _slot_index(slot, 6, cfg.clones_off)
    cov = state.cov.index_copy(0, rows, new_rows)
    cov = cov.index_copy(1, rows, new_rows.T)
    cov[rows[:, None], rows[None, :]] = corner

    clone_q_val, clone_p_val = state.q, state.p
    clone_q_fej_val, clone_p_fej_val = state.q_fej, state.p_fej
    if cfg.calib_cam_timeoffset:
        from open_vins_tpu_torch.core.state import _quat_boxplus

        # first-order clone at t_cam + dt_est (see the reference's note)
        dtau = state.calib_dt
        clone_q_val = _quat_boxplus(state.q, w_hat * dtau)
        clone_p_val = state.p + state.v * dtau
        clone_q_fej_val = _quat_boxplus(state.q_fej, w_hat * dtau)
        clone_p_fej_val = state.p_fej + state.v * dtau

    s = slot.long().reshape(1)
    return state.replace(
        cov=cov,
        clones_q=state.clones_q.index_copy(0, s, clone_q_val[None]),
        clones_p=state.clones_p.index_copy(0, s, clone_p_val[None]),
        clones_q_fej=state.clones_q_fej.index_copy(0, s, clone_q_fej_val[None]),
        clones_p_fej=state.clones_p_fej.index_copy(0, s, clone_p_fej_val[None]),
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


def kalman_update_math(cov, H, res, r_diag, ranges=None):
    """The dense update: (dx [D], new_cov [D,D]) in the one-sweep form.

    With L = chol(H P Hᵀ + R) and Y = L⁻¹[PHtᵀ | res]:
        dx = Y₁ᵀ y,   P⁺ = sym(P − Y₁ᵀ Y₁)
    — the downdate runs the `symmetric_downdate` kernel on CUDA.  `ranges`:
    static column support of H (rows exactly zero outside it); P·Hᵀ and S
    then contract over the support only.  A non-finite result (S indefinite
    in f32) turns the update into an exact no-op, selected on the device.
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
    K = Y1.T.contiguous()
    new_cov = symmetric_downdate(cov, K, K)
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
