"""Zero-velocity update (ZUPT).

Counterpart of `open_vins_tpu/models/updater_zupt.py`
(UpdaterZeroVelocity parity, UpdaterZeroVelocity.cpp:58-329): a
6-rows-per-IMU-sample residual [ŵ ; â − R_GtoI g] whitened by √dt/σ, the
bias random-walk inflation over the frame gap, χ² + velocity-magnitude +
image-disparity gates, and an EKF update with no clone when the platform is
judged stationary (`try_zupt`), or the two-clone explicit zero-motion
variant (`try_zupt_explicit`).  Both return (state, accepted) with the
state selected on the device; the manager decides what the frame does with
`accepted`.  The samples are one batch over the IMU window and the previous
clone's columns are placed by a one-hot, so everything runs under
`torch.func.vmap`.
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.core import ekf
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import VioState, boxplus, select
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models.propagator import (ImuWindow, correct_imu,
                                                   propagate)
from open_vins_tpu_torch.ops import lie


def _cols(block, off, D):
    """block [..., r, w] placed at columns off..off+w of [..., r, D]."""
    w = block.shape[-1]
    E = torch.eye(D, dtype=block.dtype, device=block.device)[off:off + w]
    return block @ E


def _support(cfg: FilterConfig):
    """The static {θ, bg, ba} column support of the ZUPT rows."""
    return ((cfg.th_off, cfg.th_off + 3), (cfg.bg_off, cfg.ba_off + 3))


def build_system(state: VioState, cfg: FilterConfig, win: ImuWindow):
    """The stacked whitened ZUPT system (H [6K, D], res [6K], mask [6K])
    over the K samples of the window (UpdaterZeroVelocity.cpp:136-180, the
    direct acceleration constraint); rows of a zero-length step are zero."""
    D = cfg.state_dim
    dtype, dev = state.cov.dtype, state.cov.device
    gravity = torch.tensor([0.0, 0.0, cfg.gravity_mag], dtype=dtype,
                           device=dev)
    R_fej = lie.quat_2_rot(state.q_fej if cfg.use_fej else state.q)
    K = win.t.shape[0] - 1
    dt = torch.clamp(win.t[1:] - win.t[:-1], min=0.0)  # [K]
    valid = dt > 0
    sdt = torch.sqrt(torch.clamp(dt, min=1e-12))
    w_omega = (sdt / cfg.sigma_w)[:, None, None]
    w_accel = (sdt / cfg.sigma_a)[:, None, None]
    # bias- and IMU-intrinsic-corrected samples (the reference leaves the
    # intrinsic Jacobian columns out of the ZUPT, UpdaterZeroVelocity.cpp:136)
    w_hat, a_hat, _, _ = correct_imu(state, win.w[:K], win.a[:K],
                                     model=cfg.imu_model)
    res_w = -w_omega[..., 0] * w_hat
    res_a = -w_accel[..., 0] * (a_hat - lie.quat_2_rot(state.q) @ gravity)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(K, 3, 3)
    H_w = _cols(-w_omega * eye3, cfg.bg_off, D)  # [K, 3, D]
    H_a = (_cols(-w_accel * lie.skew(R_fej @ gravity), cfg.th_off, D)
           + _cols(-w_accel * eye3, cfg.ba_off, D))
    w = valid.to(dtype)
    H = torch.cat([H_w, H_a], dim=1) * w[:, None, None]  # [K, 6, D]
    res = torch.cat([res_w, res_a], dim=-1) * w[:, None]
    mask = valid[:, None].expand(K, 6)
    return H.reshape(6 * K, D), res.reshape(6 * K), mask.reshape(6 * K)


def _gates(state: VioState, cfg: FilterConfig, gamma, mask, disparity):
    """χ² (skipped with a zero multiplier, as in the reference), velocity
    and disparity gates (UpdaterZeroVelocity.cpp:198-247)."""
    dof = torch.clamp(mask.sum(dtype=torch.int32), min=1)
    ok = ((torch.linalg.vector_norm(state.v) < cfg.zupt_max_velocity)
          & (disparity < cfg.zupt_max_disparity))
    if cfg.zupt_chi2_multiplier > 0:
        ok = ok & torch.isfinite(gamma) & (
            gamma < ekf.chi2_gate(dof) * cfg.zupt_chi2_multiplier)
    if cfg.zupt_only_at_beginning:
        ok = ok & ~state.moved
    return ok


def _finish(state: VioState, new_state: VioState, t_new, accepted):
    """The attempt's state: the updated one at time t_new where accepted,
    else the input; `moved` set by a rejection (the reference's
    zupt_only_at_beginning bookkeeping)."""
    new_state = new_state.replace(
        t=torch.as_tensor(t_new, dtype=state.t.dtype, device=state.t.device))
    out = select(accepted, new_state, state)
    return out.replace(moved=out.moved | ~accepted), accepted


def try_zupt(state: VioState, cfg: FilterConfig, win: ImuWindow, t_new,
             disparity):
    """One zero-velocity update attempt (updater_zupt.py:77-128 of the
    reference).  The bias covariance is inflated by the random walk over
    the window, and γ and the update come out of one push-through solve on
    the 9-column {θ, bg, ba} support (`ekf.kalman_update_math_info`, whose
    downdate is `symmetric_downdate` at m = 9 with K ≠ PHt).
    Returns (state, accepted)."""
    D = cfg.state_dim
    dtype, dev = state.cov.dtype, state.cov.device
    H, res, mask = build_system(state, cfg, win)
    dt_sum = torch.clamp(win.t[-1] - win.t[0], min=0.0)
    idx = torch.arange(D, device=dev)
    q_diag = (((idx >= cfg.bg_off) & (idx < cfg.bg_off + 3)).to(dtype)
              * (dt_sum * cfg.sigma_wb ** 2)
              + ((idx >= cfg.ba_off) & (idx < cfg.ba_off + 3)).to(dtype)
              * (dt_sum * cfg.sigma_ab ** 2))
    cov_infl = state.cov + torch.diag(q_diag)
    inv_sq = torch.rsqrt(torch.tensor(cfg.zupt_noise_multiplier,
                                      dtype=dtype, device=dev))
    dx, cov_up, gamma = ekf.kalman_update_math_info(
        cov_infl, H * inv_sq, torch.where(mask, res, 0.0) * inv_sq,
        _support(cfg), return_gamma=True)
    accepted = _gates(state, cfg, gamma, mask, disparity)
    new_state = boxplus(state.replace(cov=cov_infl), cfg, dx).replace(
        cov=cov_up)
    return _finish(state, new_state, t_new, accepted)


def try_zupt_explicit(state: VioState, cfg: FilterConfig, win: ImuWindow,
                      t_new, disparity):
    """The two-clone explicit zero-motion variant (updater_zupt.py:131-211
    of the reference, UpdaterZeroVelocity.cpp:279-324 with
    explicitly_enforce_zero_motion): gated on the direct system's γ
    (`ekf.chi2_gamma_info`), then the state propagated to the frame time
    and its pose pinned to the newest clone with zero velocity (noise
    1e-2 rad, 1e-1 m, 1e-1 m/s), by one EKF update on the IMU and clone
    columns.  Returns (state, accepted)."""
    D = cfg.state_dim
    dtype, dev = state.cov.dtype, state.cov.device
    H_g, res_g, mask_g = build_system(state, cfg, win)
    inv_sq = torch.rsqrt(torch.tensor(cfg.zupt_noise_multiplier,
                                      dtype=dtype, device=dev))
    gamma = ekf.chi2_gamma_info(state.cov, H_g * inv_sq, res_g * inv_sq,
                                _support(cfg))
    accepted = (_gates(state, cfg, gamma, mask_g, disparity)
                & (state.n_clones > 0))

    st_p = propagate(state, cfg, win, t_new)
    head = torch.clamp(state.head, min=0).long()
    q0 = state.clones_q[head]
    R0 = lie.quat_2_rot(q0)
    R0_fej = lie.quat_2_rot(state.clones_q_fej[head] if cfg.use_fej else q0)
    res = torch.cat([lie.log_so3(R0 @ lie.quat_2_rot(st_p.q).T),
                     state.clones_p[head] - st_p.p, -st_p.v])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    H = torch.cat([_cols(-R0_fej, cfg.th_off, D), _cols(eye3, cfg.p_off, D),
                   _cols(eye3, cfg.v_off, D)])  # [9, D]
    # the previous clone's columns: +I on its θ, −I on its p, none when
    # the window is empty (head = −1)
    clone = torch.cat([torch.cat([eye3, z3], 1), torch.cat([z3, -eye3], 1),
                       torch.zeros((3, 6), dtype=dtype, device=dev)])
    cols = cfg.clones_off + 6 * state.head + torch.arange(6, device=dev)
    E = ((torch.arange(D, device=dev)[None, :] == cols[:, None])
         & (state.head >= 0)).to(dtype)  # [6, D]
    H = H + clone @ E
    r_diag = torch.cat([torch.full((3,), 1e-2 ** 2, dtype=dtype, device=dev),
                        torch.full((6,), 1e-1 ** 2, dtype=dtype, device=dev)])
    new_state = ekf.ekf_update(st_p, cfg, H, res, r_diag)
    return _finish(state, new_state, t_new, accepted)


def frame_disparity(table: ft.FeatureTable, cfg: FilterConfig, head_slot,
                    ids, uv, meas_mask):
    """Average pixel disparity between the incoming frame and the previous
    frame's observations (FeatureHelper::compute_disparity parity,
    FeatureHelper.h:60-123); 1e9 when no feature is in both."""
    dtype = table.uv.dtype
    head = torch.clamp(head_slot, min=0).long()
    total = torch.zeros((), dtype=dtype, device=table.uv.device)
    count = torch.zeros((), dtype=dtype, device=table.uv.device)
    for cam in range(cfg.num_cams):
        cam_ids = ids[cam]
        eq = table.ids[:, None] == cam_ids[None, :]  # [T, P]
        row = torch.argmax(eq.to(torch.int32), dim=0)
        has = eq.any(dim=0) & meas_mask[cam] & (cam_ids >= 0)
        prev_uv = table.uv[row, head, cam]  # [P, 2]
        prev_ok = (ft.obs_bit(table, row, head, torch.full_like(row, cam))
                   & (head_slot >= 0))
        d = torch.linalg.vector_norm(uv[cam] - prev_uv, dim=-1)
        ok = has & prev_ok
        total = total + torch.where(ok, d, 0.0).sum()
        count = count + ok.to(dtype).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), 1e9)
