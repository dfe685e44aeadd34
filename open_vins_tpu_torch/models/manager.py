"""Per-frame VIO orchestration (the VioManager step), MSCKF-only slice.

Counterpart of `open_vins_tpu/models/manager.py` for `use_zupt=False` and
`max_slam=0`, i.e. OpenVINS's pure-MSCKF mode: marginalize the oldest clone
when the ring is full, propagate and clone, ingest the frame's tracks,
triage (lost / full-window), triangulate, linearize, nullspace-project,
χ²-gate, compress and apply one EKF update (VioManager.cpp:256-714).

Everything stays on the device: the full-ring selection is a field-wise
`torch.where`, the top-F candidate choice a stable sort, and nothing in a
step reads a tensor back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from open_vins_tpu_torch.core import ekf
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import (TensorRecord, VioState, init_state,
                                            oldest_slot, select)
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.models import update_helper as uh
from open_vins_tpu_torch.models import updater_slam as slam
from open_vins_tpu_torch.models.propagator import ImuWindow, propagate
from open_vins_tpu_torch.ops import lie


@dataclasses.dataclass
class FrameInput(TensorRecord):
    """All inputs for one camera frame (or a batch of frames, leading dim)."""

    win: ImuWindow  # IMU samples covering (t_prev, t_new]
    t_new: torch.Tensor  # scalar frame time (imu clock)
    ids: torch.Tensor  # [N, P] feature ids
    uv: torch.Tensor  # [N, P, 2] raw pixels
    uvn: torch.Tensor  # [N, P, 2] normalized
    mask: torch.Tensor  # [N, P]


@dataclasses.dataclass
class StepDiag(TensorRecord):
    n_msckf: torch.Tensor  # features used in the MSCKF update
    n_tracks: torch.Tensor  # live rows in the table
    chi2_mean: torch.Tensor
    n_slam: torch.Tensor  # active SLAM landmarks
    n_slam_used: torch.Tensor  # landmarks updated this frame
    newton_resid: torch.Tensor  # 0 outside the newton joint form


def gather_feature_obs(state: VioState, cfg: FilterConfig,
                       table: ft.FeatureTable, rows):
    """Per-feature observations + camera poses for table rows [F] (rows
    >= T are masked).  Returns (tri.FeatureObs [F, O], uh.GatheredObs)."""
    C, N = cfg.max_clones, cfg.num_cams
    O = C * N
    T = table.ids.shape[0]
    dev = state.cov.device
    slot_idx = torch.arange(C, device=dev).repeat_interleave(N)  # [O]
    cam_idx = torch.arange(N, device=dev).repeat(C)  # [O]

    # camera pose for every (slot, cam): R_GtoC = R_ItoC R_GtoI,
    # p_CinG = p_I - R_GtoIᵀ R_ItoCᵀ p_IinC
    R_GtoI = lie.quat_2_rot(state.clones_q[slot_idx])
    R_ItoC = lie.quat_2_rot(state.calib_ext_q[cam_idx])
    R_GtoC = R_ItoC @ R_GtoI
    p_CinG = state.clones_p[slot_idx] - (
        R_GtoI.mT @ (R_ItoC.mT @ state.calib_ext_p[cam_idx][..., None]))[..., 0]

    valid_row = rows < T
    rr = torch.clamp(rows, max=T - 1).long()
    bits = table.mbits[rr]  # [F, N]
    shifts = torch.arange(C, dtype=torch.int32, device=dev)
    m_cn = ((bits[:, None, :] >> shifts[None, :, None]) & 1) > 0  # [F, C, N]
    F = rows.shape[0]
    mask = (m_cn.reshape(F, O) & valid_row[:, None]
            & state.clone_valid[slot_idx][None, :])
    uv = table.uv[rr].reshape(F, O, 2)
    uvn = table.uvn[rr].reshape(F, O, 2)
    tri_obs = tri.FeatureObs(
        R_GtoC=R_GtoC.expand(F, O, 3, 3),
        p_CinG=p_CinG.expand(F, O, 3),
        uvn=uvn,
        mask=mask,
    )
    gobs = uh.GatheredObs(
        clone_slot=slot_idx.expand(F, O),
        cam=cam_idx.expand(F, O),
        uv=uv,
        uvn=uvn,
        mask=mask,
    )
    return tri_obs, gobs


def select_candidates(score, F: int):
    """Indices of the F best scores, ties broken by the lowest index (as
    jax.lax.top_k does; torch.topk promises no order among ties)."""
    return torch.sort(score, descending=True, stable=True).indices[:F]


def msckf_build(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                tri_opts: tri.TriangulationOptions):
    """Triage + triangulate + project + gate + compress — no state update
    (UpdaterMSCKF::update up to the EKFUpdate, UpdaterMSCKF.cpp:58-295,
    plus the triage of VioManager.cpp:366-500).
    Returns (H_c, res_c, ranges, table, diag)."""
    if cfg.fast_compress:
        raise NotImplementedError("fast_compress is not ported yet")
    F = cfg.max_msckf_in_update
    D = cfg.state_dim
    sigma = cfg.sigma_pix
    T = table.ids.shape[0]

    lost = ft.lost_rows(table)
    # full-window tracks become candidates only once the window is full
    window_full = state.n_clones >= cfg.max_clones
    fullw = ft.full_window_rows(table, state.n_clones, cfg) & window_full
    is_slam = slam.slam_row_mask(state, table)
    n_obs = ft.row_obs_counts(table)
    cand = (lost | fullw) & (n_obs >= 3) & ~is_slam
    # prefer long tracks
    score = torch.where(cand, n_obs.to(torch.float32), -1.0)
    rows = select_candidates(score, F)
    sel_valid = score[rows] > 0

    tri_obs, gobs = gather_feature_obs(state, cfg, table, rows)
    p_f, tri_ok = tri.triangulate_batch(tri_obs, tri_opts)
    # degenerate geometry can give inf/nan positions: gated out below, but
    # NaNs must never reach the stacked system
    tri_ok = tri_ok & torch.isfinite(p_f).all(dim=-1)
    p_f = torch.where(tri_ok[:, None], p_f,
                      torch.tensor([0.0, 0.0, 1.0], dtype=p_f.dtype,
                                   device=p_f.device))

    sup = cfg.cam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    ctx = uh.obs_context(state, cfg, gobs.clone_slot[0], gobs.cam[0])
    H_x, H_f, res, row_mask = uh.feature_jacobian_batch(
        state, cfg, gobs, p_f, p_f, ctx)
    H_proj, res_proj = uh.nullspace_project(H_x, H_f, res)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_proj, sup), res_proj,
                              sigma)
    n_rows = row_mask.sum(dim=-1, dtype=torch.int32)

    dof = torch.clamp(n_rows - 3, min=1)
    gate = ekf.chi2_gate(dof) * cfg.chi2_multiplier
    feat_ok = (sel_valid & tri_ok & torch.isfinite(gamma) & (gamma < gate)
               & (n_rows >= 5))

    keep = feat_ok[:, None, None]
    H_big = torch.where(keep, H_proj, 0.0).reshape(-1, D)
    res_big = torch.where(keep[..., 0], res_proj, 0.0).reshape(-1)

    ranges = cfg.cam_meas_support_ranges
    H_c, res_c = uh.compress_system_ranges(H_big, res_big, ranges, D)

    # cleanup: every selected row dies whether or not its update passed
    # (UpdaterMSCKF.cpp:108-116); lost rows that can never triangulate and
    # zombie rows (measurements cleared, track ended) are freed too.  Rows
    # equal to T are dropped, not written.
    selected = torch.zeros((T + 1,), dtype=torch.bool, device=rows.device)
    selected = selected.index_put((torch.clamp(rows, max=T),), sel_valid)[:T]
    used = selected & ~is_slam
    dead_lost = lost & ~is_slam & (n_obs < 3)
    zombie = (table.ids >= 0) & ~table.seen & (n_obs == 0) & ~is_slam
    table = ft.free_rows(table, dead_lost | used | zombie)

    n_ok = feat_ok.sum(dtype=torch.int32)
    zero_i = torch.zeros((), dtype=torch.int32, device=rows.device)
    diag = StepDiag(
        n_msckf=n_ok,
        n_tracks=(table.ids >= 0).sum(dtype=torch.int32),
        chi2_mean=torch.where(feat_ok, gamma, 0.0).sum()
        / torch.clamp(n_ok, min=1),
        n_slam=zero_i,
        n_slam_used=zero_i,
        newton_resid=torch.zeros((), dtype=H_c.dtype, device=rows.device),
    )
    return H_c, res_c, ranges, table, diag


def msckf_update(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                 tri_opts: tri.TriangulationOptions):
    """msckf_build + the EKF update (the sequential path).  With no rows
    accepted the update is an exact no-op (K = P·0).
    Returns (state, table, diag)."""
    H_c, res_c, ranges, table, diag = msckf_build(state, cfg, table,
                                                  tri_opts)
    r_diag = torch.full((H_c.shape[0],), cfg.sigma_pix**2, dtype=H_c.dtype,
                        device=H_c.device)
    state = ekf.ekf_update(state, cfg, H_c, res_c, r_diag, ranges=ranges)
    return state, table, diag


def step_frame(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
               tri_opts: tri.TriangulationOptions, frame: FrameInput):
    """One frame: marginalize-if-full → propagate + clone → ingest →
    MSCKF update.  Returns (state, table, diag)."""
    if cfg.use_zupt or cfg.max_slam > 0:
        raise NotImplementedError(
            "the port runs the MSCKF-only configuration (use_zupt=False, "
            "max_slam=0); ZUPT and SLAM come with later slices")
    C = cfg.max_clones
    # 1. marginalize the oldest clone if the ring is full (device-side
    #    select; with max_slam=0 there are no landmarks to re-anchor)
    full = state.n_clones >= C
    slot_old = oldest_slot(state, cfg)
    state = select(full, ekf.marginalize_clone(state, cfg, slot_old), state)
    table = select(full, ft.clear_clone_column(table, slot_old), table)

    # 2. propagate to the frame time and clone
    state = propagate(state, cfg, frame.win, frame.t_new)
    w_hat = frame.win.w[-1] - state.bg
    state = ekf.augment_clone(state, cfg, w_hat)

    # 3. ingest this frame's tracks at the new head slot
    table = ft.ingest_frame(table, cfg, state.head, frame.ids, frame.uv,
                            frame.uvn, frame.mask)

    # 4. MSCKF update
    return msckf_update(state, cfg, table, tri_opts)


def initialize_from_gt(cfg: FilterConfig, q, p, v, bg, ba, t,
                       calib_ext_q, calib_ext_p, calib_intr,
                       prior_std=None) -> VioState:
    """Groundtruth warm start (VioManagerHelper::initialize_with_gt,
    VioManagerHelper.cpp:40-76): IMU state and a diagonal prior, on the
    device of `q`."""
    dev, dtype = q.device, torch.float32
    st = init_state(cfg, dev, dtype)
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    st = st.replace(q=q, q_fej=q, p=p, p_fej=p, v=v, v_fej=v, bg=bg, ba=ba,
                    t=t, t_init=t, calib_ext_q=calib_ext_q,
                    calib_ext_p=calib_ext_p, calib_intr=calib_intr)
    if prior_std is None:
        prior_std = {"th": 0.02, "p": 0.001, "v": 0.01, "bg": 0.002,
                     "ba": 0.02}
    diag = torch.zeros((cfg.state_dim,), dtype=dtype, device=dev)
    for i, key in enumerate(("th", "p", "v", "bg", "ba")):
        diag[3 * i:3 * i + 3] = prior_std[key] ** 2
    return ekf.set_initial_covariance(st, cfg, diag)
