"""One filter frame, the plain reference of `manager.step_frame`.

A frozen copy of the port's `models/manager.py` (the VioManager step,
VioManager.cpp:256-714), cut to the paths of two deployments of
OpenVINS's `config/euroc_mav/estimator_config.yaml` under rk4, with no
online calibration, ZUPT or aruco:

  * pure MSCKF (`max_slam=0`): marginalize the oldest clone when the ring
    is full, propagate and clone, ingest the frame's tracks, then triage,
    triangulate, linearize, nullspace-project, χ²-gate and apply one EKF
    update;
  * SLAM landmarks in the state (`max_slam>0`, the port's joint vision
    update in its "qr" form), as that file configures them
    (`feat_rep_slam: ANCHORED_MSCKF_INVERSE_DEPTH`) or stored as global
    points (GLOBAL_3D, the port's default): before the oldest clone is
    marginalized, the landmarks anchored on it move to the newest clone
    (`updater_slam.change_anchors`); after the ingest, the best
    full-window tracks are reserved for promotion; the MSCKF rows, the
    landmarks' rows (`updater_slam.build_update`) and the leftover rows of
    delayed init (`updater_slam.delayed_init`, which inserts the new
    landmarks into the state, anchored on the newest clone) are
    linearized at the pre-update state, whitened, stacked and applied as
    one EKF update on the SLAM column support; then dead landmarks are
    evicted (`updater_slam.evict`).

Made plain: one stream, no `torch.func.vmap`, no hand-written kernel, no
measurement compression.  Where the program compresses a stack (CholeskyQR2
on the SLAM support in the joint update, on the camera support in the
MSCKF update) and downdates with its hand-written kernel, this applies the
full stack in one Kalman update with the plain covariance downdate: the
same update in exact arithmetic.  The harness runs it in float64 on the
CPU.

Departures from OpenVINS beside the port's: the joint update is the
port's form, one update over the three row sets linearized at one state,
where OpenVINS updates in turn by the MSCKF rows, the SLAM rows and the
delayed-init rows, each at the state the last left (VioManager.cpp:520-544);
OpenVINS re-triangulates and updates new landmarks one by one, this inserts
up to `updater_slam.MAX_INIT_PER_FRAME` of them jointly; one camera where
the file runs the stereo pair, with no online calibration of the camera's
extrinsics, intrinsics or time offset where the file estimates them; the
track table and the landmark slots have static sizes.

`check_config` refuses a configuration outside these paths, by name.
"""

from __future__ import annotations

import dataclasses

import torch

from vio_bench.reference import ekf, margin
from vio_bench.reference.layout import FilterConfig
from vio_bench.reference.state import (TensorRecord, VioState, init_state,
                                            oldest_slot, select)
from vio_bench.reference import feature_table as ft
from vio_bench.reference import landmark_rep as lrep
from vio_bench.reference import triangulation as tri
from vio_bench.reference import update_helper as uh
from vio_bench.reference import updater_slam as slam
from vio_bench.reference.feature_table import select_candidates
from vio_bench.reference.propagator import ImuWindow, propagate
from vio_bench.plain import lie



def check_config(cfg: FilterConfig):
    """Raise unless `cfg` takes only the paths this reference follows,
    naming each option that leaves them: online calibration, another IMU
    model, no FEJ, ZUPT, aruco, an MSCKF representation other than
    GLOBAL_3D, a SLAM representation other than GLOBAL_3D and
    ANCHORED_MSCKF_INVERSE_DEPTH, the sequential ordering
    (`joint_vision_update` false, or `fast_compress`), a joint form other
    than "qr", gauge deflation, and an integration other than rk4 (ACI²,
    "analytical"; "discrete")."""
    plain = FilterConfig()
    fixed = ("calib_cam_timeoffset", "calib_cam_extrinsics",
             "calib_cam_intrinsics", "calib_imu_intrinsics",
             "calib_imu_g_sensitivity", "imu_model", "use_fej", "use_zupt",
             "feat_rep_msckf", "joint_vision_update", "gauge_deflation",
             "joint_update_form", "fast_compress", "num_aruco_tags")
    off = [k for k in fixed if getattr(cfg, k) != getattr(plain, k)]
    if cfg.feat_rep_slam not in lrep.FOLLOWED:
        off.append("feat_rep_slam")
    if cfg.integration != "rk4":
        off.append("integration")
    if off:
        raise ValueError(f"the reference does not follow {off}")


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


def msckf_build(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                tri_opts: tri.TriangulationOptions, reserved=None):
    """Triage + triangulate + project + gate — no state update
    (UpdaterMSCKF::update up to the EKFUpdate, UpdaterMSCKF.cpp:58-295,
    plus the triage of VioManager.cpp:366-500).  Rows of SLAM landmarks
    and `reserved` ([T] bool) rows, reserved for promotion, are not
    candidates.  Returns the stacked rows, uncompressed: (H, res, ranges,
    table, diag)."""
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
    if reserved is not None:
        cand = cand & ~reserved
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
    margin.note("chi2", gamma, gate, sel_valid & tri_ok & (n_rows >= 5),
                margin.CHI2)
    feat_ok = (sel_valid & tri_ok & torch.isfinite(gamma) & (gamma < gate)
               & (n_rows >= 5))

    keep = feat_ok[:, None, None]
    H_big = torch.where(keep, H_proj, 0.0).reshape(-1, D)
    res_big = torch.where(keep[..., 0], res_proj, 0.0).reshape(-1)

    H_c, res_c = H_big, res_big

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
    return H_c, res_c, cfg.cam_meas_support_ranges, table, diag


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


def marginalize_oldest(state: VioState, table: ft.FeatureTable,
                       cfg: FilterConfig):
    """Step 1: if the ring is full, move the landmarks anchored on the
    oldest clone to the newest (`updater_slam.change_anchors`, which
    leaves the state as it is without anchored landmarks) and marginalize
    the oldest clone (a select)."""
    full = state.n_clones >= cfg.max_clones
    slot_old = oldest_slot(state, cfg)
    state_m = ekf.marginalize_clone(slam.change_anchors(state, cfg, slot_old),
                                    cfg, slot_old)
    return (select(full, state_m, state),
            select(full, ft.clear_clone_column(table, slot_old), table))


def propagate_clone(state: VioState, cfg: FilterConfig, frame: FrameInput):
    """Step 2: propagate to the frame time and clone."""
    state = propagate(state, cfg, frame.win, frame.t_new)
    return ekf.augment_clone(state, cfg, frame.win.w[-1] - state.bg)


def ingest(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
           frame: FrameInput):
    """Step 3: this frame's tracks into the table at the new head slot."""
    return ft.ingest_frame(table, cfg, state.head, frame.ids, frame.uv,
                           frame.uvn, frame.mask)


def build_joint_system(state: VioState, cfg: FilterConfig,
                       table: ft.FeatureTable,
                       tri_opts: tri.TriangulationOptions, reserved):
    """The joint stack: the MSCKF, landmark and delayed-init leftover rows,
    all linearized at the pre-update state, whitened to unit noise and
    stacked.  Delayed init inserts its landmarks into the state here.
    Returns (state, table, H [m, D], res [m], diag, n_used)."""
    H1, r1, _, table, diag = msckf_build(state, cfg, table, tri_opts,
                                         reserved)
    state, table, H2, r2, n_used = slam.build_update(state, cfg, table)
    state, table, _, H3, r3 = slam.delayed_init(state, cfg, table, tri_opts,
                                                gather_feature_obs)
    s1, s2 = cfg.sigma_pix, cfg.sigma_pix_slam
    H = torch.cat([H1 / s1, H2 / s2, H3 / s2])
    res = torch.cat([r1 / s1, r2 / s2, r3 / s2])
    return state, table, H, res, diag, n_used


def joint_update(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                 H, res, diag: StepDiag, n_used):
    """The whitened joint stack as one EKF update on the SLAM column
    support, uncompressed, then eviction of dead landmarks.  Returns
    (state, table, diag)."""
    r_diag = torch.ones((H.shape[0],), dtype=H.dtype)
    state = ekf.ekf_update(state, cfg, H, res, r_diag,
                           ranges=cfg.slam_meas_support_ranges)
    state, table = slam.evict(state, cfg, table)
    return state, table, diag.replace(
        n_slam=state.slam_valid.sum(dtype=torch.int32), n_slam_used=n_used)


def step_frame(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
               tri_opts: tri.TriangulationOptions, frame: FrameInput):
    """One frame (the module docstring).  Returns (state, table, diag)."""
    state, table = marginalize_oldest(state, table, cfg)
    state = propagate_clone(state, cfg, frame)
    table = ingest(state, table, cfg, frame)
    if cfg.max_slam == 0:
        return msckf_update(state, cfg, table, tri_opts)
    reserved = slam.promotion_candidates(state, cfg, table)
    state, table, H, res, diag, n_used = build_joint_system(
        state, cfg, table, tri_opts, reserved)
    return joint_update(state, cfg, table, H, res, diag, n_used)


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
