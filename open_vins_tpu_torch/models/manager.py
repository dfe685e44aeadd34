"""Per-frame VIO orchestration (the VioManager step).

Counterpart of `open_vins_tpu/models/manager.py` (VioManager.cpp:256-714).
One frame: with `use_zupt`, a zero-velocity update attempt that, when
accepted, consumes the frame without a clone (`updater_zupt`); otherwise
marginalize the oldest clone when the ring is full, propagate and clone,
ingest the frame's tracks and reserve SLAM promotions, then the vision
update:

  * `max_slam=0` (OpenVINS's pure-MSCKF mode): triage, triangulate,
    linearize, nullspace-project, χ²-gate, compress and apply one EKF
    update;
  * `max_slam>0` with the joint update (the default, the bench's operating
    point): the MSCKF rows, the SLAM-landmark rows and the delayed-init
    leftover rows are linearized at the pre-update state, whitened, stacked
    and applied as one EKF update in cfg.joint_update_form — "qr"
    (compressed once on the SLAM column support), "woodbury", "spd" or
    "newton" (the push-through forms of `core.ekf`) — after which dead
    landmarks are evicted;
  * `joint_vision_update=False` or `fast_compress` (the reference-exact
    sequential ordering): the MSCKF update, then the SLAM update, then
    delayed init with its own update of the leftover rows, then eviction.

The steps are separate functions (`marginalize_oldest`, `propagate_clone`,
`ingest`, `reserve_promotions`, `build_joint_system`, `joint_update`,
`sequential_update`) that `step_frame` chains.  Everything stays on the
device except, per frame, one read of the ZUPT decision (`ZUPT_FLAG_READ`)
and one of whether delayed init has work (see
`updater_slam.delayed_init`); with `batched=True` (the step under
`torch.func.vmap`) both branches run and each stream selects on the device.
Each stage runs inside a span (`utils.profiling.annotate`; `LEAF_SPANS`,
`PATH_SPANS`), a profiler range under a capture and an entry of the host
clock inside `profiling.host_clock()`, else a shared no-op.

Beside the step: `propagate_and_clone` (the background initializer's
catch-up primitive), `get_active_features` (the tracked features
re-triangulated for publishing), the two warm starts,
`initialize_from_gt` and `initialize_from_dynamic`, and
`seed_imu_intrinsics` (the YAML-seeded IMU intrinsics).
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
from open_vins_tpu_torch.models import updater_zupt as zupt
from open_vins_tpu_torch.models.feature_table import select_candidates
from open_vins_tpu_torch.models.propagator import ImuWindow, propagate
from open_vins_tpu_torch.ops import kernels, lie
from open_vins_tpu_torch.utils.profiling import annotate

# span around the step's one host read of the ZUPT decision
ZUPT_FLAG_READ = "zupt.flag_read"
# the step's spans (`utils.profiling.annotate`): the leaf spans that cover
# the MSCKF-only step (`ovt.step.table` opens more than once a step), then
# the spans of the other paths, whose MSCKF rows fall under the leaf spans
# through `msckf_build`; `ovt.step.joint_reduce` nests inside
# `ovt.step.joint_update`
LEAF_SPANS = ("ovt.step.marginalize", "ovt.step.propagate", "ovt.step.table",
              "ovt.step.triangulate", "ovt.step.linearize",
              "ovt.step.compress", "ovt.step.ekf_update")
PATH_SPANS = ("ovt.step.zupt", "ovt.step.slam_update",
              "ovt.step.delayed_init", "ovt.step.joint_update",
              "ovt.step.joint_reduce")


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
    n_joint_rows: torch.Tensor  # live rows of the joint "qr" stack, else 0


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
                tri_opts: tri.TriangulationOptions, reserved=None,
                compress=True):
    """Triage + triangulate + project + gate + compress — no state update
    (UpdaterMSCKF::update up to the EKFUpdate, UpdaterMSCKF.cpp:58-295,
    plus the triage of VioManager.cpp:366-500).  The Jacobians, nullspace
    projection and χ² statistic are one call of `kernels.msckf_linearize`
    (one kernel launch on CUDA, under vmap too).  `reserved` ([T] bool):
    rows reserved for SLAM promotion, excluded here.  `compress=False`
    returns the raw stacked rows (the joint update compresses once);
    `fast_compress` compresses by the normal equations over all D columns
    (ranges None).  Returns (H_c, res_c, ranges, table, diag)."""
    F = cfg.max_msckf_in_update
    D = cfg.state_dim
    T = table.ids.shape[0]

    with annotate("ovt.step.table"):  # triage
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

    with annotate("ovt.step.triangulate"):
        tri_obs, gobs = gather_feature_obs(state, cfg, table, rows)
        p_f, tri_ok = tri.triangulate_batch(tri_obs, tri_opts)
        # degenerate geometry can give inf/nan positions: gated out below,
        # but NaNs must never reach the stacked system
        tri_ok = tri_ok & torch.isfinite(p_f).all(dim=-1)
        p_f = torch.where(tri_ok[:, None], p_f,
                          torch.tensor([0.0, 0.0, 1.0], dtype=p_f.dtype,
                                       device=p_f.device))

    with annotate("ovt.step.linearize"):  # one kernel launch on CUDA
        H_proj, res_proj, n_rows, gamma = kernels.msckf_linearize(
            state, cfg, gobs, p_f)
        dof = torch.clamp(n_rows - 3, min=1)
        gate = ekf.chi2_gate(dof) * cfg.chi2_multiplier
        feat_ok = (sel_valid & tri_ok & torch.isfinite(gamma)
                   & (gamma < gate) & (n_rows >= 5))

        keep = feat_ok[:, None, None]
        H_big = torch.where(keep, H_proj, 0.0).reshape(-1, D)
        res_big = torch.where(keep[..., 0], res_proj, 0.0).reshape(-1)

    ranges = cfg.cam_meas_support_ranges
    if not compress:
        H_c, res_c = H_big, res_big
    elif cfg.fast_compress:
        with annotate("ovt.step.compress"):
            H_c, res_c = uh.compress_system_cholesky(H_big, res_big, D)
        ranges = None
    else:
        with annotate("ovt.step.compress"):
            H_c, res_c = uh.compress_system_ranges(H_big, res_big, ranges, D)

    with annotate("ovt.step.table"):
        # cleanup: every selected row dies whether or not its update passed
        # (UpdaterMSCKF.cpp:108-116); lost rows that can never triangulate
        # and zombie rows (measurements cleared, track ended) are freed too.
        # Rows equal to T are dropped, not written.
        selected = torch.zeros((T + 1,), dtype=torch.bool, device=rows.device)
        selected = selected.index_put((torch.clamp(rows, max=T),),
                                      sel_valid)[:T]
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
            n_joint_rows=zero_i,
        )
    return H_c, res_c, ranges, table, diag


def msckf_update(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                 tri_opts: tri.TriangulationOptions, reserved=None):
    """msckf_build + the EKF update (the sequential path).  With no rows
    accepted the update is an exact no-op (K = P·0).
    Returns (state, table, diag)."""
    H_c, res_c, ranges, table, diag = msckf_build(state, cfg, table,
                                                  tri_opts, reserved)
    with annotate("ovt.step.ekf_update"):
        r_diag = torch.full((H_c.shape[0],), cfg.sigma_pix**2,
                            dtype=H_c.dtype, device=H_c.device)
        state = ekf.ekf_update(state, cfg, H_c, res_c, r_diag, ranges=ranges)
    return state, table, diag


def marginalize_oldest(state: VioState, table: ft.FeatureTable,
                       cfg: FilterConfig):
    """Step 1: if the ring is full, move the landmarks anchored on the
    oldest clone to the newest (`updater_slam.change_anchors`, an identity
    for the global representations) and marginalize the oldest clone (a
    device-side select)."""
    with annotate("ovt.step.marginalize"):
        full = state.n_clones >= cfg.max_clones
        slot_old = oldest_slot(state, cfg)
        state_m = ekf.marginalize_clone(
            slam.change_anchors(state, cfg, slot_old), cfg, slot_old)
        return (select(full, state_m, state),
                select(full, ft.clear_clone_column(table, slot_old), table))


def propagate_clone(state: VioState, cfg: FilterConfig, frame: FrameInput):
    """Step 2: propagate to the frame time and clone."""
    with annotate("ovt.step.propagate"):
        state = propagate(state, cfg, frame.win, frame.t_new)
        return ekf.augment_clone(state, cfg, frame.win.w[-1] - state.bg)


def ingest(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
           frame: FrameInput):
    """Step 3: this frame's tracks into the table at the new head slot."""
    with annotate("ovt.step.table"):
        return ft.ingest_frame(table, cfg, state.head, frame.ids, frame.uv,
                               frame.uvn, frame.mask)


def reserve_promotions(state: VioState, table: ft.FeatureTable,
                       cfg: FilterConfig):
    """Step 4: the best full-window tracks reserved for SLAM promotion
    (VioManager.cpp:410-453), or None without SLAM."""
    if cfg.max_slam == 0:
        return None
    with annotate("ovt.step.table"):
        return slam.promotion_candidates(state, cfg, table)


def pre_update(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
               frame: FrameInput):
    """Steps 1-4: the state and table that the vision update starts from,
    and the reserved rows."""
    state, table = marginalize_oldest(state, table, cfg)
    state = propagate_clone(state, cfg, frame)
    table = ingest(state, table, cfg, frame)
    return state, table, reserve_promotions(state, table, cfg)


def build_joint_system(state: VioState, cfg: FilterConfig,
                       table: ft.FeatureTable,
                       tri_opts: tri.TriangulationOptions, reserved,
                       batched: bool = False):
    """The joint stack (manager.py:346-354 of the reference): the MSCKF,
    SLAM-landmark and delayed-init leftover rows, all linearized at the
    pre-update state, whitened to unit noise and stacked.  Delayed init
    inserts its landmarks into the state here (`batched`: see
    `updater_slam.delayed_init`).
    Returns (state, table, H [m, D], res [m], diag, n_used, cam_rows),
    cam_rows the (start, stop) row ranges that lie on the camera support:
    the MSCKF rows (first) and delayed init's leftover rows (last), the
    landmarks' rows between."""
    H1, r1, _, table, diag = msckf_build(state, cfg, table, tri_opts,
                                         reserved, compress=False)
    with annotate("ovt.step.slam_update"):
        state, table, H2, r2, _, n_used = slam.build_update(state, cfg,
                                                            table)
    with annotate("ovt.step.delayed_init"):
        state, table, _, H3, r3 = slam.delayed_init(
            state, cfg, table, tri_opts, gather_feature_obs, batched=batched)
    with annotate("ovt.step.joint_update"):  # the whitened stack
        s1, s2 = cfg.sigma_pix, cfg.sigma_pix_slam
        H = torch.cat([H1 / s1, H2 / s2, H3 / s2])
        res = torch.cat([r1 / s1, r2 / s2, r3 / s2])
    m = H.shape[0]
    cam_rows = ((0, H1.shape[0]), (m - H3.shape[0], m))
    return state, table, H, res, diag, n_used, cam_rows


def joint_update(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                 H, res, diag: StepDiag, n_used, cam_rows):
    """Apply the whitened joint stack as one EKF update on the SLAM column
    support in cfg.joint_update_form (manager.py:355-380 of the
    reference), evict dead landmarks:

      * "qr": reduced exactly to the support's rows
        (`update_helper.reduce_joint_system`, Householder only, under the
        `ovt.step.joint_reduce` span; the stack's live rows in
        `diag.n_joint_rows`), then the one-sweep update;
      * "woodbury": the push-through form, one LU (`ekf.ekf_update_info`);
      * "spd": the push-through form by two Choleskys (`ekf.ekf_update_spd`);
      * "newton": the push-through form by Newton inversion
        (`ekf.ekf_update_newton`), its solve residual in
        `diag.newton_resid`;

    any other value takes "qr", as in the reference."""
    ranges = cfg.slam_meas_support_ranges
    form = cfg.joint_update_form
    with annotate("ovt.step.joint_update"):
        if form == "woodbury":
            state = ekf.ekf_update_info(state, cfg, H, res, ranges)
        elif form == "spd":
            state = ekf.ekf_update_spd(state, cfg, H, res, ranges)
        elif form == "newton":
            state, nres = ekf.ekf_update_newton(state, cfg, H, res, ranges,
                                                return_resid=True)
            diag = diag.replace(newton_resid=nres)
        else:
            with annotate("ovt.step.joint_reduce"):
                H, res, n_rows = uh.reduce_joint_system(
                    H, res, ranges, cfg.state_dim, cam_rows,
                    cfg.cam_meas_support_ranges)
            diag = diag.replace(n_joint_rows=n_rows)
            r_diag = torch.ones((H.shape[0],), dtype=H.dtype,
                                device=H.device)
            state = ekf.ekf_update(state, cfg, H, res, r_diag, ranges=ranges)
        state, table = slam.evict(state, cfg, table)
        diag = diag.replace(n_slam=state.slam_valid.sum(dtype=torch.int32),
                            n_slam_used=n_used)
    return state, table, diag


def sequential_update(state: VioState, cfg: FilterConfig,
                      table: ft.FeatureTable,
                      tri_opts: tri.TriangulationOptions, reserved,
                      batched: bool = False):
    """The reference-exact ordering (manager.py:382-394 of the reference):
    the MSCKF update, then the SLAM-landmark update, then delayed init with
    the update of its leftover rows, each consuming its measurements from
    the table, then eviction.  Returns (state, table, diag)."""
    state, table, diag = msckf_update(state, cfg, table, tri_opts, reserved)
    if cfg.max_slam == 0:
        return state, table, diag
    with annotate("ovt.step.slam_update"):
        state, table, _, n_used = slam.update(state, cfg, table)
    with annotate("ovt.step.delayed_init"):
        state, table, _ = slam.delayed_init(state, cfg, table, tri_opts,
                                            gather_feature_obs,
                                            batched=batched, collect=False)
    with annotate("ovt.step.slam_update"):  # eviction
        state, table = slam.evict(state, cfg, table)
        diag = diag.replace(n_slam=state.slam_valid.sum(dtype=torch.int32),
                            n_slam_used=n_used)
    return state, table, diag


def _step_core(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
               tri_opts: tri.TriangulationOptions, frame: FrameInput,
               batched: bool):
    """The frame without ZUPT: steps 1-4, then the vision update."""
    state, table, reserved = pre_update(state, table, cfg, frame)
    if cfg.max_slam == 0:
        return msckf_update(state, cfg, table, tri_opts)
    if not cfg.joint_vision_update or cfg.fast_compress:
        return sequential_update(state, cfg, table, tri_opts, reserved,
                                 batched)
    state, table, H, res, diag, n_used, cam_rows = build_joint_system(
        state, cfg, table, tri_opts, reserved, batched=batched)
    return joint_update(state, cfg, table, H, res, diag, n_used, cam_rows)


def zupt_attempt(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
                 frame: FrameInput):
    """The frame's zero-velocity update attempt (manager.py:277-296 of the
    reference): (state after an accepted ZUPT, the diag of a ZUPT frame,
    accepted)."""
    disparity = zupt.frame_disparity(table, cfg, state.head, frame.ids,
                                     frame.uv, frame.mask)
    fn = zupt.try_zupt_explicit if cfg.zupt_explicit_motion else zupt.try_zupt
    z_state, accepted = fn(state, cfg, frame.win, frame.t_new, disparity)
    zero_i = torch.zeros((), dtype=torch.int32, device=state.cov.device)
    zero_f = torch.zeros((), dtype=state.cov.dtype, device=state.cov.device)
    z_diag = StepDiag(n_msckf=zero_i,
                      n_tracks=(table.ids >= 0).sum(dtype=torch.int32),
                      chi2_mean=zero_f,
                      n_slam=z_state.slam_valid.sum(dtype=torch.int32),
                      n_slam_used=zero_i, newton_resid=zero_f,
                      n_joint_rows=zero_i)
    return z_state, z_diag, accepted


def step_frame(state: VioState, table: ft.FeatureTable, cfg: FilterConfig,
               tri_opts: tri.TriangulationOptions, frame: FrameInput,
               batched: bool = False):
    """One frame (the module docstring).  Returns (state, table, diag).

    With `use_zupt` the ZUPT attempt runs first.  The reference chooses
    between the ZUPT frame and the normal frame by a `lax.cond`; here the
    decision is one host read of `accepted` (under the `ZUPT_FLAG_READ`
    span) and only the taken branch runs.  Rejected, the normal
    frame starts from the input state, as the reference's does.

    `batched=True` when the caller vmaps the step over streams
    (`runner.run_ensemble`): both branches run and each stream selects by
    its own flag on the device, and delayed init likewise selects its
    result per stream instead of reading its flag on the host."""
    if not cfg.use_zupt:
        return _step_core(state, table, cfg, tri_opts, frame, batched)
    with annotate("ovt.step.zupt"):
        z_state, z_diag, accepted = zupt_attempt(state, table, cfg, frame)
        if not batched:
            with annotate(ZUPT_FLAG_READ):
                accepted = bool(accepted)
    if batched:
        st, tb, diag = _step_core(state, table, cfg, tri_opts, frame, True)
        with annotate("ovt.step.zupt"):
            return (select(accepted, z_state, st),
                    select(accepted, table, tb),
                    select(accepted, z_diag, diag))
    if accepted:
        return z_state, table, z_diag
    return _step_core(state, table, cfg, tri_opts, frame, batched)


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


def initialize_from_dynamic(cfg: FilterConfig, res, t, calib_ext_q,
                            calib_ext_p, calib_intr) -> VioState:
    """Seed the filter from a dynamic-initializer solution
    (VioManagerHelper.cpp:78-146): the IMU mean of the MLE and its 15×15
    covariance from the Gauss-Newton information in the top-left block,
    instead of the groundtruth start's diagonal prior."""
    st = initialize_from_gt(cfg, res.q_GtoI, res.p, res.v, res.bg, res.ba, t,
                            calib_ext_q, calib_ext_p, calib_intr)
    cov = torch.cat([
        torch.cat([res.cov15.to(st.cov.dtype), st.cov[:15, 15:]], dim=1),
        st.cov[15:]])
    return st.replace(cov=cov)


def propagate_and_clone(state: VioState, cfg: FilterConfig, win: ImuWindow,
                        t_new) -> VioState:
    """Propagate to t_new and clone, marginalizing the oldest clone first
    when the ring is full — no measurement update (the catch-up replay
    primitive of background initialization, VioManagerHelper.cpp:156-163).
    The marginalized state is selected on the device over the whole record,
    out of place, so the function runs under `torch.func.vmap`."""
    full = state.n_clones >= cfg.max_clones
    slot_old = oldest_slot(state, cfg)
    state_m = ekf.marginalize_clone(slam.change_anchors(state, cfg, slot_old),
                                    cfg, slot_old)
    state = propagate(select(full, state_m, state), cfg, win, t_new)
    return ekf.augment_clone(state, cfg, win.w[-1] - state.bg)


def get_active_features(state: VioState, cfg: FilterConfig,
                        table: ft.FeatureTable,
                        tri_opts: tri.TriangulationOptions, max_feats: int):
    """The tracked features re-triangulated against the current clone
    window for publishing (VioManagerHelper::retriangulate_active_tracks,
    VioManagerHelper.cpp:190-461): the `max_feats` rows with the most
    observations, ties to the lowest row as `lax.top_k` breaks them.
    Returns (p_G [max_feats, 3], ids [max_feats], valid [max_feats])."""
    n_obs = ft.row_obs_counts(table)
    score = torch.where(table.ids >= 0, n_obs.to(torch.float32), -1.0)
    rows = select_candidates(score, max_feats)
    tri_obs, _ = gather_feature_obs(state, cfg, table, rows)
    p_f, ok = tri.triangulate_batch(tri_obs, tri_opts)
    ok = ok & torch.isfinite(p_f).all(dim=-1) & (score[rows] > 1)
    T = table.ids.shape[0]
    ids = torch.where(rows < T, table.ids[torch.clamp(rows, max=T - 1)], -1)
    return torch.where(ok[:, None], p_f, 0.0), ids, ok


def seed_imu_intrinsics(st: VioState, imu_calib) -> VioState:
    """Apply yaml-seeded IMU intrinsic initial values to a fresh state.

    Parity with the reference seeding state values from kalibr_imu_chain
    (StateOptions.h:141-146, VioManagerOptions.h:306-353, State.h:91-116):
    the filter starts from the calibrated Dw/Da/Tg and sensor-frame
    rotations rather than identity.  `imu_calib`: utils.config.ImuCalib."""
    kw = dict(dtype=st.cov.dtype, device=st.cov.device)
    return st.replace(
        imu_dw=torch.tensor(imu_calib.dw, **kw),
        imu_da=torch.tensor(imu_calib.da, **kw),
        imu_tg=torch.tensor(imu_calib.tg, **kw),
        imu_q_gyro=torch.tensor(imu_calib.q_gyro, **kw),
        imu_q_acc=torch.tensor(imu_calib.q_acc, **kw),
    )
