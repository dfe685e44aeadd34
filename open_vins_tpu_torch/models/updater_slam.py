"""SLAM landmark pipeline: delayed initialization, the landmark update and
eviction, for the joint per-frame vision update.

Counterpart of `open_vins_tpu/models/updater_slam.py` (UpdaterSLAM parity,
UpdaterSLAM.cpp:58-647) in the GLOBAL_3D representation, as the bench's
operating point runs it:

  * `promotion_candidates`: the full-window tracks reserved for SLAM this
    frame (VioManager.cpp:410-453 triage);
  * `build_update`: every in-state landmark's unconsumed measurements of the
    newest `slam_stack_clones` clones, χ²-gated, stacked — no state update;
    the consumed measurements are cleared from the table;
  * `delayed_init`: up to MAX_INIT_PER_FRAME mature tracks triangulated and
    inserted into free landmark slots jointly, with the leftover rows
    returned for the joint update (the reference's `collect=True` form);
  * `evict`: landmarks whose track died or that keep failing the gate are
    dropped (their covariance rows and columns zeroed).

Under GLOBAL_3D the stored λ is the global point p_FinG: the conversions
of the reference's `landmark_rep` are the identity, ∂p_FinG/∂λ = I, and
there is no anchor to change when a clone is marginalized
(`UpdaterSLAM::change_anchors` does nothing).  The other five
representations, aruco landmarks, the reference-exact sequential ordering
(`update`, `_delayed_init_sequential`) and `ekf.initialize_landmark` /
`marginalize_slam_slot` are not ported yet: `require_ported` raises for
them.  Lookups use plain indexing; the one-hot contractions of the
reference are TPU workarounds.
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.core import ekf
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import VioState, clone_age_order
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.models import update_helper as uh
from open_vins_tpu_torch.models.feature_table import FeatureTable
from open_vins_tpu_torch.ops import smallmat

MAX_FAIL = 2  # eviction on χ²-failure count (VioManager.cpp:476)
MAX_INIT_PER_FRAME = 6  # landmarks initialized per frame (static bound)
_INIT_VAR_CAP = 1e4  # max inserted landmark variance (units² of the rep):
# the delayed-init observability cap on σ²·Σ R1⁻¹² (see _delayed_init_work)
# profiler range around delayed_init's one host read of a device flag
INIT_FLAG_READ = "delayed_init.flag_read"


def require_ported(cfg: FilterConfig) -> None:
    """Raise for a SLAM configuration the port does not have yet."""
    if cfg.feat_rep_slam != "GLOBAL_3D":
        raise NotImplementedError(
            f"landmark representation {cfg.feat_rep_slam!r} is not ported "
            "yet (ROADMAP queue 1: the other five representations); use "
            "GLOBAL_3D")
    if cfg.num_aruco_tags > 0:
        raise NotImplementedError(
            "aruco landmarks (num_aruco_tags > 0) are not ported yet "
            "(ROADMAP queue 1)")


def slam_row_mask(state: VioState, table: FeatureTable):
    """[T] bool — table rows whose id is an active SLAM landmark."""
    eq = table.ids[:, None] == state.slam_id[None, :]  # [T, L]
    return torch.any(eq & state.slam_valid[None, :]
                     & (table.ids[:, None] >= 0), dim=1)


def _set_slam_cols(H_x, cfg: FilterConfig, H_lam):
    """Place landmark l's columns [l, rows, 3] at its slot's columns of
    H_x [L, rows, D] (the landmark block of H_x is all-zero, so add ==
    set)."""
    L, rows, _ = H_lam.shape
    cols = (cfg.slam_off + 3 * torch.arange(L, device=H_x.device)[:, None]
            + torch.arange(3, device=H_x.device)[None, :])  # [L, 3]
    return H_x.scatter(2, cols[:, None, :].expand(L, rows, 3), H_lam)


def _set_rows(a, idx, vals):
    """a[idx] = vals with the index len(a) meaning "drop" (the reference's
    `.at[idx].set(vals, mode="drop")`)."""
    pad = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    return pad.index_copy(0, idx, vals)[:-1]


def _mark_rows(T, rows, flags):
    """[T] bool with flags[i] at rows[i] (rows distinct, in [0, T))."""
    return torch.zeros((T,), dtype=torch.bool,
                       device=rows.device).index_put((rows,), flags)


def _init_scores(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """(score [T], n_free): the observation count of every full-window row
    not yet a landmark (-1 elsewhere, and everywhere before the window is
    full and dt_slam_delay has passed), and the free landmark slots."""
    delay_ok = (state.t - state.t_init) >= cfg.dt_slam_delay
    window_full = (state.n_clones >= cfg.max_clones) & delay_ok
    fullw = ft.full_window_rows(table, state.n_clones, cfg) & window_full
    cand = fullw & ~slam_row_mask(state, table)
    score = torch.where(cand, ft.row_obs_counts(table).to(torch.float32),
                        -1.0)
    return score, (~state.slam_valid).sum(dtype=torch.int32)


def promotion_candidates(state: VioState, cfg: FilterConfig,
                         table: FeatureTable):
    """[T] bool — rows reserved for SLAM promotion this frame: the
    longest-tracked full-window rows, bounded by the free slot count and the
    per-frame init cap (VioManager.cpp:410-453 triage)."""
    require_ported(cfg)
    score, n_free = _init_scores(state, cfg, table)
    budget = torch.clamp(n_free, max=MAX_INIT_PER_FRAME)
    T = table.ids.shape[0]
    rows = ft.select_candidates(score, min(MAX_INIT_PER_FRAME, T))
    take = (score[rows] > 0) & (torch.arange(rows.shape[0],
                                             device=rows.device) < budget)
    return _mark_rows(T, rows, take)


def delayed_init(state: VioState, cfg: FilterConfig, table: FeatureTable,
                 tri_opts: tri.TriangulationOptions, gather_fn):
    """Promote up to MAX_INIT_PER_FRAME mature tracks into free SLAM slots
    by the joint batched delayed initialization (StateHelper::initialize
    parity, UpdaterSLAM.cpp:100-240): the landmarks enter the covariance
    here; their leftover measurement rows are returned for the joint EKF
    update (the reference's `collect=True`).

    gather_fn(state, cfg, table, rows) -> (tri_obs, gobs) is the manager's
    `gather_feature_obs`.  Returns (state, table, n_init,
    H_up [F·(2·C·N−3), D], res_up) with row noise cfg.sigma_pix_slam (zero
    rows when nothing was initialized).

    The reference skips the init block behind a `lax.cond`; here the
    decision is one read of a device flag on the host per frame (`if`),
    and the block runs only when there is work."""
    require_ported(cfg)
    F = MAX_INIT_PER_FRAME
    D = cfg.state_dim
    dt, dev = state.cov.dtype, state.cov.device
    up_rows = F * (2 * cfg.max_clones * cfg.num_cams - 3)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nothing = (state, table, zero_i, torch.zeros((up_rows, D), dtype=dt,
                                                 device=dev),
               torch.zeros((up_rows,), dtype=dt, device=dev))
    if cfg.max_slam == 0:
        return nothing

    score, n_free = _init_scores(state, cfg, table)
    rows = ft.select_candidates(score, F)
    cand_ok = score[rows] > 0
    with torch.profiler.record_function(INIT_FLAG_READ):
        any_work = bool(torch.any(cand_ok) & (n_free > 0))
    if not any_work:
        return nothing
    return _delayed_init_work(state, cfg, table, tri_opts, gather_fn, rows,
                              cand_ok)


def _delayed_init_work(state: VioState, cfg: FilterConfig,
                       table: FeatureTable,
                       tri_opts: tri.TriangulationOptions, gather_fn, rows,
                       cand_ok):
    """The joint batched init body (see `delayed_init`)."""
    L, D = cfg.max_slam, cfg.state_dim
    F = MAX_INIT_PER_FRAME
    sigma = cfg.sigma_pix_slam
    dtype, dev = state.cov.dtype, state.cov.device
    T = table.ids.shape[0]
    n_free = (~state.slam_valid).sum(dtype=torch.int32)

    tri_obs, gobs = gather_fn(state, cfg, table, rows)
    p_f, tri_ok = tri.triangulate_batch(tri_obs, tri_opts)
    tri_ok = tri_ok & torch.isfinite(p_f).all(dim=-1)
    p_f = torch.where(tri_ok[:, None], p_f,
                      torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
    feat_ids = torch.where(rows < T, table.ids[torch.clamp(rows, max=T - 1)],
                           -1)
    slot_ids = torch.arange(L, device=dev)
    free_order = torch.sort(torch.where(~state.slam_valid, slot_ids,
                                        L)).values

    # rotated init system of every candidate (pre-frame linearization);
    # GLOBAL_3D: λ = p_FinG, so the point rows are the λ rows
    ctx0 = uh.obs_context(state, cfg, gobs.clone_slot[0], gobs.cam[0])
    H_x, H_lam, res, row_mask = uh.feature_jacobian_batch(state, cfg, gobs,
                                                          p_f, p_f, ctx0)

    # kill non-finite/absurd rows BEFORE the QR: a rejected candidate keeps
    # the [0,0,1] placeholder point, whose projection can overflow; one bad
    # row would NaN the whole rotation, and the insertion masks by product
    def _bad(M):
        return ~torch.isfinite(M) | (torch.abs(M) > 1e8)

    bad_x, bad_l, bad_r = _bad(H_x), _bad(H_lam), _bad(res)
    extra_ok = ~(bad_x.any(dim=(1, 2)) | bad_l.any(dim=(1, 2))
                 | bad_r.any(dim=1))
    n_valid = row_mask.sum(dim=-1, dtype=torch.int32)
    rm = row_mask[..., None]
    H_lam_m = torch.where(rm & ~bad_l, H_lam, 0.0)
    H_x_m = torch.where(rm & ~bad_x, H_x, 0.0)
    res_m = torch.where(row_mask & ~bad_r, res, 0.0)
    R_full, Br = uh.householder_rotate(
        H_lam_m, torch.cat([H_x_m, res_m[..., None]], dim=-1))
    Hx_rot, res_rot = Br[..., :-1], Br[..., -1]
    R1, Hx1, res1 = R_full[:, :3, :3], Hx_rot[:, :3], res_rot[:, :3]
    H_up, res_up = Hx_rot[:, 3:], res_rot[:, 3:]

    # attempt budget first (feats_slam is sized to the open slots,
    # VioManager.cpp:410-453), then the quality gates; failed attempts are
    # consumed below so they cannot block the candidate queue
    attempt_rank = torch.cumsum(cand_ok.to(torch.int32), dim=0) - 1
    attempted = cand_ok & (attempt_rank < n_free)
    ok = attempted & tri_ok & extra_ok
    # χ² gate on the leftover rows (pre-init covariance, support columns)
    sup = cfg.cam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_up, sup), res_up, sigma)
    dof = torch.clamp(n_valid - 3, min=1)
    ok = (ok & torch.isfinite(gamma)
          & (gamma < ekf.chi2_gate(dof) * cfg.chi2_multiplier_slam))

    # R1⁻¹ and the observability cap: a nearly singular landmark factor
    # would insert an astronomical landmark covariance into P, and the joint
    # update's support spans every landmark column — refuse it instead
    R1inv_raw = smallmat.inv_upper3(R1)
    var_proxy = sigma ** 2 * torch.sum(R1inv_raw ** 2, dim=(1, 2))
    ok = ok & torch.isfinite(var_proxy) & (var_proxy < _INIT_VAR_CAP)

    rank = torch.cumsum(ok.to(torch.int32), dim=0) - 1
    slot = free_order[torch.clamp(torch.where(ok, rank, 0), 0, L - 1)]
    slot_eff = torch.where(ok, slot, L)  # L = dropped

    okf = ok.to(dtype)
    R1inv = R1inv_raw * okf[:, None, None]

    # joint covariance insertion (StateHelper.cpp:484-577, stacked):
    #   P_fX = −R1⁻¹ Hx1 P ;  P_FF = R1⁻¹ (Hx1 P Hx1ᵀ + σ² I) R1⁻ᵀ
    X = (Hx1 * okf[:, None, None]).reshape(F * 3, D)
    HxP = X @ state.cov  # [F·3, D]
    Bflat = torch.block_diag(*R1inv)  # [F·3, F·3]
    G = HxP @ X.T + sigma ** 2 * torch.eye(F * 3, dtype=dtype, device=dev)
    P_FF = Bflat @ G @ Bflat.T
    P_fX = -(Bflat @ HxP)
    # rejected candidates land on the calib columns after the landmark
    # block with all-zero rows: adding them changes nothing
    idx = (cfg.slam_off + 3 * slot_eff[:, None]
           + torch.arange(3, device=dev)[None, :]).reshape(F * 3)
    rows_add = torch.zeros_like(state.cov).index_add(0, idx, P_fX)
    # P_fX is zero at the new slots' columns (free-slot covariance rows are
    # zero), so the corner gets exactly P_FF
    corner = torch.zeros_like(state.cov).index_put(
        (idx[:, None], idx[None, :]), P_FF, accumulate=True)
    cov = state.cov + rows_add + rows_add.T + corner

    lam_new = p_f + (R1inv @ res1[..., None])[..., 0]
    head = state.head.to(torch.int32)
    state = state.replace(
        cov=0.5 * (cov + cov.T),
        slam_p=_set_rows(state.slam_p, slot_eff, lam_new),
        slam_p_fej=_set_rows(state.slam_p_fej, slot_eff, p_f),
        slam_id=_set_rows(state.slam_id, slot_eff, feat_ids.to(torch.int32)),
        slam_valid=_set_rows(state.slam_valid, slot_eff,
                             torch.ones_like(ok)),
        slam_anchor_slot=_set_rows(state.slam_anchor_slot, slot_eff,
                                   head.expand(F)),
        slam_anchor_cam=_set_rows(state.slam_anchor_cam, slot_eff,
                                  torch.zeros_like(slot_eff,
                                                   dtype=torch.int32)),
    )

    # one stacked system over every accepted candidate's leftover rows
    H_up_all = (H_up * okf[:, None, None]).reshape(-1, D)
    res_up_all = (res_up * okf[:, None]).reshape(-1)
    n_init = ok.sum(dtype=torch.int32)
    # consume EVERY attempted candidate's measurements, success or failure
    # (to_delete on processed features, UpdaterSLAM.cpp:139-147, 237)
    table = ft.clear_rows(table, _mark_rows(T, rows, attempted))
    return state, table, n_init, H_up_all, res_up_all


def build_update(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """Linearize, gate and stack every in-state landmark's unconsumed
    measurements — no state update (UpdaterSLAM::update parity,
    UpdaterSLAM.cpp:254-470, up to the EKF update).

    Only the newest cfg.slam_stack_clones clone slots are gathered
    (measurements are consumed every frame, so older slots are empty).
    Returns (state, table, H [L·2·O, D], res, fail_count [L], n_used) with
    row noise cfg.sigma_pix_slam and column support
    cfg.slam_meas_support_ranges; `state` carries the updated fail counters
    and `table` has the consumed measurements cleared."""
    require_ported(cfg)
    dtype, dev = state.cov.dtype, state.cov.device
    if cfg.max_slam == 0:
        return (state, table,
                torch.zeros((0, cfg.state_dim), dtype=dtype, device=dev),
                torch.zeros((0,), dtype=dtype, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    L, C, N, D = cfg.max_slam, cfg.max_clones, cfg.num_cams, cfg.state_dim
    W = C if cfg.slam_stack_clones <= 0 else min(cfg.slam_stack_clones, C)
    O = W * N
    sigma = cfg.sigma_pix_slam

    # landmark -> table row, by id (the first match, as argmax keeps it)
    eq = state.slam_id[:, None] == table.ids[None, :]  # [L, T]
    row = torch.argmax(eq.to(torch.int32), dim=1)
    has_row = eq.any(dim=1) & state.slam_valid & (state.slam_id >= 0)

    slots_w = clone_age_order(state, cfg)[:W]  # newest first
    slot_idx = slots_w.repeat_interleave(N)  # [O] slot-major
    cam_idx = torch.arange(N, dtype=torch.int32, device=dev).repeat(W)
    clone_valid_w = state.clone_valid[slot_idx.long()]

    sw = slots_w.long()
    uv = table.uv[row][:, sw].reshape(L, O, 2)
    uvn = table.uvn[row][:, sw].reshape(L, O, 2)
    bits = table.mbits[row]  # [L, N] packed clone bits
    m_w = ((bits[:, None, :] >> slots_w[None, :, None]) & 1) > 0  # [L, W, N]
    gobs = uh.GatheredObs(
        clone_slot=slot_idx.expand(L, O), cam=cam_idx.expand(L, O),
        uv=uv, uvn=uvn,
        mask=m_w.reshape(L, O) & has_row[:, None] & clone_valid_w[None, :])

    p_G_fej = state.slam_p_fej if cfg.use_fej else state.slam_p
    ctx_w = uh.obs_context(state, cfg, slot_idx, cam_idx)
    H_x, H_lam, res, row_mask = uh.feature_jacobian_batch(
        state, cfg, gobs, state.slam_p, p_G_fej, ctx_w)
    n_valid = row_mask.sum(dim=-1, dtype=torch.int32)
    H_full = _set_slam_cols(H_x, cfg, H_lam)

    # χ² gates contract over the SLAM support columns only
    sup = cfg.slam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_full, sup), res, sigma)
    dof = torch.clamp(n_valid, min=1)
    ok = (has_row & (n_valid >= 1) & torch.isfinite(gamma)
          & (gamma < ekf.chi2_gate(dof) * cfg.chi2_multiplier_slam))

    keep = ok[:, None] & row_mask  # [L, 2O]
    H_big = torch.where(keep[..., None], H_full, 0.0).reshape(L * 2 * O, D)
    res_big = torch.where(keep, res, 0.0).reshape(L * 2 * O)

    # consume: every landmark with >= 1 valid stacked row had its
    # measurements processed (used or χ²-rejected)
    consumed = has_row & row_mask.any(dim=1)  # [L]
    table = ft.clear_rows(table, (eq & consumed[:, None]).any(dim=0))

    failed = consumed & ~ok
    state = state.replace(slam_fail=state.slam_fail + failed.to(torch.int32))
    return (state, table, H_big, res_big, failed.to(torch.int32),
            ok.sum(dtype=torch.int32))


def evict(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """Drop landmarks whose track died or that keep failing the gate
    (slam_fail carries update_fail_count, VioManager.cpp:461-481): a
    landmark is dead when its feature was not tracked into the current frame
    or its fail count reached MAX_FAIL.  Its table row is freed, and its
    covariance rows and columns are zeroed (StateHelper::marginalize_slam
    under the static layout)."""
    if cfg.max_slam == 0:
        return state, table
    L = cfg.max_slam
    eq = state.slam_id[:, None] == table.ids[None, :]  # [L, T]
    tracked = (eq & (table.ids[None, :] >= 0)).any(dim=1)
    # seen this frame (the row's transient `seen` flag: update() consumed
    # the measurements, so obs counts cannot tell live tracks)
    seen = (eq & table.seen[None, :]).any(dim=1)
    dead = state.slam_valid & (~tracked | ~seen
                               | (state.slam_fail >= MAX_FAIL))
    table = ft.free_rows(table, (eq & dead[:, None]).any(dim=0))
    keep = torch.ones((cfg.state_dim,), dtype=state.cov.dtype,
                      device=state.cov.device)
    keep[cfg.slam_off:cfg.slam_off + 3 * L] = torch.repeat_interleave(
        (~dead).to(state.cov.dtype), 3)
    state = state.replace(
        cov=state.cov * keep[:, None] * keep[None, :],
        slam_valid=state.slam_valid & ~dead,
        slam_id=torch.where(dead, -1, state.slam_id),
        slam_fail=torch.where(dead, 0, state.slam_fail),
    )
    return state, table
