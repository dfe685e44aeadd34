"""SLAM landmarks in the state: promotion, delayed initialization in its
collecting form, the landmark rows, eviction and the anchor change.

A frozen copy of the port's `models/updater_slam.py` (UpdaterSLAM parity,
UpdaterSLAM.cpp:58-647), cut to the paths `manager.check_config` admits:
landmarks stored as GLOBAL_3D or ANCHORED_MSCKF_INVERSE_DEPTH
(`landmark_rep`; OpenVINS's EuRoC configuration uses the latter, anchored
on the newest clone at insertion and moved to the newest clone when its
anchor is marginalized, `change_anchors`), no aruco landmarks, and delayed
init only with `collect=True` (its leftover rows go to the joint update).
One stream, no `torch.func.vmap`: where the program selects "nothing" on
the device for a stream with no delayed-init work, this returns it by a
Python `if`, and the anchor change is built landmark by landmark.

Every gate notes its margin (`margin.note`): the landmark rows' χ², the
delayed-init decisions (the leftover rows' χ², the insertion's
observability cap, the absurd-row guard, the delay since the start) and
triangulation's condition and depth (in `triangulation`).  A landmark is
evicted on its MAX_FAIL-th χ² failure, so the rows' χ² margin is also the
eviction's.
"""

from __future__ import annotations

import torch

from vio_bench.reference import ekf, margin
from vio_bench.reference import feature_table as ft
from vio_bench.reference import landmark_rep as lrep
from vio_bench.reference import triangulation as tri
from vio_bench.reference import update_helper as uh
from vio_bench.reference.feature_table import FeatureTable
from vio_bench.reference.layout import FilterConfig
from vio_bench.reference.state import VioState, clone_age_order
from vio_bench.plain import smallmat

MAX_FAIL = 2  # eviction on χ²-failure count (VioManager.cpp:476)
MAX_INIT_PER_FRAME = 6  # landmarks initialized per frame (static bound)
_INIT_VAR_CAP = 1e4  # max inserted landmark variance (units² of the rep)
_ABSURD = 1e8  # an init row with an entry above this is dropped


def slam_row_mask(state: VioState, table: FeatureTable):
    """[T] bool — table rows whose id is an active SLAM landmark."""
    eq = table.ids[:, None] == state.slam_id[None, :]  # [T, L]
    return torch.any(eq & state.slam_valid[None, :]
                     & (table.ids[:, None] >= 0), dim=1)


def _set_slam_cols(H_x, cfg: FilterConfig, H_lam):
    """Place landmark l's columns [l, rows, 3] at its slot's columns of
    H_x [L, rows, D] (the landmark block of H_x is all-zero)."""
    L, rows, k = H_lam.shape
    cols = (cfg.slam_off + 3 * torch.arange(L)[:, None]
            + torch.arange(k)[None, :])  # [L, k]
    return H_x.scatter(2, cols[:, None, :].expand(L, rows, k), H_lam)


def _add_clone_block(H_x, cfg: FilterConfig, slot, add):
    """H_x [F, rows, D] += add [F, rows, 6] at the columns of clone slot
    slot[f] of each feature f."""
    F, rows, _ = add.shape
    cols = (cfg.clones_off + 6 * slot.long()[:, None]
            + torch.arange(6)[None, :])  # [F, 6]
    return H_x.scatter_add(2, cols[:, None, :].expand(F, rows, 6), add)


def _anchor_of(state: VioState, fej: bool):
    """Every landmark slot's anchor clone slot and the anchor's clone and
    extrinsic values (clone values at their FEJ when `fej`)."""
    a_slot = state.slam_anchor_slot.long()
    a_cam = state.slam_anchor_cam.long()
    q_c = (state.clones_q_fej if fej else state.clones_q)[a_slot]
    p_c = (state.clones_p_fej if fej else state.clones_p)[a_slot]
    return (a_slot, q_c, p_c, state.calib_ext_q[a_cam],
            state.calib_ext_p[a_cam])


def landmark_global(state: VioState, cfg: FilterConfig):
    """[L, 3] p_FinG of every landmark slot, at the current values (an
    anchored landmark's FEJ lives in its anchor frame's linearization,
    `_chain_anchored`, UpdaterHelper.cpp:284-287)."""
    rep = cfg.feat_rep_slam
    if not lrep.is_anchored(rep):
        return state.slam_p
    _, q_c, p_c, q_e, p_e = _anchor_of(state, fej=False)
    return lrep.to_global(rep, state.slam_p, q_c, p_c, q_e, p_e)


def _chain_anchored(state: VioState, cfg: FilterConfig, H_x, H_fg,
                    p_G_cur):
    """Global-point rows (H_fg = ∂z/∂p_FinG [L, rows, 3]) to λ rows, with
    the anchor clone's columns added to H_x, linearized at the current
    global point in the FEJ anchor frame (UpdaterHelper.cpp:87-96).
    Returns (H_x, H_lam)."""
    rep = cfg.feat_rep_slam
    if not lrep.is_anchored(rep):
        return H_x, H_fg
    a_slot, q_c, p_c, q_e, p_e = _anchor_of(state, cfg.use_fej)
    lam_lin = lrep.from_global(rep, p_G_cur, q_c, p_c, q_e, p_e)
    dth, dp = lrep.d_pFinG_d_anchor(rep, lam_lin, q_c, q_e, p_e)
    H_x = _add_clone_block(H_x, cfg, a_slot,
                           torch.cat([H_fg @ dth, H_fg @ dp], dim=-1))
    return H_x, H_fg @ lrep.d_pFinG_d_lam(rep, lam_lin, q_c, q_e)


def _init_to_lam(state: VioState, cfg: FilterConfig, H_x, H_fg, p_f):
    """The init systems of F candidates at triangulated points p_f [F, 3],
    in λ: every new landmark is anchored on the newest clone and camera 0.
    The value λ₀ uses the current anchor pose, the Jacobians the
    triangulated point in the FEJ anchor frame (UpdaterHelper.cpp:87-96).
    Returns (H_x, H_lam, λ₀ [F, 3])."""
    rep = cfg.feat_rep_slam
    if not lrep.is_anchored(rep):
        return H_x, H_fg, p_f
    head = state.head.long()
    q_c, p_c = state.clones_q[head], state.clones_p[head]
    q_e, p_e = state.calib_ext_q[0], state.calib_ext_p[0]
    lam0 = lrep.from_global(rep, p_f, q_c, p_c, q_e, p_e)
    lam_lin = lam0
    if cfg.use_fej:
        q_c = state.clones_q_fej[head]
        lam_lin = lrep.from_global(rep, p_f, q_c, state.clones_p_fej[head],
                                   q_e, p_e)
    dth, dp = lrep.d_pFinG_d_anchor(rep, lam_lin, q_c, q_e, p_e)
    H_x = _add_clone_block(H_x, cfg, head.expand(p_f.shape[0]),
                           torch.cat([H_fg @ dth, H_fg @ dp], dim=-1))
    return H_x, H_fg @ lrep.d_pFinG_d_lam(rep, lam_lin, q_c, q_e), lam0


def _set_rows(a, idx, vals):
    """a[idx] = vals with the index len(a) meaning "drop"."""
    pad = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    return pad.index_copy(0, idx, vals)[:-1]


def _mark_rows(T, rows, flags):
    """[T] bool with flags[i] at rows[i] (rows distinct, in [0, T))."""
    return torch.zeros((T,), dtype=torch.bool).index_put((rows,), flags)


def _init_scores(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """(score [T], n_free): the observation count of every full-window row
    not yet a landmark (-1 elsewhere, and everywhere before the window is
    full and dt_slam_delay has passed), and the free landmark slots."""
    since = state.t - state.t_init
    margin.note("slam_delay", since, cfg.dt_slam_delay,
                torch.tensor(cfg.dt_slam_delay > 0), margin.DEPTH)
    delay_ok = since >= cfg.dt_slam_delay
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
    score, n_free = _init_scores(state, cfg, table)
    budget = torch.clamp(n_free, max=MAX_INIT_PER_FRAME)
    T = table.ids.shape[0]
    rows = ft.select_candidates(score, min(MAX_INIT_PER_FRAME, T))
    take = (score[rows] > 0) & (torch.arange(rows.shape[0]) < budget)
    return _mark_rows(T, rows, take)


def delayed_init(state: VioState, cfg: FilterConfig, table: FeatureTable,
                 tri_opts: tri.TriangulationOptions, gather_fn):
    """Promote up to MAX_INIT_PER_FRAME mature tracks into free landmark
    slots jointly (StateHelper::initialize parity, UpdaterSLAM.cpp:100-240):
    the landmarks enter the covariance here, and their leftover rows are
    returned for the joint update.

    gather_fn(state, cfg, table, rows) -> (tri_obs, gobs) is the manager's
    `gather_feature_obs`.  Returns (state, table, n_init, H_up
    [F·(2·C·N−3), D], res_up) with row noise cfg.sigma_pix_slam (zero rows
    when nothing was initialized)."""
    F = MAX_INIT_PER_FRAME
    D = cfg.state_dim
    dt = state.cov.dtype
    up_rows = F * (2 * cfg.max_clones * cfg.num_cams - 3)
    nothing = (state, table, torch.zeros((), dtype=torch.int32),
               torch.zeros((up_rows, D), dtype=dt),
               torch.zeros((up_rows,), dtype=dt))
    score, n_free = _init_scores(state, cfg, table)
    rows = ft.select_candidates(score, F)
    cand_ok = score[rows] > 0
    if not bool(torch.any(cand_ok) & (n_free > 0)):
        return nothing
    return _delayed_init_work(state, cfg, table, tri_opts, gather_fn, rows,
                              cand_ok)


def _delayed_init_work(state: VioState, cfg: FilterConfig,
                       table: FeatureTable,
                       tri_opts: tri.TriangulationOptions, gather_fn, rows,
                       cand_ok):
    """The joint init body (see `delayed_init`)."""
    L, D = cfg.max_slam, cfg.state_dim
    F = MAX_INIT_PER_FRAME
    sigma = cfg.sigma_pix_slam
    dtype = state.cov.dtype
    T = table.ids.shape[0]
    tri_obs, gobs = gather_fn(state, cfg, table, rows)
    p_f, tri_ok = tri.triangulate_batch(tri_obs, tri_opts)
    tri_ok = tri_ok & torch.isfinite(p_f).all(dim=-1)
    p_f = torch.where(tri_ok[:, None], p_f,
                      torch.tensor([0.0, 0.0, 1.0], dtype=dtype))
    feat_ids = torch.where(rows < T, table.ids[torch.clamp(rows, max=T - 1)],
                           -1)
    # free slots first, then L; the first free-capacity-many candidates are
    # attempted, and failures among them are consumed too
    free_order = torch.sort(torch.where(~state.slam_valid,
                                        torch.arange(L), L)).values
    n_free = (~state.slam_valid).sum(dtype=torch.int32)
    attempted = cand_ok & (torch.cumsum(cand_ok.to(torch.int32), dim=0) - 1
                           < n_free)

    # every candidate's init system at the pre-frame linearization, in λ
    ctx0 = uh.obs_context(state, cfg, gobs.clone_slot[0], gobs.cam[0])
    H_x, H_lam, res, row_mask = uh.feature_jacobian_batch(state, cfg, gobs,
                                                          p_f, p_f, ctx0)
    H_x, H_lam, lam0 = _init_to_lam(state, cfg, H_x, H_lam, p_f)

    # non-finite or absurd rows are dropped before the rotation: a
    # rejected candidate keeps the [0, 0, 1] placeholder point
    def _bad(M):
        return ~torch.isfinite(M) | (torch.abs(M) > _ABSURD)

    for M in (H_x, H_lam, res):
        live = attempted & tri_ok
        mag = torch.abs(M).reshape(F, -1).amax(dim=1)
        margin.note("init_absurd", mag, _ABSURD, live, margin.DEPTH)
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

    # the attempt budget first, then the quality gates; failed attempts
    # are consumed below
    ok = attempted & tri_ok & extra_ok
    # χ² on the leftover rows (pre-init covariance, support columns)
    sup = cfg.cam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_up, sup), res_up, sigma)
    dof = torch.clamp(n_valid - 3, min=1)
    gate = ekf.chi2_gate(dof) * cfg.chi2_multiplier_slam
    margin.note("init_chi2", gamma, gate, ok, margin.CHI2)
    ok = ok & torch.isfinite(gamma) & (gamma < gate)

    # the observability cap on σ²·Σ R1⁻¹², a conditioning of R1
    R1inv_raw = smallmat.inv_upper3(R1)
    var_proxy = sigma ** 2 * torch.sum(R1inv_raw ** 2, dim=(1, 2))
    margin.note("init_var_cap", var_proxy, _INIT_VAR_CAP, ok, margin.COND)
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
    G = HxP @ X.T + sigma ** 2 * torch.eye(F * 3, dtype=dtype)
    P_FF = Bflat @ G @ Bflat.T
    P_fX = -(Bflat @ HxP)
    # rejected candidates land on the calibration columns after the
    # landmark block with all-zero rows: adding them changes nothing
    idx = (cfg.slam_off + 3 * slot_eff[:, None]
           + torch.arange(3)[None, :]).reshape(F * 3)
    rows_add = torch.zeros_like(state.cov).index_add(0, idx, P_fX)
    # P_fX is zero at the new slots' columns (free-slot covariance rows are
    # zero), so the corner gets exactly P_FF
    corner = torch.zeros_like(state.cov).index_put(
        (idx[:, None], idx[None, :]), P_FF, accumulate=True)
    cov = state.cov + rows_add + rows_add.T + corner

    # the mean correction R1⁻¹ res1
    lam_new = lam0 + (R1inv @ res1[..., None])[..., 0]
    head = state.head.to(torch.int32)
    state = state.replace(
        cov=0.5 * (cov + cov.T),
        slam_p=_set_rows(state.slam_p, slot_eff, lam_new),
        slam_p_fej=_set_rows(state.slam_p_fej, slot_eff, lam0),
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
    # consume every attempted candidate's measurements, success or failure
    # (to_delete on processed features, UpdaterSLAM.cpp:139-147, 237)
    table = ft.clear_rows(table, _mark_rows(T, rows, attempted))
    return state, table, ok.sum(dtype=torch.int32), H_up_all, res_up_all


def build_update(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """Linearize, gate and stack every in-state landmark's unconsumed
    measurements of the newest cfg.slam_stack_clones clones — no state
    update (UpdaterSLAM::update parity, UpdaterSLAM.cpp:254-470, up to the
    EKF update).  Returns (state, table, H [L·2·O, D], res, n_used) with
    row noise cfg.sigma_pix_slam and column support
    cfg.slam_meas_support_ranges; `state` carries the updated fail counters
    and `table` has the consumed measurements cleared."""
    L, C, N = cfg.max_slam, cfg.max_clones, cfg.num_cams
    W = C if cfg.slam_stack_clones <= 0 else min(cfg.slam_stack_clones, C)
    O = W * N
    D = cfg.state_dim
    sigma = cfg.sigma_pix_slam

    # landmark -> table row, by id (the first match)
    eq = state.slam_id[:, None] == table.ids[None, :]  # [L, T]
    row = torch.argmax(eq.to(torch.int32), dim=1)
    has_row = eq.any(dim=1) & state.slam_valid & (state.slam_id >= 0)

    slots_w = clone_age_order(state, cfg)[:W]  # newest first
    slot_idx = slots_w.repeat_interleave(N)  # [O] slot-major
    cam_idx = torch.arange(N, dtype=torch.int32).repeat(W)
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

    p_G_cur = landmark_global(state, cfg)
    # an anchored landmark's FEJ is its anchor's (`_chain_anchored`)
    p_G_fej = (state.slam_p_fej if cfg.use_fej
               and not lrep.is_anchored(cfg.feat_rep_slam) else p_G_cur)
    ctx_w = uh.obs_context(state, cfg, slot_idx, cam_idx)
    H_x, H_fg, res, row_mask = uh.feature_jacobian_batch(
        state, cfg, gobs, p_G_cur, p_G_fej, ctx_w)
    H_x, H_fg = _chain_anchored(state, cfg, H_x, H_fg, p_G_cur)
    n_valid = row_mask.sum(dim=-1, dtype=torch.int32)
    H_full = _set_slam_cols(H_x, cfg, H_fg)
    dof = torch.clamp(n_valid, min=1)

    # the χ² gate contracts over the SLAM support columns only
    sup = cfg.slam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_full, sup), res, sigma)
    gate = ekf.chi2_gate(dof) * cfg.chi2_multiplier_slam
    gated = has_row & (n_valid >= 1)
    # a failure counts towards eviction (`evict`): this margin is also the
    # eviction's
    margin.note("slam_chi2", gamma, gate, gated, margin.CHI2)
    ok = gated & torch.isfinite(gamma) & (gamma < gate)

    keep = ok[:, None] & row_mask  # [L, 2O]
    H_big = torch.where(keep[..., None], H_full, 0.0).reshape(L * 2 * O, D)
    res_big = torch.where(keep, res, 0.0).reshape(L * 2 * O)

    # consumed: every landmark with a valid stacked row had its
    # measurements processed (used or χ²-rejected)
    consumed = has_row & row_mask.any(dim=1)  # [L]
    table = ft.clear_rows(table, (eq & consumed[:, None]).any(dim=0))

    failed = consumed & ~ok
    state = state.replace(slam_fail=state.slam_fail + failed.to(torch.int32))
    return state, table, H_big, res_big, ok.sum(dtype=torch.int32)


def evict(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """Drop landmarks whose track died or that keep failing the gate
    (VioManager.cpp:461-481): dead when its feature was not tracked into
    the current frame or its fail count reached MAX_FAIL.  Its table row is
    freed and its covariance rows and columns are zeroed
    (StateHelper::marginalize_slam under the static layout)."""
    L = cfg.max_slam
    eq = state.slam_id[:, None] == table.ids[None, :]  # [L, T]
    tracked = (eq & (table.ids[None, :] >= 0)).any(dim=1)
    seen = (eq & table.seen[None, :]).any(dim=1)
    dead = state.slam_valid & (~tracked | ~seen
                               | (state.slam_fail >= MAX_FAIL))
    table = ft.free_rows(table, (eq & dead[:, None]).any(dim=0))
    one = torch.ones((cfg.state_dim,), dtype=state.cov.dtype)
    s0, s1 = cfg.slam_off, cfg.slam_off + 3 * L
    keep = torch.cat([one[:s0],
                      torch.repeat_interleave((~dead).to(state.cov.dtype), 3),
                      one[s1:]])
    state = state.replace(
        cov=state.cov * keep[:, None] * keep[None, :],
        slam_valid=state.slam_valid & ~dead,
        slam_id=torch.where(dead, -1, state.slam_id),
        slam_fail=torch.where(dead, 0, state.slam_fail),
    )
    return state, table


def change_anchors(state: VioState, cfg: FilterConfig, dying_slot):
    """Move the landmarks anchored on the clone about to be marginalized to
    the newest clone (UpdaterSLAM::change_anchors / perform_anchor_change,
    UpdaterSLAM.cpp:481-647): cov' = M cov Mᵀ, with M the identity but for
    each moved landmark's rows, δλ_new = J_lam δλ_old + J_xold δx_Aold +
    J_xnew δx_Anew; the Jacobians at FEJ values, the value at the current
    ones, and the landmark's FEJ the transformed FEJ value.  The state
    unchanged without landmarks and for GLOBAL_3D."""
    rep = cfg.feat_rep_slam
    if cfg.max_slam == 0 or not lrep.is_anchored(rep):
        return state
    D = cfg.state_dim
    new, dying = state.head.long(), dying_slot.long()
    need = state.slam_valid & (state.slam_anchor_slot == dying_slot)
    a_cam = state.slam_anchor_cam.long()
    q_e, p_e = state.calib_ext_q[a_cam], state.calib_ext_p[a_cam]
    lam_new_f, J_lam, J_xo, J_xn = lrep.anchor_change_jacobians(
        rep, state.slam_p_fej, state.clones_q_fej[dying],
        state.clones_p_fej[dying], state.clones_q_fej[new],
        state.clones_p_fej[new], q_e, p_e)
    p_G = lrep.to_global(rep, state.slam_p, state.clones_q[dying],
                         state.clones_p[dying], q_e, p_e)
    lam_new = lrep.from_global(rep, p_G, state.clones_q[new],
                               state.clones_p[new], q_e, p_e)
    M = torch.eye(D, dtype=state.cov.dtype)
    for l in torch.nonzero(need).flatten().tolist():
        r = cfg.slam_off + 3 * l
        d0 = cfg.clones_off + 6 * int(dying)
        n0 = cfg.clones_off + 6 * int(new)
        M[r:r + 3] = 0.0
        M[r:r + 3, r:r + 3] = J_lam[l]
        M[r:r + 3, d0:d0 + 6] = J_xo[l]
        M[r:r + 3, n0:n0 + 6] = J_xn[l]  # the new anchor's, if they share
    cov = M @ state.cov @ M.T
    return state.replace(
        cov=0.5 * (cov + cov.T),
        slam_p=torch.where(need[:, None], lam_new, state.slam_p),
        slam_p_fej=torch.where(need[:, None], lam_new_f, state.slam_p_fej),
        slam_anchor_slot=torch.where(need, state.head.to(torch.int32),
                                     state.slam_anchor_slot))
