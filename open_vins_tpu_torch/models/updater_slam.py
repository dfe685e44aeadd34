"""SLAM landmark pipeline: delayed initialization, the landmark update,
eviction and re-anchoring, in the joint per-frame vision update and in the
reference-exact sequential ordering.

Counterpart of `open_vins_tpu/models/updater_slam.py` (UpdaterSLAM parity,
UpdaterSLAM.cpp:58-647):

  * `promotion_candidates`: the full-window tracks reserved for SLAM this
    frame (VioManager.cpp:410-453 triage);
  * `build_update`: every in-state landmark's unconsumed measurements of the
    newest `slam_stack_clones` clones, χ²-gated, stacked — no state update;
    the consumed measurements are cleared from the table; `update` applies
    that stack by its own EKF update (the sequential ordering);
  * `delayed_init`: up to MAX_INIT_PER_FRAME mature tracks triangulated and
    inserted into free landmark slots jointly, with the leftover rows
    returned for the joint update (`collect=True`) or applied by their own
    EKF update (`collect=False`); `_delayed_init_sequential` is the
    one-at-a-time loop that is its oracle;
  * `evict`: landmarks whose track died or that keep failing the gate are
    dropped (their covariance rows and columns zeroed);
  * `change_anchors`: landmarks anchored on the clone about to be
    marginalized move to the newest clone (an exact covariance row map).

The stored λ follows cfg.feat_rep_slam (`landmark_rep`): GLOBAL_3D,
GLOBAL_FULL_INVERSE_DEPTH, ANCHORED_3D, ANCHORED_FULL_INVERSE_DEPTH,
ANCHORED_MSCKF_INVERSE_DEPTH or the 1-dof ANCHORED_INVERSE_DEPTH_SINGLE.
Rows are linearized in the global point and chained to λ, and for the
anchored representations to the anchor clone's columns (`_chain_anchored`).
The single-depth representation keeps only ρ in the state: it linearizes
through its ANCHORED_MSCKF_INVERSE_DEPTH equivalent and projects the bearing
columns out of each system (UpdaterSLAM.cpp:163-210, 340-380); its slot's
two other covariance entries stay zero and hold the bearing as data.

Aruco landmarks (ids in [0, 4·num_aruco_tags], TrackAruco's 4·tag + corner
contract) promote first, and their rows are whitened by
sigma_pix_slam / sigma_pix_aruco and gated with chi2_multiplier_aruco (the
reference runs a second UpdaterSLAM for them).  Lookups use plain indexing;
writes at slots that are device values use selects and one-hots, so every
function runs under `torch.func.vmap`.
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.core import ekf
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import VioState, clone_age_order, select
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import landmark_rep as lrep
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.models import update_helper as uh
from open_vins_tpu_torch.models.feature_table import FeatureTable
from open_vins_tpu_torch.ops import smallmat
from open_vins_tpu_torch.utils.profiling import annotate

MAX_FAIL = 2  # eviction on χ²-failure count (VioManager.cpp:476)
MAX_INIT_PER_FRAME = 6  # landmarks initialized per frame (static bound)
_INIT_VAR_CAP = 1e4  # max inserted landmark variance (units² of the rep):
# the delayed-init observability cap on σ²·Σ R1⁻¹² (see _delayed_init_work)
# span (`utils.profiling.annotate`) around delayed_init's one host read of
# a device flag
INIT_FLAG_READ = "delayed_init.flag_read"


def _aruco_landmark_mask(cfg: FilterConfig, ids):
    """ids in [0, 4·num_aruco_tags] are aruco tag corners (TrackAruco's
    featid = 4·tag + corner contract); natural features are numbered
    above."""
    if cfg.num_aruco_tags <= 0:
        return torch.zeros_like(ids, dtype=torch.bool)
    return (ids >= 0) & (ids <= 4 * cfg.num_aruco_tags)


def _aruco_whitening(cfg: FilterConfig, ids):
    """(row scale, χ² multiplier) per landmark id: aruco rows are whitened
    by sigma_pix_slam / sigma_pix_aruco, which keeps the stacked system
    isotropic at sigma_pix_slam (exactly per-row sigma_pix_aruco noise)."""
    is_ar = _aruco_landmark_mask(cfg, ids)
    return (torch.where(is_ar, cfg.sigma_pix_slam / cfg.sigma_pix_aruco, 1.0),
            torch.where(is_ar, cfg.chi2_multiplier_aruco,
                        cfg.chi2_multiplier_slam))


def _lin_rep(cfg: FilterConfig) -> str:
    """The representation the rows are linearized in: the single-depth
    representation goes through its MSCKF inverse-depth equivalent."""
    rep = cfg.feat_rep_slam
    return lrep.ANCHORED_MSCKF_INVERSE_DEPTH if lrep.is_single(rep) else rep


def _drop_bearing(H_b, M, row_mask=None):
    """Project the bearing columns H_b [..., m, 2] out of M [..., m, n] (a
    Householder rotation whose first two rows are then zeroed), with the
    invalid rows zeroed first when `row_mask` is given."""
    if row_mask is not None:
        H_b = torch.where(row_mask[..., None], H_b, 0.0)
        M = torch.where(row_mask[..., None], M, 0.0)
    _, Mr = uh.householder_rotate(H_b, M)
    keep = torch.arange(Mr.shape[-2], device=Mr.device) >= 2
    return torch.where(keep[:, None], Mr, 0.0)


def slam_row_mask(state: VioState, table: FeatureTable):
    """[T] bool — table rows whose id is an active SLAM landmark."""
    eq = table.ids[:, None] == state.slam_id[None, :]  # [T, L]
    return torch.any(eq & state.slam_valid[None, :]
                     & (table.ids[:, None] >= 0), dim=1)


def _set_slam_cols(H_x, cfg: FilterConfig, H_lam):
    """Place landmark l's columns [l, rows, k] at its slot's first k
    columns of H_x [L, rows, D] (k = 1: the ρ column of the single-depth
    representation; the landmark block of H_x is all-zero, so add ==
    set)."""
    L, rows, k = H_lam.shape
    cols = (cfg.slam_off + 3 * torch.arange(L, device=H_x.device)[:, None]
            + torch.arange(k, device=H_x.device)[None, :])  # [L, k]
    return H_x.scatter(2, cols[:, None, :].expand(L, rows, k), H_lam)


def _add_clone_block(H_x, cfg: FilterConfig, slot, add):
    """H_x [F, rows, D] += add [F, rows, 6] at the columns of clone slot
    slot[f] of each feature f."""
    F, rows, _ = add.shape
    cols = (cfg.clones_off + 6 * slot.long()[:, None]
            + torch.arange(6, device=H_x.device)[None, :])  # [F, 6]
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


def landmark_global(state: VioState, cfg: FilterConfig, fej: bool):
    """[L, 3] p_FinG of every landmark slot under cfg.feat_rep_slam.

    For the anchored representations the FEJ global position is the
    current one: the reference sets p_FinG_fej = p_FinG for relative
    representations (UpdaterHelper.cpp:284-287), whose FEJ lives in the
    anchor-frame linearization instead (`_chain_anchored`)."""
    rep = cfg.feat_rep_slam
    fej = fej and not lrep.is_anchored(rep)
    lam = state.slam_p_fej if fej else state.slam_p
    if not lrep.needs_lam_jacobian(rep):
        return lam
    _, q_c, p_c, q_e, p_e = _anchor_of(state, fej=False)
    return lrep.to_global(rep, lam, q_c, p_c, q_e, p_e)


def _chain_anchored(state: VioState, cfg: FilterConfig, H_x, H_fg,
                    p_G_cur):
    """Global-point rows (H_fg = ∂z/∂p_FinG [L, rows, 3]) to λ rows, with
    the anchored representations' anchor-clone columns added to H_x.
    Linearization points as the reference's (UpdaterHelper.cpp:87-96): for
    the anchored representations the current global point in the FEJ
    anchor frame; for the global inverse depth the stored FEJ λ.  λ is
    `_lin_rep`'s (the single-depth representation linearizes as
    ANCHORED_MSCKF_INVERSE_DEPTH, UpdaterSLAM.cpp:340).
    Returns (H_x, H_lam)."""
    rep = _lin_rep(cfg)
    if not lrep.needs_lam_jacobian(rep):
        return H_x, H_fg
    fej = cfg.use_fej
    a_slot, q_c, p_c, q_e, p_e = _anchor_of(state, fej)
    if lrep.is_anchored(rep):
        lam_lin = lrep.from_global(rep, p_G_cur, q_c, p_c, q_e, p_e)
    else:
        lam_lin = state.slam_p_fej if fej else state.slam_p
    H_lam = H_fg @ lrep.d_pFinG_d_lam(rep, lam_lin, q_c, q_e)
    if lrep.is_anchored(rep):
        dth, dp = lrep.d_pFinG_d_anchor(rep, lam_lin, q_c, q_e, p_e)
        H_x = _add_clone_block(H_x, cfg, a_slot,
                               torch.cat([H_fg @ dth, H_fg @ dp], dim=-1))
    return H_x, H_lam


def _set_rows(a, idx, vals):
    """a[idx] = vals with the index len(a) meaning "drop" (the reference's
    `.at[idx].set(vals, mode="drop")`)."""
    pad = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    return pad.index_copy(0, idx, vals)[:-1]


def _mark_rows(T, rows, flags):
    """[T] bool with flags[i] at rows[i] (rows distinct, in [0, T))."""
    return torch.zeros((T,), dtype=torch.bool,
                       device=rows.device).index_put((rows,), flags)


def _init_scores(state: VioState, cfg: FilterConfig, table: FeatureTable,
                 aruco_first: bool = True):
    """(score [T], n_free): the observation count of every full-window row
    not yet a landmark (-1 elsewhere, and everywhere before the window is
    full and dt_slam_delay has passed), aruco rows raised by 1e4 so that
    they promote first (the reference always makes them SLAM; not in the
    sequential oracle, as in the reference), and the free landmark
    slots."""
    delay_ok = (state.t - state.t_init) >= cfg.dt_slam_delay
    window_full = (state.n_clones >= cfg.max_clones) & delay_ok
    fullw = ft.full_window_rows(table, state.n_clones, cfg) & window_full
    cand = fullw & ~slam_row_mask(state, table)
    score = torch.where(cand, ft.row_obs_counts(table).to(torch.float32),
                        -1.0)
    if aruco_first:
        score = torch.where(cand & _aruco_landmark_mask(cfg, table.ids),
                            score + 1e4, score)
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
    take = (score[rows] > 0) & (torch.arange(rows.shape[0],
                                             device=rows.device) < budget)
    return _mark_rows(T, rows, take)


_DELAYED_INIT_JOINT = True  # joint batched init; the sequential loop is
# its oracle (tests/test_torch_sequential.py)


def delayed_init(state: VioState, cfg: FilterConfig, table: FeatureTable,
                 tri_opts: tri.TriangulationOptions, gather_fn,
                 batched: bool = False, collect: bool = True):
    """Promote up to MAX_INIT_PER_FRAME mature tracks into free SLAM slots
    by the joint batched delayed initialization (StateHelper::initialize
    parity, UpdaterSLAM.cpp:100-240): the landmarks enter the covariance
    here.  With `collect` (the joint per-frame update) their leftover
    measurement rows are returned for the joint EKF update; without it
    (the sequential ordering) they are applied here by their own EKF
    update on the camera support, as the reference's `collect=False` does.

    gather_fn(state, cfg, table, rows) -> (tri_obs, gobs) is the manager's
    `gather_feature_obs`.  Returns (state, table, n_init), and with
    `collect` also (H_up [F·(2·C·N−k), D], res_up) with row noise
    cfg.sigma_pix_slam (zero rows when nothing was initialized; k = 1 for
    the single-depth representation, else 3).

    The reference skips the init block behind a `lax.cond`; here the
    decision is one read of a device flag on the host per frame (`if`),
    and the block runs only when there is work.  `batched=True` (the step
    vmapped over streams, where `lax.cond` under `jax.vmap` becomes a
    select): the block always runs and each stream takes its result or
    "nothing" by its own flag, on the device (`state.select`; a non-finite
    value of the unselected branch is dropped by the select).  With
    `_DELAYED_INIT_JOINT = False` the sequential oracle
    (`_delayed_init_sequential`) runs instead (not with `collect`)."""
    if not _DELAYED_INIT_JOINT:
        if collect:
            raise ValueError("collect requires the joint batched init")
        return _delayed_init_sequential(state, cfg, table, tri_opts,
                                        gather_fn, batched)
    F = MAX_INIT_PER_FRAME
    D = cfg.state_dim
    dt, dev = state.cov.dtype, state.cov.device
    k = 1 if lrep.is_single(cfg.feat_rep_slam) else 3
    up_rows = F * (2 * cfg.max_clones * cfg.num_cams - k)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nothing = (state, table, zero_i)
    if collect:
        nothing += (torch.zeros((up_rows, D), dtype=dt, device=dev),
                    torch.zeros((up_rows,), dtype=dt, device=dev))
    if cfg.max_slam == 0:
        return nothing

    score, n_free = _init_scores(state, cfg, table)
    rows = ft.select_candidates(score, F)
    cand_ok = score[rows] > 0
    any_work = torch.any(cand_ok) & (n_free > 0)
    if batched:
        work = _delayed_init_work(state, cfg, table, tri_opts, gather_fn,
                                  rows, cand_ok, collect)
        return (select(any_work, work[0], state),
                select(any_work, work[1], table),
                *(torch.where(any_work, w, z)
                  for w, z in zip(work[2:], nothing[2:])))
    with annotate(INIT_FLAG_READ):
        any_work = bool(any_work)
    if not any_work:
        return nothing
    return _delayed_init_work(state, cfg, table, tri_opts, gather_fn, rows,
                              cand_ok, collect)


def _delayed_init_sequential(state: VioState, cfg: FilterConfig,
                             table: FeatureTable,
                             tri_opts: tri.TriangulationOptions, gather_fn,
                             batched: bool = False):
    """One landmark at a time (updater_slam.py:185-371 of the reference,
    the literal analog of the reference's per-feature
    StateHelper::initialize loop): each attempted candidate is linearized
    at the state its predecessors left (`feature_jacobian`), inserted by
    `ekf.initialize_landmark`, χ²-gated on its leftover rows against the
    running covariance and, if accepted, its leftover rows applied by their
    own EKF update.  The oracle of the joint `delayed_init`, which gives
    the same posterior because independent linear-Gaussian updates commute.
    The loop runs when there is work: read on the host, or with `batched`
    run always and selected per stream on the device.
    Returns (state, table, n_init)."""
    L = cfg.max_slam
    F = MAX_INIT_PER_FRAME
    sigma = cfg.sigma_pix_slam
    dev = state.cov.device
    single = lrep.is_single(cfg.feat_rep_slam)
    score, n_free = _init_scores(state, cfg, table, aruco_first=False)
    rows = ft.select_candidates(score, F)
    cand_ok = score[rows] > 0
    gobs, p_f, tri_ok, feat_ids, free_order, attempted = _init_candidates(
        state, cfg, table, tri_opts, gather_fn, rows, cand_ok)
    slot_ids = torch.arange(L, device=dev)

    def body(i, st, n_done):
        ok = attempted[i] & tri_ok[i]
        slot = free_order[torch.clamp(n_done, 0, L - 1)]
        obs_i = uh.GatheredObs(*(v[i] for _, v in gobs.items()))
        # the context is rebuilt from the running state: candidate i+1 is
        # linearized at candidate i's posterior, as in the reference
        H_x, H_fg, res, row_mask = uh.feature_jacobian(st, cfg, obs_i,
                                                       p_f[i], p_f[i])
        H_x, H_lam, lam0 = (a[0] for a in _init_to_lam(
            st, cfg, H_x[None], H_fg[None], p_f[i][None]))
        if single:
            # ρ becomes the state; the bearing columns are projected out of
            # [H_x | h_ρ | res] so that the stored bearing is not taken as
            # exact (UpdaterSLAM.cpp:190-206)
            Dx = H_x.shape[1]
            Mr = _drop_bearing(H_lam[:, :2], torch.cat(
                [H_x, H_lam[:, 2:3], res[:, None]], 1), row_mask)
            h_rho = Mr[:, Dx:Dx + 1]
            ok = ok & (torch.linalg.vector_norm(h_rho) > 1e-6)
            st2, H_up, res_up, up_mask = ekf.initialize_landmark_single(
                st, cfg, slot, feat_ids[i], lam0[[2, 0, 1]], Mr[:, :Dx],
                h_rho, Mr[:, -1],
                sigma, torch.arange(Mr.shape[0], device=dev) >= 2)
        else:
            st2, H_up, res_up, up_mask = ekf.initialize_landmark(
                st, cfg, slot, feat_ids[i], lam0, H_x, H_lam, res, sigma,
                row_mask)
        at = slot_ids == slot
        st2 = st2.replace(
            slam_anchor_slot=torch.where(at, st.head.to(torch.int32),
                                         st2.slam_anchor_slot),
            slam_anchor_cam=torch.where(at, 0, st2.slam_anchor_cam))
        # χ² gate on the leftover rows (the running covariance); dof = the
        # valid measurement rows minus the landmark's 3
        gamma = uh.chi2_statistic(st.cov, H_up, res_up, sigma)
        dof = torch.clamp(row_mask.sum(dtype=torch.int32) - 3, min=1)
        ok = (ok & torch.isfinite(gamma)
              & (gamma < ekf.chi2_gate(dof) * cfg.chi2_multiplier_slam))
        r_diag = torch.where(up_mask, sigma ** 2, 1.0)
        st3 = ekf.ekf_update(st2, cfg, H_up, res_up, r_diag)
        return select(ok, st3, st), n_done + ok.to(torch.int32)

    def run_inits(st):
        n_done = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(F):
            st, n_done = body(i, st, n_done)
        return st, n_done

    any_work = torch.any(cand_ok & tri_ok) & (n_free > 0)
    n_init = torch.zeros((), dtype=torch.int32, device=dev)
    if batched:
        st_run, n_run = run_inits(state)
        state = select(any_work, st_run, state)
        n_init = torch.where(any_work, n_run, n_init)
    else:
        with annotate(INIT_FLAG_READ):
            any_work = bool(any_work)
        if any_work:
            state, n_init = run_inits(state)
    # consume the measurements of every attempted candidate, success or
    # failure (to_delete on processed features, UpdaterSLAM.cpp:139-147, 237)
    table = ft.clear_rows(table, _mark_rows(table.ids.shape[0], rows,
                                            attempted))
    return state, table, n_init


def _init_candidates(state: VioState, cfg: FilterConfig, table: FeatureTable,
                     tri_opts: tri.TriangulationOptions, gather_fn, rows,
                     cand_ok):
    """What both delayed inits start from, for the candidate rows [F]:
    (gobs, p_f [F, 3] (non-finite or failed triangulations replaced by
    [0, 0, 1]), tri_ok, feat_ids, free_order (free landmark slots first,
    then L), attempted (the first free-capacity-many candidates; failures
    among them are consumed too))."""
    L = cfg.max_slam
    T = table.ids.shape[0]
    dtype, dev = state.cov.dtype, state.cov.device
    tri_obs, gobs = gather_fn(state, cfg, table, rows)
    p_f, tri_ok = tri.triangulate_batch(tri_obs, tri_opts)
    tri_ok = tri_ok & torch.isfinite(p_f).all(dim=-1)
    p_f = torch.where(tri_ok[:, None], p_f,
                      torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
    feat_ids = torch.where(rows < T, table.ids[torch.clamp(rows, max=T - 1)],
                           -1)
    free_order = torch.sort(torch.where(
        ~state.slam_valid, torch.arange(L, device=dev), L)).values
    # the attempt budget (feats_slam is sized to the open slots,
    # VioManager.cpp:410-453)
    n_free = (~state.slam_valid).sum(dtype=torch.int32)
    attempt_rank = torch.cumsum(cand_ok.to(torch.int32), dim=0) - 1
    attempted = cand_ok & (attempt_rank < n_free)
    return gobs, p_f, tri_ok, feat_ids, free_order, attempted


def _init_to_lam(state: VioState, cfg: FilterConfig, H_x, H_fg, p_f):
    """The init systems of F candidates at triangulated points p_f [F, 3],
    in λ (of `_lin_rep`): every new landmark is anchored on the newest
    clone and camera 0.  The value λ₀ uses the current anchor pose, the
    Jacobians the triangulated point in the FEJ anchor frame
    (UpdaterHelper.cpp:87-96).  Returns (H_x, H_lam, λ₀ [F, 3])."""
    rep = _lin_rep(cfg)
    if not lrep.needs_lam_jacobian(rep):
        return H_x, H_fg, p_f
    head = state.head.long()
    q_c, p_c = state.clones_q[head], state.clones_p[head]
    q_e, p_e = state.calib_ext_q[0], state.calib_ext_p[0]
    lam0 = lrep.from_global(rep, p_f, q_c, p_c, q_e, p_e)
    lam_lin = lam0
    if cfg.use_fej and lrep.is_anchored(rep):
        q_c = state.clones_q_fej[head]
        lam_lin = lrep.from_global(rep, p_f, q_c, state.clones_p_fej[head],
                                   q_e, p_e)
    H_lam = H_fg @ lrep.d_pFinG_d_lam(rep, lam_lin, q_c, q_e)
    if lrep.is_anchored(rep):
        dth, dp = lrep.d_pFinG_d_anchor(rep, lam_lin, q_c, q_e, p_e)
        H_x = _add_clone_block(H_x, cfg, head.expand(p_f.shape[0]),
                               torch.cat([H_fg @ dth, H_fg @ dp], dim=-1))
    return H_x, H_lam, lam0


def _delayed_init_work(state: VioState, cfg: FilterConfig,
                       table: FeatureTable,
                       tri_opts: tri.TriangulationOptions, gather_fn, rows,
                       cand_ok, collect: bool = True):
    """The joint batched init body (see `delayed_init`)."""
    L, D = cfg.max_slam, cfg.state_dim
    F = MAX_INIT_PER_FRAME
    sigma = cfg.sigma_pix_slam
    dtype, dev = state.cov.dtype, state.cov.device
    T = table.ids.shape[0]
    single = lrep.is_single(cfg.feat_rep_slam)
    k = 1 if single else 3
    gobs, p_f, tri_ok, feat_ids, free_order, attempted = _init_candidates(
        state, cfg, table, tri_opts, gather_fn, rows, cand_ok)

    # rotated init system of every candidate (pre-frame linearization)
    ctx0 = uh.obs_context(state, cfg, gobs.clone_slot[0], gobs.cam[0])
    H_x, H_lam, res, row_mask = uh.feature_jacobian_batch(state, cfg, gobs,
                                                          p_f, p_f, ctx0)
    H_x, H_lam, lam0 = _init_to_lam(state, cfg, H_x, H_lam, p_f)
    if cfg.num_aruco_tags > 0:
        # aruco candidates carry sigma_pix_aruco: whitened rows keep the
        # seeding and leftover algebra isotropic at sigma (exact)
        c = _aruco_whitening(cfg, feat_ids)[0]
        H_x, H_lam, res = (H_x * c[:, None, None], H_lam * c[:, None, None],
                           res * c[:, None])

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
    if single:
        # the bearing columns projected out; ρ is the 1-dof state, and
        # λ₀ = (α, β, ρ) becomes (ρ, b_x, b_y)
        Dx = H_x_m.shape[-1]
        Mr = _drop_bearing(H_lam_m[..., :2], torch.cat(
            [H_x_m, H_lam_m[..., 2:3], res_m[..., None]], dim=-1))
        H_x_m, H_lam_m, res_m = Mr[..., :Dx], Mr[..., Dx:Dx + 1], Mr[..., -1]
        lam0 = lam0[:, [2, 0, 1]]
        extra_ok = extra_ok & (torch.linalg.vector_norm(H_lam_m,
                                                        dim=(1, 2)) > 1e-6)
    R_full, Br = uh.householder_rotate(
        H_lam_m, torch.cat([H_x_m, res_m[..., None]], dim=-1))
    Hx_rot, res_rot = Br[..., :-1], Br[..., -1]
    R1, Hx1, res1 = R_full[:, :k, :k], Hx_rot[:, :k], res_rot[:, :k]
    H_up, res_up = Hx_rot[:, k:], res_rot[:, k:]

    # attempt budget first, then the quality gates; failed attempts are
    # consumed below so they cannot block the candidate queue
    ok = attempted & tri_ok & extra_ok
    # χ² gate on the leftover rows (pre-init covariance, support columns)
    sup = cfg.cam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_up, sup), res_up, sigma)
    dof = torch.clamp(n_valid - 3, min=1)
    mult = _aruco_whitening(cfg, feat_ids)[1]
    ok = ok & torch.isfinite(gamma) & (gamma < ekf.chi2_gate(dof) * mult)

    # R1⁻¹ and the observability cap: a nearly singular landmark factor
    # would insert an astronomical landmark covariance into P, and the joint
    # update's support spans every landmark column — refuse it instead
    if single:
        r1 = R1[:, 0, 0]
        R1inv_raw = torch.where(torch.abs(r1) > 1e-9,
                                1.0 / torch.where(r1 == 0, 1.0, r1),
                                0.0)[:, None, None]
    else:
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
    X = (Hx1 * okf[:, None, None]).reshape(F * k, D)
    HxP = X @ state.cov  # [F·k, D]
    # block_diag(*R1inv) [F·k, F·k], as one product (a batch rule under
    # vmap, where block_diag loops over the streams)
    eye_f = torch.eye(F, dtype=dtype, device=dev)
    Bflat = (R1inv[:, :, None, :] * eye_f[:, None, :, None]).reshape(F * k,
                                                                     F * k)
    G = HxP @ X.T + sigma ** 2 * torch.eye(F * k, dtype=dtype, device=dev)
    P_FF = Bflat @ G @ Bflat.T
    P_fX = -(Bflat @ HxP)
    # rejected candidates land on the calib columns after the landmark
    # block with all-zero rows: adding them changes nothing.  The rows are
    # placed by one-hot products, exact in float32 (index_add and an
    # accumulating index_put loop over the streams under vmap)
    idx = (cfg.slam_off + 3 * slot_eff[:, None]
           + torch.arange(k, device=dev)[None, :]).reshape(F * k)
    onehot = (idx[:, None] == torch.arange(D, device=dev)).to(dtype)
    rows_add = onehot.T @ P_fX
    # P_fX is zero at the new slots' columns (free-slot covariance rows are
    # zero), so the corner gets exactly P_FF
    corner = onehot.T @ P_FF @ onehot
    cov = state.cov + rows_add + rows_add.T + corner

    # the mean correction R1⁻¹ res1 (ρ only for the single depth)
    df = (R1inv @ res1[..., None])[..., 0]
    lam_new = lam0 + (torch.cat([df, df.new_zeros((F, 2))], dim=1)
                      if single else df)
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
    n_init = ok.sum(dtype=torch.int32)
    # consume EVERY attempted candidate's measurements, success or failure
    # (to_delete on processed features, UpdaterSLAM.cpp:139-147, 237)
    table = ft.clear_rows(table, _mark_rows(T, rows, attempted))
    if collect:  # the joint update applies the leftover rows
        return state, table, n_init, H_up_all, res_up_all
    # leftover rows are pure H_x rows on the camera support; zero rows are
    # exact update no-ops
    r_diag = torch.full((H_up_all.shape[0],), sigma ** 2, dtype=dtype,
                        device=dev)
    state = ekf.ekf_update(state, cfg, H_up_all, res_up_all, r_diag,
                           ranges=cfg.cam_meas_support_ranges)
    return state, table, n_init


def build_update(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """Linearize, gate and stack every in-state landmark's unconsumed
    measurements — no state update (UpdaterSLAM::update parity,
    UpdaterSLAM.cpp:254-470, up to the EKF update).

    Only the newest cfg.slam_stack_clones clone slots are gathered
    (measurements are consumed every frame, so older slots are empty).
    Returns (state, table, H [L·2·O, D], res, fail_count [L], n_used) with
    row noise cfg.sigma_pix_slam and column support
    cfg.slam_meas_support_ranges; `state` carries the updated fail counters
    and `table` has the consumed measurements cleared.  Single-depth
    landmarks stack their rows with the bearing columns projected out (the
    first two rows dropped, dof n − 2, at least 2 observations,
    UpdaterSLAM.cpp:286, 340-380); aruco rows are whitened and gated with
    chi2_multiplier_aruco."""
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

    p_G_cur = landmark_global(state, cfg, fej=False)
    p_G_fej = (landmark_global(state, cfg, fej=True) if cfg.use_fej
               else p_G_cur)
    ctx_w = uh.obs_context(state, cfg, slot_idx, cam_idx)
    H_x, H_fg, res, row_mask = uh.feature_jacobian_batch(
        state, cfg, gobs, p_G_cur, p_G_fej, ctx_w)
    H_x, H_lam = _chain_anchored(state, cfg, H_x, H_fg, p_G_cur)
    n_valid = row_mask.sum(dim=-1, dtype=torch.int32)
    if lrep.is_single(cfg.feat_rep_slam):
        # the ρ column into the state, the bearing projected out of the
        # whole system: the bearing fixed at init is not taken as exact
        Mr = _drop_bearing(H_lam[..., :2], torch.cat(
            [_set_slam_cols(H_x, cfg, H_lam[..., 2:3]), res[..., None]],
            dim=-1))
        H_full, res = Mr[..., :-1], Mr[..., -1]
        out_mask = (torch.arange(2 * O, device=dev) >= 2).expand(L, 2 * O)
        dof = torch.clamp(n_valid - 2, min=1)
        min_rows = 4  # required_meas = 2 observations
    else:
        H_full = _set_slam_cols(H_x, cfg, H_lam)
        out_mask = row_mask
        dof = torch.clamp(n_valid, min=1)
        min_rows = 1
    mult = cfg.chi2_multiplier_slam
    if cfg.num_aruco_tags > 0:
        c, mult = _aruco_whitening(cfg, state.slam_id)
        H_full, res = H_full * c[:, None, None], res * c[:, None]

    # χ² gates contract over the SLAM support columns only
    sup = cfg.slam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    gamma = uh.chi2_statistic(P_ss, uh.take_cols(H_full, sup), res, sigma)
    ok = (has_row & (n_valid >= min_rows) & torch.isfinite(gamma)
          & (gamma < ekf.chi2_gate(dof) * mult))

    keep = ok[:, None] & out_mask  # [L, 2O]
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


def update(state: VioState, cfg: FilterConfig, table: FeatureTable):
    """One EKF update over every in-state landmark's unconsumed
    measurements (UpdaterSLAM::update parity, UpdaterSLAM.cpp:254-470;
    updater_slam.py:679-715 of the reference): `build_update`'s stack,
    compressed on the SLAM support when it is taller than the support.
    Returns (state, table, fail_count [L], n_used)."""
    state, table, H, res, failed, n_used = build_update(state, cfg, table)
    if cfg.max_slam == 0:
        return state, table, failed, n_used
    ranges = cfg.slam_meas_support_ranges
    if H.shape[0] > sum(b - a for a, b in ranges):
        H, res = uh.compress_system_ranges(H, res, ranges, cfg.state_dim)
    r_diag = torch.full((H.shape[0],), cfg.sigma_pix_slam ** 2,
                        dtype=H.dtype, device=H.device)
    state = ekf.ekf_update(state, cfg, H, res, r_diag, ranges=ranges)
    return state, table, failed, n_used


def change_anchors(state: VioState, cfg: FilterConfig, dying_slot):
    """Re-anchor the landmarks whose anchor clone is about to be
    marginalized onto the newest clone (UpdaterSLAM::change_anchors /
    perform_anchor_change, UpdaterSLAM.cpp:481-647).

    The covariance takes the exact row map δλ_new = J [δλ_old; δx_Aold;
    δx_Anew] as cov' = M cov Mᵀ, with M the identity but for the landmark
    rows; the Jacobians at FEJ values, the value transform at the current
    values, and the landmark's FEJ reset to the transformed FEJ value.
    Each landmark's map touches only its own rows, so all of them go into
    one M and two D×D products (row maps with disjoint rows commute).
    An identity for max_slam = 0 and the global representations."""
    rep = cfg.feat_rep_slam
    if cfg.max_slam == 0 or not lrep.is_anchored(rep):
        return state
    L, D = cfg.max_slam, cfg.state_dim
    dtype, dev = state.cov.dtype, state.cov.device
    new_slot, dying = state.head.long(), dying_slot.long()
    need = state.slam_valid & (state.slam_anchor_slot == dying_slot)  # [L]
    a_cam = state.slam_anchor_cam.long()
    q_e, p_e = state.calib_ext_q[a_cam], state.calib_ext_p[a_cam]

    # single-depth landmarks have no FEJ value of their own: the
    # reference's get_xyz(true) reads the current one (Landmark.cpp:53-57)
    lam_f = state.slam_p if lrep.is_single(rep) else state.slam_p_fej
    lam_new_f, J_lam, J_xo, J_xn = lrep.anchor_change_jacobians(
        rep, lam_f, state.clones_q_fej[dying],
        state.clones_p_fej[dying], state.clones_q_fej[new_slot],
        state.clones_p_fej[new_slot], q_e, p_e)
    p_G = lrep.to_global(rep, state.slam_p, state.clones_q[dying],
                         state.clones_p[dying], q_e, p_e)
    lam_new = lrep.from_global(rep, p_G, state.clones_q[new_slot],
                               state.clones_p[new_slot], q_e, p_e)

    # each landmark's [3, D] block row, built out of place from one-hots
    # (the slots are device values, batched under vmap): the dying and the
    # new anchor's clone columns (the new one wins if the slots coincide)
    # and its own landmark columns; an identity block row where nothing
    # moves
    C = cfg.max_clones
    nd = need[:, None, None]
    cidx = torch.arange(C, device=dev)
    oh_d = (cidx == dying).to(dtype)[None, None, :, None]  # [1, 1, C, 1]
    oh_n = (cidx == new_slot).to(dtype)[None, None, :, None]
    clone_blk = (oh_n * J_xn[:, :, None, :]
                 + (1.0 - oh_n) * oh_d * J_xo[:, :, None, :])  # [L, 3, C, 6]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye_l = torch.eye(L, dtype=dtype, device=dev)
    lam_blk = torch.where(nd, J_lam, eye3)  # [L, 3, 3]
    slam_blk = lam_blk[:, :, None, :] * eye_l[:, None, :, None]  # [L,3,L,3]
    rows = torch.cat([
        state.cov.new_zeros((L, 3, cfg.clones_off)),
        torch.where(nd, clone_blk.reshape(L, 3, 6 * C), 0.0),
        slam_blk.reshape(L, 3, 3 * L),
        state.cov.new_zeros((L, 3, D - cfg.calib_dt_off))], dim=-1)
    eye = torch.eye(D, dtype=dtype, device=dev)
    s0, s1 = cfg.slam_off, cfg.slam_off + 3 * L
    M = torch.cat([eye[:s0], rows.reshape(3 * L, D), eye[s1:]])
    cov = M @ state.cov @ M.T
    return state.replace(
        cov=0.5 * (cov + cov.T),
        slam_p=torch.where(need[:, None], lam_new, state.slam_p),
        slam_p_fej=torch.where(need[:, None], lam_new_f, state.slam_p_fej),
        slam_anchor_slot=torch.where(need, state.head.to(torch.int32),
                                     state.slam_anchor_slot))


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
    one = torch.ones((cfg.state_dim,), dtype=state.cov.dtype,
                     device=state.cov.device)
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
