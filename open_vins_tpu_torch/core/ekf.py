"""EKF core over the static state layout: χ² gate table, covariance
propagation, clone augmentation and marginalization, the Kalman update in
its one-sweep form and in the three push-through forms of the joint vision
update, and delayed landmark initialization.

Counterpart of `open_vins_tpu/core/ekf.py` (StateHelper parity), all of it
but the 1-dof `initialize_landmark_single`.  "Marginalize" zeroes
covariance rows/cols instead of shrinking the matrix; padded measurement
rows carry H=0, res=0, R=1 so they are exact no-ops.  Ring-slot writes use
index tensors or selects, so nothing here waits for the device, and every
function runs under `torch.func.vmap`.  Factorizations use the `_ex` forms
of torch.linalg: a singular or indefinite system gives non-finite values
(as the reference's do), which the callers' gates and no-op selects catch,
instead of an exception and a host synchronization.

Every covariance downdate goes through `ops.kernels.symmetric_downdate`,
with K = PHt in the one-sweep form and K ≠ PHt in the push-through forms
(`kalman_update_math_info`, `_newton`, `_spd`).
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
        # the dt column [ω̂; v] added out of place: under vmap it is batched
        # and J is not, so an in-place write into J would fail
        dt_col = torch.cat([w_hat, state.v])
        unit = (torch.arange(D, device=dev) == cfg.calib_dt_off).to(dtype)
        J = J + dt_col[:, None] * unit[None, :]

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


def kalman_update_math(cov, H, res, r_diag, fuse_downdate=True, ranges=None):
    """The dense update: (dx [D], new_cov [D,D]) in the one-sweep form.

    With L = chol(H P Hᵀ + R) and Y = L⁻¹[PHtᵀ | res]:
        dx = Y₁ᵀ y,   P⁺ = sym(P − Y₁ᵀ Y₁)
    — with `fuse_downdate` the downdate runs the `symmetric_downdate`
    kernel on CUDA; without it, it is the plain product P − Y₁ᵀY₁ averaged
    with its transpose, the form the row-sharded update splits over ranks
    (`parallel/sharded_ekf.py`), as in the reference.  `ranges`:
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
    if fuse_downdate:
        K = Y1.T.contiguous()
        new_cov = symmetric_downdate(cov, K, K)
    else:
        new_cov = cov - Y1.T @ Y1
        new_cov = 0.5 * (new_cov + new_cov.T)
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


def marginalize_slam_slot(state: VioState, cfg: FilterConfig,
                          slot) -> VioState:
    """Free a SLAM landmark slot: zero its covariance rows/cols
    (StateHelper::marginalize_slam parity)."""
    off = cfg.slam_off + 3 * slot
    idx = torch.arange(cfg.state_dim, device=state.cov.device)
    keep = ~((idx >= off) & (idx < off + 3))
    lidx = torch.arange(cfg.max_slam, device=state.cov.device)
    return state.replace(
        cov=torch.where(keep[:, None] & keep[None, :], state.cov, 0.0),
        slam_valid=torch.where(lidx == slot, False, state.slam_valid),
        slam_id=torch.where(lidx == slot, -1, state.slam_id))


def _lu_solve(M, B):
    """M⁻¹B by a partially pivoted LU.  `lu_factor_ex` neither raises on a
    singular M nor waits on the device; an exactly singular pivot gives
    non-finite values, as the reference's LU does."""
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    return torch.linalg.lu_solve(LU, piv, B)


def _support_blocks(cov, H, res, ranges):
    """The push-through forms' pieces on the column support `ranges`:
    (P_cols = P_:s [D, k], P_ss [k, k], G = H_sᵀH_s, g = H_sᵀres)."""
    H_s = take_cols(H, ranges)  # [m, k]
    P_cols = take_cols(cov, ranges)  # [D, k]
    P_ss = take_cols(P_cols.T, ranges).T  # [k, k]
    return P_cols, P_ss, H_s.T @ H_s, H_s.T @ res


def kalman_update_math_info(cov, H, res, ranges, return_gamma=False):
    """Push-through (Woodbury) form of the update for a row-whitened H with
    static column support `ranges` (core/ekf.py:294-343 of the reference):

        G = H_sᵀH_s,  g = H_sᵀres,  M = I + G P_ss
        dx = P_:s M⁻¹ g,   P⁺ = P − P_:s M⁻¹ G P_s:

    one k×k LU solve; the downdate runs `symmetric_downdate` with
    K = P_:s and PHt = (M⁻¹ G P_s:)ᵀ (two products on the card).  With
    `return_gamma` also γ = resᵀ(H P Hᵀ + I)⁻¹res = resᵀres − gᵀP_ss M⁻¹g
    from the same solve.  Zero rows are exact no-ops."""
    D = cov.shape[0]
    P_cols, P_ss, G, g = _support_blocks(cov, H, res, ranges)
    eye = torch.eye(G.shape[0], dtype=cov.dtype, device=cov.device)
    B = torch.cat([G @ P_cols.T, g[:, None]], dim=1)  # [k, D+1]
    X = _lu_solve(eye + G @ P_ss, B)
    W, y = X[:, :D], X[:, D]
    dx = P_cols @ y
    new_cov = symmetric_downdate(cov, P_cols, W.T.contiguous())
    if return_gamma:
        return dx, new_cov, res @ res - g @ (P_ss @ y)
    return dx, new_cov


def chi2_gamma_info(cov, H, res, ranges):
    """γ = resᵀ(H P Hᵀ + I)⁻¹res for a row-whitened H with static column
    support, by one k×k solve (core/ekf.py:718-735 of the reference).  A
    singular system gives a non-finite γ, which the callers' gates drop."""
    _, P_ss, G, g = _support_blocks(cov, H, res, ranges)
    eye = torch.eye(G.shape[0], dtype=cov.dtype, device=cov.device)
    y, info = torch.linalg.solve_ex(eye + G @ P_ss, g[:, None])
    y = torch.where(info == 0, y[:, 0], torch.nan)
    return res @ res - g @ (P_ss @ y)


def newton_inverse(A, iters=22, refine=0):
    """A⁻¹ by Hotelling–Bodewig (Newton) iteration, matmuls only:
    X_{j+1} = X_j (2I − A X_j) from X_0 = I/‖A‖_F (core/ekf.py:345-372 of
    the reference).  Converges for the update's A = I + G·P (real spectrum
    in [1, λmax]) once 2^iters ≳ 16·‖A‖_F."""
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    X = eye / (torch.sqrt(torch.sum(A * A)) + 1e-30)
    for _ in range(iters):
        X = X @ (2.0 * eye - A @ X)
    for _ in range(refine):
        X = X + X @ (eye - A @ X)
    return X


def _polish(A, X, B, polish_tol, max_polish):
    """The applied solve W ≈ A⁻¹B refined by W ← W + X(B − A·W): the first
    sweep always, then further sweeps while the previous residual
    ‖B − A·W‖∞/‖B‖∞ is finite and above `polish_tol`, at most `max_polish`
    sweeps in all.  The reference's `lax.while_loop` exits on the residual;
    here every sweep runs, masked on the device by the same condition
    (what the while loop computes under `jax.vmap`), so nothing is read on
    the host and the loop stays vmappable.  A non-finite residual freezes
    W."""
    denom = torch.max(torch.abs(B)) + 1e-30
    W = X @ B
    active = torch.ones((), dtype=torch.bool, device=B.device)
    rr = torch.full((), torch.inf, dtype=B.dtype, device=B.device)
    for j in range(max_polish):
        if j > 0:
            active = (active & torch.isfinite(rr) & (rr > polish_tol))
        r = B - A @ W
        rr_j = torch.max(torch.abs(r)) / denom
        bad = ~torch.isfinite(rr_j)
        W = torch.where(active & ~bad, W + X @ r, W)
        rr = torch.where(active, torch.where(bad, torch.inf, rr_j), rr)
    return W, denom


def kalman_update_math_newton(cov, H, res, ranges, iters=22,
                              return_gamma=False, return_resid=False,
                              polish_tol=1e-3, max_polish=6,
                              noop_tol=5e-2, null_basis=None,
                              joseph=False):
    """The push-through update with the k×k inverse from `newton_inverse`
    (core/ekf.py:374-492 of the reference): the algebra of
    `kalman_update_math_info` with the LU replaced by Newton inversion and
    a polished solve (`_polish`).  If the applied solve's relative residual
    is not under `noop_tol`, or anything is non-finite, the update is an
    exact no-op; `return_resid` returns that residual
    (`StepDiag.newton_resid`).  `null_basis` deflates the gauge directions
    (`deflate_gauge_info`); `joseph` evaluates the Joseph-form covariance
    with one gain for every term.  Otherwise the downdate runs
    `symmetric_downdate` with K = P_:s and PHt = Wᵀ."""
    D = cov.shape[0]
    P_cols, P_ss, G, g = _support_blocks(cov, H, res, ranges)
    if null_basis is not None:
        G, g = deflate_gauge_info(G, g, null_basis)
    eye = torch.eye(G.shape[0], dtype=cov.dtype, device=cov.device)
    A = eye + G @ P_ss
    X = newton_inverse(A, iters=iters)
    B = torch.cat([G @ P_cols.T, g[:, None]], dim=1)  # [k, D+1]
    XB, denom = _polish(A, X, B, polish_tol, max_polish)
    # gate and report on the residual of the solve actually applied
    resid_rel = torch.max(torch.abs(B - A @ XB)) / denom
    resid_rel = torch.where(torch.isfinite(resid_rel), resid_rel, torch.inf)
    ok = torch.isfinite(XB).all() & (resid_rel < noop_tol)
    XB = torch.where(ok, XB, 0.0)
    W, y = XB[:, :D], XB[:, D]
    dx = P_cols @ y
    if joseph:
        # P⁺ = (I−KH)P(I−KH)ᵀ + KKᵀ with the support-structured products;
        # every covariance term uses the raw X (one gain), dx the polished y
        M2 = X @ G
        C = P_cols @ M2
        PX = P_cols @ X
        PW = P_cols @ (M2 @ P_cols.T)
        jc = cov - PW - PW.T + C @ (P_ss @ C.T) + C @ PX.T
        jc = 0.5 * (jc + jc.T)
        new_cov = torch.where(ok & torch.isfinite(jc).all(), jc, cov)
    else:
        new_cov = symmetric_downdate(cov, P_cols, W.T.contiguous())
    out = (dx, new_cov)
    if return_gamma:
        out = out + (res @ res - g @ (P_ss @ (X @ g)),)
    if return_resid:
        out = out + (resid_rel,)
    return out


_GAUGE_DEFLATE_REPS = frozenset((
    "GLOBAL_3D", "ANCHORED_3D", "ANCHORED_FULL_INVERSE_DEPTH",
    "ANCHORED_MSCKF_INVERSE_DEPTH", "ANCHORED_INVERSE_DEPTH_SINGLE"))


def gauge_deflation_supported(cfg: FilterConfig) -> bool:
    """Whether the gauge nullspace can be built for cfg.feat_rep_slam (not
    for GLOBAL_FULL_INVERSE_DEPTH, whose gauge rows are not implemented)."""
    return cfg.feat_rep_slam in _GAUGE_DEFLATE_REPS


def gauge_null_basis_support(state: VioState, cfg: FilterConfig, ranges):
    """Orthonormal basis [k, 4] of the VIO gauge nullspace (3 global
    translations and the global yaw) on the support columns, at FEJ values
    (core/ekf.py:507-557 of the reference): a clone moves by
    δθ = R_fej ẑ·δψ, δp = ẑ×p_fej·δψ − t, a GLOBAL_3D landmark by
    δp = ẑ×p_fej·δψ − t; anchored landmarks and calibration do not move.
    Columns are CGS2-orthonormalized; an all-zero column stays zero."""
    from open_vins_tpu_torch.ops import lie

    dtype, dev = state.cov.dtype, state.cov.device
    C, L, D = cfg.max_clones, cfg.max_slam, cfg.state_dim
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def moves(p_fej, th_col):
        """[n, k, 4] rows of n blocks: θ rows (if any) then position rows."""
        n = p_fej.shape[0]
        pos = torch.cat([eye3.expand(n, 3, 3),
                         torch.linalg.cross(zhat.expand(n, 3), p_fej,
                                            dim=-1)[..., None]], dim=-1)
        if th_col is None:
            return pos
        th = torch.cat([torch.zeros((n, 3, 3), dtype=dtype, device=dev),
                        th_col[..., None]], dim=-1)
        return torch.cat([th, pos], dim=1)

    Rs = lie.quat_2_rot(state.clones_q_fej)  # [C, 3, 3]
    cb = moves(state.clones_p_fej, Rs @ zhat)
    cb = cb * state.clone_valid.to(dtype)[:, None, None]
    blocks = [torch.zeros((cfg.clones_off, 4), dtype=dtype, device=dev),
              cb.reshape(6 * C, 4)]
    if L > 0 and cfg.feat_rep_slam == "GLOBAL_3D":
        lb = moves(state.slam_p_fej, None)
        lb = lb * state.slam_valid.to(dtype)[:, None, None]
        blocks.append(lb.reshape(3 * L, 4))
    else:
        blocks.append(torch.zeros((3 * L, 4), dtype=dtype, device=dev))
    blocks.append(torch.zeros((D - cfg.calib_dt_off, 4), dtype=dtype,
                              device=dev))
    N_s = take_cols(torch.cat(blocks).T, ranges).T  # [k, 4]
    cols = []
    for j in range(4):
        v = N_s[:, j]
        for _ in range(2):
            for u in cols:
                v = v - (u @ v) * u
        nrm = torch.sqrt(torch.sum(v * v))
        cols.append(torch.where(nrm > 1e-6, v / torch.clamp(nrm, min=1e-30),
                                0.0))
    return torch.stack(cols, dim=1)


def deflate_gauge_info(G, g, N):
    """G ← (I−NNᵀ)G(I−NNᵀ), g ← (I−NNᵀ)g: the gauge directions' information
    removed from the information form (core/ekf.py:560-576 of the
    reference)."""
    GN = G @ N
    G = G - N @ GN.T - GN @ N.T + N @ ((N.T @ GN) @ N.T)
    return G, g - N @ (N.T @ g)


def ekf_update_newton(state: VioState, cfg: FilterConfig, H, res, ranges,
                      return_resid=False):
    """`ekf_update` by the Newton push-through form (H row-whitened), with
    the gauge deflation when cfg.gauge_deflation and the Joseph form when
    cfg.newton_joseph; `return_resid` also returns the solve's relative
    residual."""
    nb = (gauge_null_basis_support(state, cfg, ranges)
          if cfg.gauge_deflation and gauge_deflation_supported(cfg) else None)
    out = kalman_update_math_newton(state.cov, H, res, ranges,
                                    iters=cfg.newton_iters,
                                    return_resid=return_resid, null_basis=nb,
                                    joseph=cfg.newton_joseph)
    new_state = boxplus(state, cfg, out[0]).replace(cov=out[1])
    return (new_state, out[2]) if return_resid else new_state


def _cholesky_or_nan(A):
    """chol(A), NaN where the factorization broke down (the reference's
    Cholesky result on a matrix that is not positive definite)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def kalman_update_math_spd(cov, H, res, ranges):
    """The push-through update by symmetric factorizations only
    (core/ekf.py:600-707 of the reference): with any factor L_p of an
    equilibrated, 3e-5-jittered P̃_ss ≈ P_ss,

        M = I + L_pᵀ G L_p,  Y = L_m⁻¹ [L_pᵀG | L_pᵀg],
        W = G − Y_VᵀY_V,  w = g − Y_Vᵀy_g,
        dx = P_:s w,  P⁺ = P − (P_:s W) P_s:

    The covariance-side Cholesky keeps the reference's defences: dead dims
    (diagonal under 1e-10·max) zeroed, correlations clamped to [-1, 1], a
    unit diagonal, the jitter escalated from 3e-5 to 3e-3 when the first
    factor fails (both factorizations run; the second is selected on the
    device) and the identity factor when both fail.  The downdate runs
    `symmetric_downdate` with K = P_:s W and PHt = P_:s."""
    P_cols, P_ss, G, g = _support_blocks(cov, H, res, ranges)
    k = G.shape[0]
    eye = torch.eye(k, dtype=cov.dtype, device=cov.device)
    d = torch.diagonal(P_ss)
    dmax = torch.max(torch.clamp(d, min=0.0))
    alive = d > 1e-10 * dmax
    s = torch.sqrt(torch.maximum(d, 1e-12 * dmax + 1e-30))
    P_hat = P_ss / (s[:, None] * s[None, :])
    P_hat = torch.clamp(0.5 * (P_hat + P_hat.T), -1.0, 1.0)
    P_hat = torch.where(alive[:, None] & alive[None, :], P_hat, 0.0)
    P_hat = P_hat - torch.diag(torch.diagonal(P_hat)) + eye
    L_lo = _cholesky_or_nan(P_hat + 3e-5 * eye)
    L_hi = _cholesky_or_nan(P_hat + 3e-3 * eye)
    L_hat = torch.where(torch.isfinite(L_lo).all(), L_lo, L_hi)
    L_hat = torch.where(torch.isfinite(L_hat).all(), L_hat, eye)
    L_p = torch.where(alive, s, 0.0)[:, None] * L_hat
    V = L_p.T @ G
    M = eye + V @ L_p
    L_m = _cholesky_or_nan(0.5 * (M + M.T))
    Y = torch.linalg.solve_triangular(
        L_m, torch.cat([V, (L_p.T @ g)[:, None]], dim=1), upper=False)
    Y_V, y_g = Y[:, :k], Y[:, k]
    W = G - Y_V.T @ Y_V
    W = 0.5 * (W + W.T)
    dx = P_cols @ (g - Y_V.T @ y_g)
    return dx, symmetric_downdate(cov, P_cols @ W, P_cols)


def ekf_update_spd(state: VioState, cfg: FilterConfig, H, res,
                   ranges) -> VioState:
    """`ekf_update` by the symmetric push-through form (H row-whitened)."""
    dx, cov = kalman_update_math_spd(state.cov, H, res, ranges)
    return boxplus(state, cfg, dx).replace(cov=cov)


def ekf_update_info(state: VioState, cfg: FilterConfig, H, res,
                    ranges) -> VioState:
    """`ekf_update` by the push-through (Woodbury) form (H row-whitened)."""
    dx, cov = kalman_update_math_info(state.cov, H, res, ranges)
    return boxplus(state, cfg, dx).replace(cov=cov)


def initialize_landmark(state: VioState, cfg: FilterConfig, slot, feat_id,
                        p_f, H_x, H_f, res, sigma_pix_norm, row_mask):
    """Insert a landmark into slot `slot` by delayed initialization
    (StateHelper::initialize, StateHelper.cpp:393-577; core/ekf.py:762-851
    of the reference): the feature system res = H_x δx + H_f δf + n is
    rotated by the orthogonal basis of H_f; its top 3 rows seed the
    landmark's covariance and cross-covariance,

        P_ff = R1⁻¹ (Hx1 P Hx1ᵀ + σ² I) R1⁻ᵀ,   P_fx = −R1⁻¹ Hx1 P,

    and its value p_f + R1⁻¹ res1 (FEJ: the triangulated p_f).  The slot's
    rows and columns are written by a select, so `slot` may be a device
    value (and batched under vmap).  Returns (state, H_up [m−3, D],
    res_up [m−3], up_mask [m−3]): the leftover rows for an EKF update."""
    from open_vins_tpu_torch.models.update_helper import householder_rotate

    m = H_f.shape[0]
    D, L = cfg.state_dim, cfg.max_slam
    dtype, dev = state.cov.dtype, state.cov.device
    rm = row_mask[:, None]
    H_f = torch.where(rm, H_f, 0.0)
    H_x = torch.where(rm, H_x, 0.0)
    res = torch.where(row_mask, res, 0.0)
    R_full, B = householder_rotate(H_f, torch.cat([H_x, res[:, None]], 1))
    Hx_rot, res_rot = B[:, :-1], B[:, -1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    R1_inv = torch.linalg.solve_triangular(R_full[:3, :3] + eye3 * 1e-12,
                                           eye3, upper=True)
    Hx1 = Hx_rot[:3]
    HxP = Hx1 @ state.cov  # [3, D]
    P_ff = R1_inv @ (HxP @ Hx1.T + sigma_pix_norm ** 2 * eye3) @ R1_inv.T
    P_fx = -(R1_inv @ HxP)  # [3, D]

    # the slot's rows, columns and corner, placed by a one-hot [D, 3]
    off = cfg.slam_off + 3 * slot
    idx = torch.arange(D, device=dev)
    E = (idx[:, None] == off + torch.arange(3, device=dev)[None, :]).to(dtype)
    in_blk = (idx >= off) & (idx < off + 3)
    rows_full = E @ P_fx  # [D, D], nonzero only on the slot's rows
    corner = E @ (0.5 * (P_ff + P_ff.T)) @ E.T
    r, c = in_blk[:, None], in_blk[None, :]
    cov = torch.where(r & c, corner,
                      torch.where(r, rows_full,
                                  torch.where(c, rows_full.T, state.cov)))

    at = (torch.arange(L, device=dev) == slot)
    new_state = state.replace(
        cov=cov,
        slam_p=torch.where(at[:, None], p_f + R1_inv @ res_rot[:3],
                           state.slam_p),
        slam_p_fej=torch.where(at[:, None], p_f, state.slam_p_fej),
        slam_id=torch.where(at, feat_id.to(torch.int32), state.slam_id),
        slam_valid=at | state.slam_valid)
    up_mask = torch.ones((m - 3,), dtype=torch.bool, device=dev)
    return new_state, Hx_rot[3:], res_rot[3:], up_mask


def initialize_landmark_single(state: VioState, cfg: FilterConfig, slot,
                               feat_id, lam0, H_x, h_f, res, sigma_pix_norm,
                               row_mask):
    """1-dof delayed initialization for ANCHORED_INVERSE_DEPTH_SINGLE
    (UpdaterSLAM.cpp:190-240 with landmark_size 1; core/ekf.py:853-916 of
    the reference): `initialize_landmark`'s orthogonal split with the
    scalar inverse depth ρ as the new variable.  Only the covariance row
    and column `slam_off + 3·slot` are seeded; the slot's two bearing
    entries keep zero covariance and hold the fixed bearing as data.

    lam0 [3] = [ρ, b_x, b_y] (the bearing final); h_f [m, 1] the ρ column,
    with the bearing columns already nullspace-projected out of H_x, h_f
    and res.  Returns (state, H_up [m−1, D], res_up [m−1], up_mask)."""
    from open_vins_tpu_torch.models.update_helper import householder_rotate

    m = h_f.shape[0]
    D, L = cfg.state_dim, cfg.max_slam
    dtype, dev = state.cov.dtype, state.cov.device
    rm = row_mask[:, None]
    h_f = torch.where(rm, h_f, 0.0)
    H_x = torch.where(rm, H_x, 0.0)
    res = torch.where(row_mask, res, 0.0)
    R_full, B = householder_rotate(h_f, torch.cat([H_x, res[:, None]], 1))
    Hx_rot, res_rot = B[:, :-1], B[:, -1]
    r1 = R_full[0, 0]
    r1_inv = torch.where(torch.abs(r1) > 1e-9,
                         1.0 / torch.where(r1 == 0, 1.0, r1), 0.0)
    HxP = Hx_rot[0:1] @ state.cov  # [1, D]
    P_ff = r1_inv ** 2 * (HxP @ Hx_rot[0:1].T + sigma_pix_norm ** 2)
    P_fx = -(r1_inv * HxP)[0]  # [D]

    # the ρ row, column and corner, placed by selects (slot may be a device
    # value)
    idx = torch.arange(D, device=dev)
    at_d = idx == cfg.slam_off + 3 * slot
    r, c = at_d[:, None], at_d[None, :]
    cov = torch.where(r & c, P_ff[0, 0],
                      torch.where(r, P_fx[None, :],
                                  torch.where(c, P_fx[:, None], state.cov)))

    at = (torch.arange(L, device=dev) == slot)
    lam_new = torch.cat([lam0[:1] + r1_inv * res_rot[0], lam0[1:]])
    new_state = state.replace(
        cov=cov,
        slam_p=torch.where(at[:, None], lam_new, state.slam_p),
        slam_p_fej=torch.where(at[:, None], lam0, state.slam_p_fej),
        slam_id=torch.where(at, feat_id.to(torch.int32), state.slam_id),
        slam_valid=at | state.slam_valid)
    up_mask = torch.ones((m - 1,), dtype=torch.bool, device=dev)
    return new_state, Hx_rot[1:], res_rot[1:], up_mask
