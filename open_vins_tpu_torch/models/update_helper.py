"""Measurement linearization: per-feature Jacobians, nullspace projection,
χ² statistic and measurement compression.

Counterpart of `open_vins_tpu/models/update_helper.py` (UpdaterHelper
parity, UpdaterHelper.cpp:192-487), batched over the F features of an update
with a leading feature dimension instead of a vmap; `feature_jacobian` is
the single-feature case (the sequential landmark init's).
`compress_system` (the Householder TSQR) runs its row blocks through the
hand-written `householder_qr_blocks` kernel on CUDA;
`compress_system_ranges` (CholeskyQR2) is the MSCKF update's compression,
`reduce_joint_system` the joint update's exact reduction (Householder, by
the same kernel) and `compress_system_cholesky` the normal-equation one of
`fast_compress`.
"""

from __future__ import annotations

import dataclasses

import torch

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import TensorRecord, VioState
from open_vins_tpu_torch.ops import cameras, lie, smallmat
from open_vins_tpu_torch.ops.kernels import householder_qr_blocks


@dataclasses.dataclass
class GatheredObs(TensorRecord):
    """Per-feature observations, [F, O] (O = max_clones · num_cams)."""

    clone_slot: torch.Tensor  # [F, O] int — clone ring slot of each obs
    cam: torch.Tensor  # [F, O] int — camera index
    uv: torch.Tensor  # [F, O, 2] raw pixel measurement
    uvn: torch.Tensor  # [F, O, 2] normalized measurement
    mask: torch.Tensor  # [F, O] valid


@dataclasses.dataclass
class ObsContext(TensorRecord):
    """Per-obs-slot state context (clone poses + camera calib), computed once
    per frame and shared by every feature.  Leading dim O."""

    R_GtoI: torch.Tensor  # [O, 3, 3]
    R_GtoI_fej: torch.Tensor  # [O, 3, 3]
    p_c: torch.Tensor  # [O, 3]
    p_c_fej: torch.Tensor  # [O, 3]
    R_ItoC: torch.Tensor  # [O, 3, 3]
    p_IinC: torch.Tensor  # [O, 3]
    zeta: torch.Tensor  # [O, 8]


def obs_context(state: VioState, cfg: FilterConfig, slot_idx, cam_idx
                ) -> ObsContext:
    """The [O]-indexed state context for (clone slot, camera) pairs."""
    slot, cam = slot_idx.long(), cam_idx.long()
    q_c, p_c = state.clones_q[slot], state.clones_p[slot]
    q_c_fej = state.clones_q_fej[slot] if cfg.use_fej else q_c
    p_c_fej = state.clones_p_fej[slot] if cfg.use_fej else p_c
    return ObsContext(
        R_GtoI=lie.quat_2_rot(q_c),
        R_GtoI_fej=lie.quat_2_rot(q_c_fej),
        p_c=p_c,
        p_c_fej=p_c_fej,
        R_ItoC=lie.quat_2_rot(state.calib_ext_q[cam]),
        p_IinC=state.calib_ext_p[cam],
        zeta=state.calib_intr[cam],
    )


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def feature_jacobian_batch(state: VioState, cfg: FilterConfig,
                           gobs: GatheredObs, p_f, p_f_fej, ctx: ObsContext):
    """Stacked measurement systems of F features (GLOBAL_3D representation,
    get_feature_jacobian_full parity) with FEJ substitution of the clone and
    feature linearization points (UpdaterHelper.cpp:353-363).

    gobs: [F, O] (slot/cam rows identical per feature); p_f / p_f_fej
    [F, 3]; ctx over the [O] slot layout.  Rows of an observation whose
    current or FEJ camera depth is under 5 cm are zeroed and dropped from
    `row_mask` (their 1/z² Jacobians break the f32 chol(S) downstream).
    Returns (H_x [F, 2O, D], H_f [F, 2O, 3], res [F, 2O], row_mask [F, 2O]).
    """
    D = cfg.state_dim
    F, O = gobs.mask.shape
    dtype, dev = state.cov.dtype, state.cov.device
    C, N = cfg.max_clones, cfg.num_cams
    slot_idx, cam_idx = gobs.clone_slot[0], gobs.cam[0]

    # geometry at current estimates
    p_FinI = _mv(ctx.R_GtoI, p_f[:, None, :] - ctx.p_c)  # [F, O, 3]
    p_FinC = _mv(ctx.R_ItoC, p_FinI) + ctx.p_IinC
    z_safe = torch.where(torch.abs(p_FinC[..., 2]) > 1e-6, p_FinC[..., 2],
                         1e-6)
    x_n = (p_FinC[..., 0] / z_safe).reshape(-1)
    y_n = (p_FinC[..., 1] / z_safe).reshape(-1)
    zeta_cols = ctx.zeta.T[:, None, :].expand(8, F, O).reshape(8, F * O)
    uv_pred, J_dist, J_zeta = cameras.distort_jacobians_soa(
        cfg.cam_model, zeta_cols, x_n, y_n)
    uv_pred = uv_pred.T.reshape(F, O, 2)
    J_dist = J_dist.permute(2, 0, 1).reshape(F, O, 2, 2)
    J_zeta = J_zeta.permute(2, 0, 1).reshape(F, O, 2, 8)
    res = gobs.uv - uv_pred

    # FEJ-linearized geometry: only dz/dzn stays at the current estimate
    p_FinI_fej = _mv(ctx.R_GtoI_fej, p_f_fej[:, None, :] - ctx.p_c_fej)
    p_FinC_fej = _mv(ctx.R_ItoC, p_FinI_fej) + ctx.p_IinC
    z_fej = torch.where(torch.abs(p_FinC_fej[..., 2]) > 1e-6,
                        p_FinC_fej[..., 2], 1e-6)
    inv_z = 1.0 / z_fej
    zero = torch.zeros_like(inv_z)
    J_proj = torch.stack([
        torch.stack([inv_z, zero, -p_FinC_fej[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, inv_z, -p_FinC_fej[..., 1] * inv_z * inv_z], -1),
    ], dim=-2)  # [F, O, 2, 3]
    dz_dpC = J_dist @ J_proj

    dpC_dth = ctx.R_ItoC @ lie.skew(p_FinI_fej)  # w.r.t. clone δθ
    RR = ctx.R_ItoC @ ctx.R_GtoI_fej  # w.r.t. feature (−: clone δp)
    H_f_o = dz_dpC @ RR
    H_th = dz_dpC @ dpC_dth
    H_p = -(dz_dpC @ RR)

    # per-observation depth gate (r05): a feature within 5 cm of ANY clone
    # camera has its rows zeroed exactly
    depth_ok = (p_FinC[..., 2] > 0.05) & (p_FinC_fej[..., 2] > 0.05)
    vmask = gobs.mask & depth_ok
    w = vmask.to(dtype)[..., None, None]  # [F, O, 1, 1]

    blk = torch.cat([H_th, H_p], dim=-1) * w  # [F, O, 2, 6]
    oh_c = (slot_idx[:, None] == torch.arange(C, device=dev)[None]).to(dtype)
    clone_cols = (blk[:, :, :, None, :]
                  * oh_c[None, :, None, :, None]).reshape(F, O, 2, 6 * C)
    oh_n = (cam_idx[:, None] == torch.arange(N, device=dev)[None]).to(dtype)
    if cfg.calib_cam_extrinsics:
        H_cth = dz_dpC @ lie.skew(_mv(ctx.R_ItoC, p_FinI_fej))
        ext_blk = torch.cat([H_cth, dz_dpC], dim=-1) * w
        ext_cols = (ext_blk[:, :, :, None, :]
                    * oh_n[None, :, None, :, None]).reshape(F, O, 2, 6 * N)
    else:
        ext_cols = torch.zeros((F, O, 2, 6 * N), dtype=dtype, device=dev)
    if cfg.calib_cam_intrinsics:
        intr_cols = ((J_zeta * w)[:, :, :, None, :]
                     * oh_n[None, :, None, :, None]).reshape(F, O, 2, 8 * N)
    else:
        intr_cols = torch.zeros((F, O, 2, 8 * N), dtype=dtype, device=dev)

    def zeros(width):
        return torch.zeros((F, O, 2, width), dtype=dtype, device=dev)

    rows = torch.cat([
        zeros(cfg.clones_off),  # imu block
        clone_cols,
        zeros(cfg.calib_ext_off - cfg.slam_off),  # slam + dt blocks
        ext_cols,
        intr_cols,
        zeros(D - cfg.calib_intr_off - 8 * N),  # imu-intrinsic tail
    ], dim=-1)
    H_x = rows.reshape(F, 2 * O, D)
    H_f = (H_f_o * w).reshape(F, 2 * O, 3)
    res_out = (res * w[..., 0]).reshape(F, 2 * O)
    row_mask = torch.repeat_interleave(vmask, 2, dim=-1)
    return H_x, H_f, res_out, row_mask


def feature_jacobian(state: VioState, cfg: FilterConfig, obs: GatheredObs,
                     p_f, p_f_fej, ctx: ObsContext | None = None):
    """The stacked system of one feature: `obs` over [O] observations,
    p_f / p_f_fej [3] (get_feature_jacobian_full parity,
    update_helper.py:93-212 of the reference), with the context built from
    `state` unless given.  Returns (H_x [2O, D], H_f [2O, 3], res [2O],
    row_mask [2O])."""
    if ctx is None:
        ctx = obs_context(state, cfg, obs.clone_slot, obs.cam)
    one = GatheredObs(*(v[None] for _, v in obs.items()))
    out = feature_jacobian_batch(state, cfg, one, p_f[None], p_f_fej[None],
                                 ctx)
    return tuple(a[0] for a in out)


def householder_rotate(H_f, M):
    """Apply Qᵀ — the complete-QR orthogonal factor of H_f [..., m, k] — to
    H_f and M [..., m, n] by k unrolled Householder reflectors.

    Returns (R_f [..., m, k], QᵀM [..., m, n]): rows k: of QᵀM span the
    left nullspace of H_f.  All-zero columns yield identity reflectors."""
    m, k = H_f.shape[-2:]
    ridx = torch.arange(m, device=H_f.device)
    A, B = H_f, M
    for j in range(k):
        x = torch.where(ridx >= j, A[..., :, j], 0.0)
        normx = torch.sqrt(torch.sum(x * x, dim=-1))
        sgn = torch.where(A[..., j, j] >= 0, 1.0, -1.0)
        beta = -sgn * normx
        v = x - beta[..., None] * (ridx == j).to(A.dtype)
        vn2 = torch.sum(v * v, dim=-1)
        scale = torch.where(vn2 > 1e-30, 2.0 / vn2, 0.0)
        sv = (scale[..., None] * v)[..., :, None]
        A = A - sv * (v[..., None, :] @ A)
        B = B - sv * (v[..., None, :] @ B)
    return A, B


def nullspace_project(H_x, H_f, res):
    """Left-nullspace projection of H_f (UpdaterHelper.cpp:426-454):
    [..., m, D], [..., m, 3], [..., m] -> (H_proj [..., m-3, D],
    res_proj [..., m-3]).  Invalid rows must already be zeroed."""
    _, B = householder_rotate(H_f, torch.cat([H_x, res[..., None]], dim=-1))
    return B[..., 3:, :-1], B[..., 3:, -1]


def _round_up(x, m):
    return ((x + m - 1) // m) * m


_TSQR_MIN_RATIO = 4  # TSQR only for m >= 4·n, as in the reference


def _tsqr_r(A):
    """R factor of a tall [m, n] matrix by TSQR row-block reduction: g
    independent [B, n] Householder QRs (`householder_qr_blocks`, the
    hand-written kernel on CUDA) and one small QR of the stacked [g·n, n]
    R factors.  Any R with RᵀR = AᵀA is an orthogonal transform of the same
    system (the UpdaterHelper.cpp:456-487 argument); zero-padded rows are
    exact no-ops.  One dense QR when m < _TSQR_MIN_RATIO·n.
    B = 2n rounded up to 32 rows; n is not padded."""
    m, n = A.shape
    if m < _TSQR_MIN_RATIO * n:
        return torch.linalg.qr(A, mode="r").R
    B = _round_up(2 * n, 32)
    g = max(1, -(-m // B))
    A_p = A.new_zeros((g * B, n))
    A_p[:m] = A
    R_b = householder_qr_blocks(A_p.reshape(g, B, n))  # [g, n, n]
    return torch.linalg.qr(R_b.reshape(g * n, n), mode="r").R[:n]


def compress_system(H, res, out_rows):
    """QR measurement compression (UpdaterHelper.cpp:456-487 parity): R of
    the augmented [H | res]; its leading `out_rows` rows are the compressed
    system (H_c [out_rows, D], res_c [out_rows]) under the same orthogonal
    transform.  Tall systems go through the TSQR reduction (`_tsqr_r`)."""
    m, D = H.shape
    R = _tsqr_r(torch.cat([H, res[:, None]], dim=1))
    k = min(out_rows, R.shape[0])
    H_c = H.new_zeros((out_rows, D))
    H_c[:k] = R[:k, :D]
    res_c = H.new_zeros((out_rows,))
    res_c[:k] = R[:k, D]
    return H_c, res_c


def take_cols(M, ranges):
    """Static-slice gather of column ranges: M[..., ∪ranges]."""
    return torch.cat([M[..., a:b] for a, b in ranges], dim=-1)


def scatter_cols(M_s, ranges, D):
    """Inverse of take_cols: place [..., k] back into [..., D] zeros."""
    out = M_s.new_zeros(M_s.shape[:-1] + (D,))
    off = 0
    for a, b in ranges:
        out[..., a:b] = M_s[..., off:off + (b - a)]
        off += b - a
    return out


def _guarded_cholesky(G, eye):
    """chol(G), or the identity where the factorization broke down (the
    reference's NaN result replaced element-wise by the identity)."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where((info == 0) & torch.isfinite(L), L, eye)


def _cholqr2_r(A, shift_rel=3e-6):
    """R factor of a tall [m, n] matrix by shifted CholeskyQR2:
    R₁ = chol(AᵀA + sI)ᵀ, Q₁ = A R₁⁻¹, R = chol(Q₁ᵀQ₁ + s₂I)ᵀ R₁.  Both
    Cholesky factors are unique, so R is a well-defined function of A."""
    n = A.shape[1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    G = A.T @ A
    s1 = shift_rel * (torch.trace(G) / n) + 1e-30
    L1 = _guarded_cholesky(G + s1 * eye, eye)
    L1_inv = torch.linalg.solve_triangular(L1, eye, upper=False)
    Q1 = A @ L1_inv.T
    G2 = Q1.T @ Q1
    s2 = shift_rel * (torch.trace(G2) / n) + 1e-30
    L2 = _guarded_cholesky(G2 + s2 * eye, eye)
    return L2.T @ L1.T  # upper triangular [n, n]


def compress_system_ranges(H, res, ranges, D):
    """QR compression restricted to the static column support `ranges`
    (rows are exactly zero outside it): (H_c [k, D], res_c [k]) with
    k = |support|, by CholeskyQR2 of [H_s | res]."""
    k = sum(b - a for a, b in ranges)
    A = torch.cat([take_cols(H, ranges), res[:, None]], dim=1)
    R = _cholqr2_r(A)
    kk = min(k, R.shape[0])
    Hc_s = H.new_zeros((k, k))
    Hc_s[:kk] = R[:kk, :k]
    res_c = H.new_zeros((k,))
    res_c[:kk] = R[:kk, k]
    return scatter_cols(Hc_s, ranges, D), res_c


def live_rows(H, res):
    """[..., m] bool: the rows of the stack [H | res] that hold a nonzero
    entry (a zero row adds nothing to an update)."""
    return (H != 0).any(dim=-1) | (res != 0)


_QR_BLOCK_ROWS = 640  # the most rows householder_qr_blocks keeps in registers


def householder_r(A):
    """R [n, n] of a Householder QR of A [m, n] (float32, m >= n): row
    blocks of at most `_QR_BLOCK_ROWS` rows through `householder_qr_blocks`
    (the hand-written kernel on CUDA, one batched launch under vmap), their
    stacked R factors reduced again until one block is left.  Zero-padded
    rows are exact no-ops; no Gram matrix is formed."""
    m, n = A.shape
    g = -(-m // _QR_BLOCK_ROWS)
    if g * n >= m:  # blocks would not shrink the stack: one block
        g = 1
    rows = max(n, _round_up(-(-m // g), 32))
    A_p = torch.nn.functional.pad(A, (0, 0, 0, g * rows - m))
    R_b = householder_qr_blocks(A_p.reshape(g, rows, n))
    return R_b[0] if g == 1 else householder_r(R_b.reshape(g * n, n))


def reduce_joint_system(H, res, ranges, D, cam_rows, cam_ranges):
    """Exact reduction of the whitened joint stack (H [m, D], res [m]) to
    k = |support| rows on the static column support `ranges` that give the
    same Kalman update: (H_c [k, D], res_c [k], n_live), n_live the stack's
    nonzero rows.  H_cᵀH_c = H_sᵀH_s and H_cᵀres_c = H_sᵀres up to float32
    rounding, for any number of live rows: only orthogonal transforms (a
    Householder QR, `householder_r`), no Gram matrix, shift or jitter.

    `cam_rows` ((start, stop) row ranges) hold rows that are zero outside
    the camera support `cam_ranges` ⊂ `ranges` (the MSCKF and delayed-init
    rows): they are reduced first on those few columns, to the R of
    [H_cam | res_cam]; its rows join the other rows (the landmarks') for
    the QR on the whole support, of which the leading k rows are kept.  The
    QR of [A₁; A₂] and of [R(A₁); A₂] give the same RᵀR."""
    k = sum(b - a for a, b in ranges)
    bounds = [0, *(i for span in cam_rows for i in span), H.shape[0]]
    rest = [(a, b) for a, b in zip(bounds[::2], bounds[1::2]) if b > a]

    def rows_of(M, spans):
        return torch.cat([M[a:b] for a, b in spans])

    H_cam, r_cam = rows_of(H, cam_rows), rows_of(res, cam_rows)
    A1 = torch.cat([take_cols(H_cam, cam_ranges), r_cam[:, None]], dim=1)
    H_o, r_o = rows_of(H, rest), rows_of(res, rest)
    A2 = torch.cat([take_cols(H_o, ranges), r_o[:, None]], dim=1)
    n_live = (live_rows(A1[:, :-1], A1[:, -1]).sum(dtype=torch.int32)
              + live_rows(A2[:, :-1], A2[:, -1]).sum(dtype=torch.int32))
    R1 = householder_r(A1)  # [k_cam + 1, k_cam + 1]
    # R1's rows on the whole support: its camera columns scattered into
    # the support's positions, its residual column last
    R1_s = take_cols(scatter_cols(R1[:, :-1], cam_ranges, D), ranges)
    R = householder_r(torch.cat([torch.cat([R1_s, R1[:, -1:]], dim=1), A2]))
    return scatter_cols(R[:k, :k], ranges, D), R[:k, k], n_live


def compress_system_cholesky(H, res, out_rows):
    """Normal-equation compression (update_helper.py:380-409 of the
    reference, the `fast_compress` option): H_c = chol(HᵀH + jI)ᵀ and
    res_c = L⁻¹Hᵀres with the jitter j = 1e-6·(tr(HᵀH)/D + 1), padded with
    zero rows to `out_rows` ≥ D.  A failed factorization gives non-finite
    rows, as the reference's does.

    The jitter puts the Gram matrix's condition at the edge of f32 (about
    3e7 on a SLAM frame with one MSCKF feature), where one library's f32
    Cholesky breaks down and another's does not: torch's does on Gram
    matrices that the reference's LAPACK factors.  So the Gram matrix is
    formed in f32, as in the reference, and factored in f64; H_c and res_c
    are f32.  Any factor with H_cᵀH_c = HᵀH + jI gives the same update."""
    D = H.shape[1]
    G = H.T @ H
    jitter = 1e-6 * (torch.trace(G) / D + 1.0)
    L, info = torch.linalg.cholesky_ex(
        (G + jitter * torch.eye(D, dtype=H.dtype, device=H.device)).double())
    L = torch.where(info == 0, L.to(H.dtype), torch.nan)
    res_c = torch.linalg.solve_triangular(L, (H.T @ res)[:, None],
                                          upper=False)[:, 0]
    pad = out_rows - D
    return (torch.cat([L.T, H.new_zeros((pad, D))]),
            torch.cat([res_c, H.new_zeros((pad,))]))


def chi2_statistic(state_cov, H, res, sigma):
    """γ = resᵀ (H P Hᵀ + σ²I)⁻¹ res per feature (UpdaterMSCKF chi2 gate,
    UpdaterMSCKF.cpp:208-234).  H [..., m, k], res [..., m], state_cov
    [k, k].  Systems with m <= 32 rows go through the unrolled-Cholesky
    quadratic form, as in the reference; larger ones through `solve_ex`,
    where a singular S gives γ = NaN (the reference's solve gives
    non-finite values) and the callers' `isfinite(γ)` gates drop the
    candidate."""
    m = H.shape[-2]
    eye = torch.eye(m, dtype=H.dtype, device=H.device)
    S = H @ state_cov @ H.mT + sigma**2 * eye
    if m <= 32:
        return smallmat.chi2_quadform(S, res)
    sol, info = torch.linalg.solve_ex(S, res[..., None])
    gamma = torch.sum(res * sol[..., 0], dim=-1)
    return torch.where(info == 0, gamma, torch.nan)
