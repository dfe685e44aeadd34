"""Dynamic (in-motion) visual-inertial initialization.

Counterpart of `open_vins_tpu/init/dynamic_init.py`
(ov_init::DynamicInitializer, DynamicInitializer.cpp:44-1107), with the
same stages and names:

  1. IMU preintegration between the P pose times (the CPI role), every
     segment and sample at once (prefix products of the sample rotations,
     then sums, where the reference runs a `lax.scan`); the Jacobians are
     forward-mode (`torch.func.jacfwd`), as the reference's come from
     `jax.jacfwd`, with the six bias columns through the preintegration in
     closed form (`_preintegrate_jac`);
  2. the closed-form linear system over [features, v0, gravity]
     (DynamicInitializer.cpp:310-385), with |g| = 9.81 enforced by
     alternating projection;
  3. the maximum-likelihood refinement: Levenberg-Marquardt over poses,
     velocities, biases, gravity and features with preintegration and
     reprojection residuals (the Ceres DENSE_SCHUR solve, …:622-894);
  4. the covariance from the Gauss-Newton information at the optimum
     (…:978-1080), inflated, eigen-clamped and gated.

Every stage stays on the device: the LM accept/reject is a select and the
factorizations are the `_ex` forms, whose failure gives non-finite values
(as `jnp.linalg` does) and so `success = False` instead of an exception.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.init.static_init import gram_schmidt_gravity
from open_vins_tpu_torch.models.propagator import _rotation_prefixes
from open_vins_tpu_torch.ops import lie


class DynamicInitOptions(NamedTuple):
    gravity_mag: float = 9.81
    sigma_pix_norm: float = 1.0 / 460.0  # reprojection noise, normalized
    sigma_w: float = 1.6968e-4
    sigma_a: float = 2.0e-3
    sigma_wb: float = 1.9393e-5
    sigma_ab: float = 3.0e-3
    mle_iters: int = 30
    # bias priors: over a ~2 s window a constant accel bias is nearly
    # indistinguishable from a scale change (the reference's
    # Factor_GenericPrior terms, DynamicInitializer.cpp:714-894)
    sigma_bg_prior: float = 0.01
    sigma_ba_prior: float = 0.05
    lin_iters: int = 3  # |g|-constraint alternations
    inflation_ori: float = 10.0  # covariance inflation (…:1076-1080)
    inflation_vel: float = 100.0
    inflation_bg: float = 100.0
    inflation_ba: float = 100.0
    # the excitation gate: under near-constant specific force and rotation
    # the monocular scale is unobservable, so the init refuses unless the
    # per-axis range (max − min) of the measured accel or gyro exceeds
    # these (a range, unlike a std, is invariant to the segment padding)
    min_excite_a: float = 0.35  # m/s² range of measured accel over window
    min_excite_w: float = 0.15  # rad/s range of measured gyro


@dataclasses.dataclass
class DynInitInput(TensorRecord):
    """Fixed-shape problem data: P pose times; per segment i (0..P-2) an
    IMU window of K samples padded by repeating the last row; F features
    observed at the pose times (camera 0)."""

    t_pose: torch.Tensor  # [P]
    imu_t: torch.Tensor  # [P-1, K]
    imu_w: torch.Tensor  # [P-1, K, 3]
    imu_a: torch.Tensor  # [P-1, K, 3]
    uvn: torch.Tensor  # [F, P, 2] normalized observations
    obs_mask: torch.Tensor  # [F, P]
    R_ItoC: torch.Tensor  # [3, 3]
    p_IinC: torch.Tensor  # [3]


@dataclasses.dataclass
class DynInitResult(TensorRecord):
    success: torch.Tensor
    # state at the newest pose time, world = gravity-aligned (z up)
    q_GtoI: torch.Tensor  # [4] JPL
    p: torch.Tensor  # [3]
    v: torch.Tensor  # [3]
    bg: torch.Tensor
    ba: torch.Tensor
    cov15: torch.Tensor  # [15, 15] covariance of [θ p v bg ba]
    # the whole window (I0 frame), for seeding clones
    R_I0toIk: torch.Tensor  # [P, 3, 3]
    p_k_in0: torch.Tensor  # [P, 3]


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _nan_unless(ok, x):
    """x where the factorization succeeded (info == 0), else NaN — what
    `jnp.linalg` returns for a failed factorization."""
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def _solve(A, b):
    x, info = torch.linalg.solve_ex(A, b[..., None])
    return _nan_unless(info == 0, x[..., 0])


def _exclusive_cumsum(x, dim):
    c = torch.cumsum(x, dim=dim)
    return c - x, c


def _preintegrate_terms(imu_t, imu_w, imu_a, bg, ba):
    """The per-sample pieces of a segment's preintegration: dt [..., K-1],
    x = −ŵ dt [..., K-1, 3], R_k (start → sample k) [..., K-1, 3, 3], the
    rotated accel a_k = R_kᵀ â_k [..., K-1, 3], and the end rotation.  The
    R_k are the prefix products of exp(x_k), ⌈log₂ K⌉ levels of batched
    3×3 products (the reference composes them one sample after another;
    the products agree to f32 rounding)."""
    dt = torch.clamp(imu_t[..., 1:] - imu_t[..., :-1], min=0.0)
    w_hat = 0.5 * (imu_w[..., :-1, :] + imu_w[..., 1:, :]) - bg
    x = -w_hat * dt[..., None]
    pref = _rotation_prefixes(lie.exp_so3(x).movedim(-3, 0)).movedim(0, -3)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(
        pref[..., :1, :, :].shape)
    R = torch.cat([eye, pref[..., :-1, :, :]], dim=-3)
    a_in0 = _mv(R.mT, imu_a[..., :-1, :] - ba)
    return dt, x, R, a_in0, pref[..., -1, :, :]


def _integrate(a_in0, dt):
    """(α, β) from the rotated accel [..., K-1, 3]: β = Σ a_k dt_k,
    α = Σ (β_k dt_k + ½ a_k dt_k²) with β_k the sum before sample k."""
    d = dt[..., None]
    inc = a_in0 * d
    before, after = _exclusive_cumsum(inc, -2)
    return (torch.sum(before * d + 0.5 * a_in0 * d * d, dim=-2),
            after[..., -1, :])


def _preintegrate(imu_t, imu_w, imu_a, bg, ba):
    """(ΔR [..., 3, 3], α [..., 3], β [..., 3]) of each segment in its
    start frame: ΔR accumulated from the gyro, β = ∫ R_{0→τ}ᵀ a,
    α = ∬ R_{0→τ}ᵀ a (the reference's `lax.scan` recursion, unrolled into
    prefix products and sums).  imu_t [..., K] (leading dims: segments),
    bg, ba [3]."""
    dt, _, _, a_in0, R_end = _preintegrate_terms(imu_t, imu_w, imu_a, bg, ba)
    alpha, beta = _integrate(a_in0, dt)
    return R_end, alpha, beta


def _preintegrate_jac(imu_t, imu_w, imu_a, bg, ba):
    """`_preintegrate`'s values and their derivatives along the six bias
    directions (bg then ba): ((ΔR, α, β), (∂ΔR [6, ..., 3, 3], ∂α, ∂β)) —
    the six columns `jax.jacfwd` forms through the reference's recursion,
    in closed form.  With d exp(x)[δx] = exp(x) ⌊Jr(x) δx⌋ the rotation's
    tangent stays R_k ⌊c_k⌋ with c_{k+1} = c_k + R_kᵀ Jr(x_k) δx_k (δx_k =
    e_j dt_k for bg_j), so ∂a_k = −c_k × a_k − R_kᵀ e_j (the latter for
    ba_j); both are sums over samples.  A functorch `jacfwd` through the
    K-step recursion costs tens of times more host time."""
    dt, x, R, a_in0, R_end = _preintegrate_terms(imu_t, imu_w, imu_a, bg, ba)
    alpha, beta = _integrate(a_in0, dt)
    # column j of M_k = R_kᵀ Jr(x_k) dt_k is c's increment along bg_j
    M = R.mT @ (lie.Jr_so3(x) * dt[..., None, None])
    c_before, c_after = _exclusive_cumsum(M, -3)
    c_dirs = c_before.movedim(-1, 0)  # [3, ..., K-1, 3]
    t_a = torch.cat([-torch.linalg.cross(c_dirs, a_in0.expand_as(c_dirs)),
                     -R.movedim(-2, 0)])  # [6, ..., K-1, 3]
    t_alpha, t_beta = _integrate(t_a, dt)
    tR_g = R_end @ lie.skew(c_after[..., -1, :, :].movedim(-1, 0))
    tR = torch.cat([tR_g, torch.zeros_like(tR_g)])
    return (R_end, alpha, beta), (tR, t_alpha, t_beta)


def _preintegrate_cov(imu_t, imu_w, imu_a, bg, ba, sigma_w, sigma_a,
                      sigma_wb=0.0, sigma_ab=0.0, full15=False):
    """Covariance of the preintegrated measurement error (CpiBase P_meas,
    CpiBase.h:49-150): the 15-state [δθ δβ δα δbg δba] linearized
    recursion with the bias random-walk rows, so in-segment bias drift
    inflates the measurement.  Returns the [δθ δβ δα] 9×9 marginal (what
    whitens the MLE residuals) or, with `full15`, the 15×15.  Leading dims
    of imu_t [..., K] are segments."""
    K = imu_t.shape[-1]
    lead = imu_t.shape[:-1]
    dtype, dev = imu_a.dtype, imu_a.device
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3))
    Z = torch.zeros_like(I3)
    R = I3
    P = torch.zeros(lead + (15, 15), dtype=dtype, device=dev)

    def block(rows):
        return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)

    for k in range(K - 1):
        dt = torch.clamp(imu_t[..., k + 1] - imu_t[..., k], min=0.0)
        d = dt[..., None, None]
        w_hat = 0.5 * (imu_w[..., k, :] + imu_w[..., k + 1, :]) - bg
        a_hat = imu_a[..., k, :] - ba
        A = lie.exp_so3(-w_hat * dt[..., None])
        Rt = R.mT
        Ra = Rt @ lie.skew(a_hat)
        Gg = (A @ lie.Jr_so3(-w_hat * dt[..., None])) * d
        F = block([[A, Z, Z, Gg, Z],
                   [-d * Ra, I3, Z, Z, d * Rt],
                   [-0.5 * d * d * Ra, d * I3, I3, Z, 0.5 * d * d * Rt],
                   [Z, Z, Z, I3, Z],
                   [Z, Z, Z, Z, I3]])
        G = block([[Gg, Z, Z, Z],
                   [Z, d * Rt, Z, Z],
                   [Z, 0.5 * d * d * Rt, Z, Z],
                   [Z, Z, I3, Z],
                   [Z, Z, Z, I3]])
        inv_dt = torch.where(dt > 0, 1.0 / torch.clamp(dt, min=1e-12), 0.0)
        one = torch.ones(lead + (3,), dtype=dtype, device=dev)
        qc = torch.cat([one * (sigma_w ** 2 * inv_dt)[..., None],
                        one * (sigma_a ** 2 * inv_dt)[..., None],
                        one * (sigma_wb ** 2 * dt)[..., None],
                        one * (sigma_ab ** 2 * dt)[..., None]], dim=-1)
        P = F @ P @ F.mT + (G * qc[..., None, :]) @ G.mT
        P = 0.5 * (P + P.mT)
        R = A @ R
    return P if full15 else P[..., :9, :9]


def _preintegrate_all(inp: DynInitInput, bg, ba):
    """The segment preintegrations and their accumulation in the start
    frame: (R_0k [P, 3, 3] rotation I0→Ik, α_0k [P, 3], β_0k [P, 3], ΔR,
    Δα, Δβ), with p_k^{I0} = v0 Δt_k − ½ g Δt_k² + α_0k."""
    P = inp.t_pose.shape[0]
    dR, dalpha, dbeta = _preintegrate(inp.imu_t, inp.imu_w, inp.imu_a, bg,
                                      ba)
    dtype, dev = dalpha.dtype, dalpha.device
    R_0k = torch.eye(3, dtype=dtype, device=dev)
    a_0k = torch.zeros(3, dtype=dtype, device=dev)
    b_0k = a_0k
    Rs, As, Bs = [R_0k], [a_0k], [b_0k]
    for i in range(P - 1):
        dt = inp.t_pose[i + 1] - inp.t_pose[i]
        a_0k = a_0k + b_0k * dt + R_0k.T @ dalpha[i]
        b_0k = b_0k + R_0k.T @ dbeta[i]
        R_0k = dR[i] @ R_0k
        Rs.append(R_0k), As.append(a_0k), Bs.append(b_0k)
    return (torch.stack(Rs), torch.stack(As), torch.stack(Bs), dR, dalpha,
            dbeta)


def _linear_solve(inp: DynInitInput, opts: DynamicInitOptions, R_0k,
                  alpha_0k):
    """The closed-form [p_f (3F), v0 (3), g^{I0} (3)]
    (DynamicInitializer.cpp:310-420): the bearing constraints
    ⌊b⌋ R_ItoC R_0k (p_f − v0 Δt + ½ g Δt² − α) = ⌊b⌋ p_IinC stacked over
    every observation, solved by the normal equations, then |g| fixed by
    `lin_iters` alternating projections.  Returns (p_f [F, 3], v0, g0)."""
    F, P = inp.obs_mask.shape
    dtype, dev = inp.uvn.dtype, inp.uvn.device
    dt_k = inp.t_pose - inp.t_pose[0]
    n = 3 * F + 6

    b = torch.cat([inp.uvn, torch.ones(F, P, 1, dtype=dtype, device=dev)],
                  dim=-1)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    Bx = lie.skew(b)  # [F, P, 3, 3]
    M = Bx @ inp.R_ItoC @ R_0k  # [F, P, 3, 3]
    w = inp.obs_mask.to(dtype)[..., None, None]
    A_f = M * w
    A_v = -dt_k[None, :, None, None] * M * w
    A_g = 0.5 * (dt_k ** 2)[None, :, None, None] * M * w
    rhs = (_mv(M, alpha_0k[None]) - _mv(Bx, inp.p_IinC)) * w[..., 0]

    # A_f at its feature's block of columns, then v0 and g
    eye_F = torch.eye(F, dtype=dtype, device=dev)
    A_feat = (eye_F[:, None, None, :, None]
              * A_f[:, :, :, None, :]).reshape(F, P, 3, 3 * F)
    A = torch.cat([A_feat, A_v, A_g], dim=-1).reshape(3 * F * P, n)
    b_vec = rhs.reshape(3 * F * P)

    x = _solve(A.T @ A + 1e-9 * torch.eye(n, dtype=dtype, device=dev),
               A.T @ b_vec)
    A_rest, A_gc = A[:, :3 * F + 3], A[:, 3 * F + 3:]
    eye_r = torch.eye(3 * F + 3, dtype=dtype, device=dev)
    for _ in range(opts.lin_iters):
        g = x[3 * F + 3:]
        g_fixed = (g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)
                   * opts.gravity_mag)
        # re-solve the rest with g fixed: A_rest x_rest = b − A_g g
        b_rest = b_vec - A_gc @ g_fixed
        x_rest = _solve(A_rest.T @ A_rest + 1e-9 * eye_r, A_rest.T @ b_rest)
        x = torch.cat([x_rest, g_fixed])
    return x[:3 * F].reshape(F, 3), x[3 * F:3 * F + 3], x[3 * F + 3:]


def _unpack(theta, P):
    """θ = [δθ (3P), δp (3P), v (3P), bg, ba, g_I0, p_f (3F)]."""
    i = 9 * P
    return (theta[:3 * P].reshape(P, 3), theta[3 * P:6 * P].reshape(P, 3),
            theta[6 * P:i].reshape(P, 3), theta[i:i + 3],
            theta[i + 3:i + 6], theta[i + 6:i + 9],
            theta[i + 9:].reshape(-1, 3))


def _residuals(theta, inp: DynInitInput, opts: DynamicInitOptions, R0_lin,
               p0_lin, P, F, L9=None, pre=None):
    """All residuals, whitened (the Factor_ImuCPIv1 and
    Factor_ImageReprojCalib roles), with rotations as local perturbations
    of the linearization R0_lin (I0 → Ik):

      r_ΔR = log(ΔR(bg)ᵀ R_{k+1} R_kᵀ)
      r_Δβ = R_k (v_{k+1} − v_k + g Δt) − Δβ(bg, ba)
      r_Δα = R_k (p_{k+1} − p_k − v_k Δt + ½ g Δt²) − Δα(bg, ba)
      r_uv = proj(R_ItoC R_k (p_f − p_k) + p_IinC) − uvn

    whitened by the CPI covariance's Cholesky factors L9 (or by per-block
    scalar stds without them), then the gauge (pose 0 pinned), the
    |g| = 9.81 prior and the bias priors.  `pre` = (ΔR, Δα, Δβ) given
    replaces the preintegration at θ's biases (see `_jacobian`)."""
    dtype = theta.dtype
    dth, dp, v, bg, ba, g_I0, p_f = _unpack(theta, P)
    R_k = lie.exp_so3(-dth) @ R0_lin
    p_k = p0_lin + dp

    dR, dalpha, dbeta = pre or _preintegrate(inp.imu_t, inp.imu_w,
                                             inp.imu_a, bg, ba)
    dt = (inp.t_pose[1:] - inp.t_pose[:-1])[:, None]
    R0, R1 = R_k[:-1], R_k[1:]
    rR = lie.log_so3(dR.mT @ (R1 @ R0.mT))
    rB = _mv(R0, v[1:] - v[:-1] + g_I0 * dt) - dbeta
    rA = _mv(R0, p_k[1:] - p_k[:-1] - v[:-1] * dt
             + 0.5 * g_I0 * dt * dt) - dalpha
    r9 = torch.cat([rR, rB, rA], dim=-1)  # [P-1, 9]
    if L9 is not None:
        # r_white = L⁻¹ r, so r_whiteᵀ r_white = rᵀ P⁻¹ r
        r_imu = torch.linalg.solve_triangular(L9, r9[..., None],
                                              upper=False)[..., 0]
    else:
        # δΔR ~ σ_w √dt, δΔβ ~ σ_a √dt, δΔα ~ σ_a dt^{3/2}/√3
        sdt = torch.sqrt(torch.clamp(dt, min=1e-6))
        one = torch.ones(3, dtype=dtype, device=theta.device)
        scale = torch.cat([one * opts.sigma_w * sdt, one * opts.sigma_a * sdt,
                           one * opts.sigma_a * sdt * dt / 3.0 ** 0.5],
                          dim=-1)
        r_imu = r9 / scale

    pC = _mv(inp.R_ItoC, _mv(R_k[None], p_f[:, None] - p_k[None])) \
        + inp.p_IinC  # [F, P, 3]
    z = torch.where(torch.abs(pC[..., 2]) > 1e-6, pC[..., 2], 1e-6)
    pred = pC[..., :2] / z[..., None]
    w = inp.obs_mask.to(dtype)[..., None]
    r_uv = (pred - inp.uvn) * w / opts.sigma_pix_norm

    r_gauge = torch.cat([dth[0], dp[0]]) * 1e4
    # [1], not a 0-dim value: under forward-mode AD a 0-dim tensor combined
    # with a Python scalar gets float64 tangents
    r_gnorm = (torch.linalg.vector_norm(g_I0, dim=-1, keepdim=True)
               - opts.gravity_mag) * 1e4
    r_bias = torch.cat([bg / opts.sigma_bg_prior, ba / opts.sigma_ba_prior])
    return torch.cat([r_imu.reshape(-1), r_uv.reshape(-1), r_gauge, r_gnorm,
                      r_bias])


def _jacobian(res_fn, theta, P):
    """(∂r/∂θ [rows, n], r) by forward-mode AD (`jax.jacfwd` in the
    reference) in one `torch.func.jacfwd` pass, in which the
    preintegration enters as its first-order expansion about θ's biases,
    pre + ∂pre·(b − b_θ): the same values at θ, and the same derivative,
    its six bias tangents in closed form (`_preintegrate_jac`)."""
    i = 9 * P  # bg, ba
    pre, t_pre = res_fn.pre_jac(theta[i:i + 3], theta[i + 3:i + 6])

    def expanded(th):
        d = th[i:i + 6] - theta[i:i + 6]  # zero, carrying the bias tangents
        return res_fn(th, pre=tuple(
            v + torch.tensordot(d, t, dims=([0], [0]))
            for v, t in zip(pre, t_pre)))

    return torch.func.jacfwd(expanded)(theta), res_fn(theta, pre=pre)


def _lm_step(res_fn, theta, lam, cost, P):
    """One Levenberg-Marquardt iteration (the Ceres DENSE_SCHUR + DOGLEG
    role): the damped Gauss-Newton step from the forward-mode Jacobian,
    accepted on the device when it lowers the cost."""
    J, r = _jacobian(res_fn, theta, P)
    JtJ = J.T @ J
    n = theta.shape[0]
    eye = torch.eye(n, dtype=theta.dtype, device=theta.device)
    A = JtJ + lam * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-8))
    theta_new = theta - _solve(A + 1e-10 * eye, J.T @ r)
    cost_new = torch.sum(res_fn(theta_new) ** 2)
    accept = cost_new < cost
    return (torch.where(accept, theta_new, theta),
            torch.clamp(torch.where(accept, lam * 0.3, lam * 8.0), 1e-9, 1e8),
            torch.where(accept, cost_new, cost))


def _levenberg_marquardt(res_fn, theta0, iters, P):
    """`iters` LM steps from θ₀ at λ = 1e-3 (`res_fn` as `initialize`
    makes it).  Returns (θ, cost₀, cost)."""
    cost0 = torch.sum(res_fn(theta0) ** 2)
    theta, cost = theta0, cost0
    lam = torch.tensor(1e-3, dtype=theta0.dtype, device=theta0.device)
    for _ in range(iters):
        theta, lam, cost = _lm_step(res_fn, theta, lam, cost, P)
    return theta, cost0, cost


def initialize(inp: DynInitInput, opts: DynamicInitOptions) -> DynInitResult:
    """The whole dynamic initialization (DynamicInitializer::initialize
    parity), on the device of `inp`."""
    P = inp.t_pose.shape[0]
    F = inp.obs_mask.shape[0]
    dtype, dev = inp.uvn.dtype, inp.uvn.device

    # 1-2. preintegration at zero biases
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    R_0k, alpha_0k, beta_0k, *_ = _preintegrate_all(inp, zero3, zero3)

    # 3. the closed-form [features, v0, g]
    p_f0, v0, g_I0 = _linear_solve(inp, opts, R_0k, alpha_0k)
    dt_k = (inp.t_pose - inp.t_pose[0])[:, None]
    p_k0 = v0 * dt_k - 0.5 * g_I0 * dt_k ** 2 + alpha_0k
    v_k0 = v0 - g_I0 * dt_k + beta_0k

    # 4. the MLE, whitened by the CPI-propagated [δθ δβ δα] covariance of
    # each segment at the zero-bias linearization (a jitter floor keeps the
    # f32 Cholesky well-posed); L9 is a constant of the residual
    P9 = _preintegrate_cov(inp.imu_t, inp.imu_w, inp.imu_a, zero3, zero3,
                           opts.sigma_w, opts.sigma_a, opts.sigma_wb,
                           opts.sigma_ab)
    P9 = P9 + 1e-12 * torch.eye(9, dtype=dtype, device=dev)
    L9, info = torch.linalg.cholesky_ex(P9)
    L9 = _nan_unless((info == 0)[:, None, None], L9).detach()
    theta0 = torch.cat([torch.zeros(6 * P, dtype=dtype, device=dev),
                        v_k0.reshape(-1), zero3, zero3, g_I0,
                        p_f0.reshape(-1)])

    def res_fn(th, pre=None):
        return _residuals(th, inp, opts, R_0k, p_k0, P, F, L9=L9, pre=pre)

    res_fn.pre_jac = lambda bg, ba: _preintegrate_jac(inp.imu_t, inp.imu_w,
                                                      inp.imu_a, bg, ba)
    theta, cost0, cost = _levenberg_marquardt(res_fn, theta0, opts.mle_iters,
                                              P)
    dth, dp, v, bg, ba, g_I0, _ = _unpack(theta, P)
    R_k = lie.exp_so3(-dth) @ R_0k
    p_k = p_k0 + dp

    # 5. the gravity-aligned world: R_GtoI0 maps world (z up) to I0
    R_GtoI0 = gram_schmidt_gravity(g_I0)
    R_GtoIk = R_k[-1] @ R_GtoI0

    # the covariance from the GN information at the optimum, newest-pose
    # block; a relative jitter, since degenerate windows leave the
    # information near-singular beside ~1e8-scale gauge rows
    # The information and its inverse are formed in f64: beside the gauge
    # rows the f32 inverse alone moves cov15 by about 0.6 % of its max,
    # more than the reference's own jit-vs-eager spread (0.16 %)
    J = _jacobian(res_fn, theta, P)[0].double()
    info_m = J.T @ J
    n = theta.shape[0]
    eye = torch.eye(n, dtype=info_m.dtype, device=dev)
    jit_rel = 1e-7 * torch.trace(info_m) / n
    cov_full, inv_info = torch.linalg.inv_ex(
        info_m + torch.clamp(jit_rel, min=1e-9) * eye)
    cov_full = _nan_unless(inv_info == 0, cov_full.to(dtype))
    kq, kp, kv = 3 * (P - 1), 3 * P + 3 * (P - 1), 6 * P + 3 * (P - 1)
    kbg, kba = 9 * P, 9 * P + 3  # g at 9P+6, features from 9P+9
    sel = torch.cat([torch.arange(k, k + 3, device=dev)
                     for k in (kq, kp, kv, kbg, kba)])
    cov15 = cov_full[sel][:, sel]
    # δp and δv of the MLE live in the I0 frame, the filter's in the world
    # frame: rotate those blocks by R_GtoI0ᵀ (δθ, δbg, δba are invariant)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    T = torch.block_diag(eye3, R_GtoI0.T, R_GtoI0.T, eye3, eye3)
    cov15 = T @ cov15 @ T.T
    infl = torch.tensor([opts.inflation_ori] * 3 + [1.0] * 3
                        + [opts.inflation_vel] * 3 + [opts.inflation_bg] * 3
                        + [opts.inflation_ba] * 3, dtype=dtype, device=dev)
    cov15 = cov15 * torch.sqrt(infl[:, None] * infl[None, :])
    cov15 = 0.5 * (cov15 + cov15.T)
    # PSD repair and the observability gate: clamp the f32 roundoff floor
    # of the eigenvalues, and refuse a meaningfully indefinite or an
    # unobservable (huge-eigenvalue) covariance.  A non-finite cov15 (a
    # failed inverse) is decomposed as the identity and refused, where the
    # reference's eigh returns NaN.
    finite = torch.isfinite(cov15).all()
    w_ev, V_ev = torch.linalg.eigh(torch.where(
        finite, cov15, torch.eye(15, dtype=dtype, device=dev)))
    w_max = torch.clamp(w_ev[-1], min=1e-12)
    cov_ok = finite & (w_ev[0] > -1e-3 * w_max) & (w_max < 1e4)
    cov15 = _nan_unless(finite, (V_ev * torch.clamp(w_ev, min=1e-10))
                        @ V_ev.T)

    # the excitation gate (DynamicInitOptions.min_excite_*)
    a_flat = inp.imu_a.reshape(-1, 3)
    w_flat = inp.imu_w.reshape(-1, 3)
    a_rng = a_flat.max(dim=0).values - a_flat.min(dim=0).values
    w_rng = w_flat.max(dim=0).values - w_flat.min(dim=0).values
    excited = ((torch.linalg.vector_norm(a_rng) > opts.min_excite_a)
               | (torch.linalg.vector_norm(w_rng) > opts.min_excite_w))
    success = (torch.isfinite(cost) & (cost < cost0 + 1.0)
               & torch.isfinite(theta).all()
               & (inp.obs_mask.sum() >= 4 * P)
               & (torch.linalg.vector_norm(bg) < 0.5)
               & (torch.linalg.vector_norm(ba) < 1.0)
               & cov_ok & excited)
    return DynInitResult(
        success=success, q_GtoI=lie.rot_2_quat(R_GtoIk),
        p=R_GtoI0.T @ p_k[-1], v=R_GtoI0.T @ v[-1], bg=bg, ba=ba,
        cov15=cov15, R_I0toIk=R_k, p_k_in0=p_k)
