"""IMU state-mean + covariance propagation (rk4, discrete and the analytical
ACI² integrators).

Counterpart of `open_vins_tpu/models/propagator.py` (Propagator parity,
Propagator.cpp:71-130, 395-963).  rk4 without online IMU-intrinsic
calibration runs the whole window in one call of `ops/kernels.imu_rk4_window`
(one launch on CUDA; on the CPU its plain version, this module's loop).
Otherwise, for rk4 and discrete, the mean recursion over the IMU window is a
Python loop (about 10 steps per camera frame); for ACI² the mean is closed
form given the interval rotations (rotation prefix products, then two
cumulative sums).  The per-interval Φ/B/Qd are built in
one batch over the intervals and composed by the same pairwise tree as the
reference, so the rounding follows it; the covariance is touched once.

`fast_state_propagate` is the mean-only propagation for IMU-rate output,
and `make_window` packs host samples into an ImuWindow.

State error convention (JPL left error, [δθ δp δv δbg δba]):
    q = [δθ/2, 1] ⊗ q̂ ,  R_GtoI = (I - ⌊δθ⌋) R̂_GtoI
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from open_vins_tpu_torch.core.ekf import propagate_covariance
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import TensorRecord, VioState
from open_vins_tpu_torch.ops import kernels, lie


@dataclasses.dataclass
class ImuWindow(TensorRecord):
    """Fixed-size per-frame IMU packet (padded by repeating the last row)."""

    t: torch.Tensor  # [K] relative times, non-decreasing
    w: torch.Tensor  # [K, 3] gyro
    a: torch.Tensor  # [K, 3] accel


def _tri3(d6, upper: bool):
    """6-vector -> triangular 3x3 (State::Dm: kalibr lower, rpng upper)."""
    z = torch.zeros((), dtype=d6.dtype, device=d6.device)
    if upper:
        rows = [[d6[0], d6[1], d6[3]], [z, d6[2], d6[4]], [z, z, d6[5]]]
    else:
        rows = [[d6[0], z, z], [d6[1], d6[3], z], [d6[2], d6[4], d6[5]]]
    return torch.stack([torch.stack(r) for r in rows])


def imu_intrinsic_mats(state: VioState, model="kalibr", R_w=None, R_a=None):
    """(Dw, Da, Tg, R_w, R_a): the IMU-intrinsic correction matrices
    (State::Dm / State::Tg parity, State.h:91-116)."""
    upper = model == "rpng"
    Dw = _tri3(state.imu_dw, upper)
    Da = _tri3(state.imu_da, upper)
    Tg = state.imu_tg.reshape(3, 3).T  # column-major storage
    if R_w is None:
        R_w = lie.quat_2_rot(state.imu_q_gyro)  # GYROtoIMU
    if R_a is None:
        R_a = lie.quat_2_rot(state.imu_q_acc)  # ACCtoIMU
    return Dw, Da, Tg, R_w, R_a


def _matvec(M, x):
    """M [3,3] or [...,3,3] applied to x [..., 3]."""
    return (M @ x[..., None])[..., 0]


def correct_imu(state: VioState, w_m, a_m, mats=None, model="kalibr"):
    """Apply biases + IMU intrinsics to raw samples [..., 3]
    (Propagator.cpp:184-190):  â = R_a Da (a_m − ba),
    ŵ = R_w Dw (w_m − bg − Tg â).  Returns (ŵ, â, u_w, u_a)."""
    if mats is None:
        mats = imu_intrinsic_mats(state, model)
    return _correct(state.bg, state.ba, w_m, a_m, mats)


def _correct(bg, ba, w_m, a_m, mats):
    """`correct_imu` given the biases and the five matrices."""
    Dw, Da, Tg, R_w, R_a = mats
    u_a = a_m - ba
    a_hat = _matvec(R_a, _matvec(Da, u_a))
    u_w = w_m - bg - _matvec(Tg, a_hat)
    w_hat = _matvec(R_w, _matvec(Dw, u_w))
    return w_hat, a_hat, u_w, u_a


def _H_scale6(u, model="kalibr"):
    """∂(tri(d) u)/∂d : [..., 3, 6] (compute_H_Dw/H_Da parity)."""
    z = torch.zeros_like(u[..., 0])
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    if model == "rpng":
        rows = [[u0, u1, z, u2, z, z], [z, z, u1, z, u2, z],
                [z, z, z, z, z, u2]]
    else:
        rows = [[u0, z, z, z, z, z], [z, u0, z, u1, z, z],
                [z, z, u0, z, u1, u2]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _H_tg(a):
    """∂(Tg a)/∂tg (column-major tg): [..., 3, 9] (compute_H_Tg parity)."""
    z = torch.zeros_like(a[..., 0])
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    rows = [[a0, z, z, a1, z, z, a2, z, z],
            [z, a0, z, z, a1, z, z, a2, z],
            [z, z, a0, z, z, a1, z, z, a2]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _step_mean_midpoint(q, p, v, bg, ba, w1, a1, w2, a2, dt, gravity):
    """Midpoint/trapezoid mean integration (the 'discrete' option)."""
    w_hat = 0.5 * (w1 + w2) - bg
    a1h = a1 - ba
    a2h = a2 - ba
    dq = lie.axis_angle_2_quat(-w_hat * dt)
    q_new = lie.quat_multiply(dq, q)
    acc1 = lie.quat_2_rot(q).T @ a1h - gravity
    acc2 = lie.quat_2_rot(q_new).T @ a2h - gravity
    v_new = v + 0.5 * (acc1 + acc2) * dt
    p_new = p + v * dt + 0.5 * acc1 * dt * dt
    return q_new, p_new, v_new, w_hat, 0.5 * (a1h + a2h)


def _step_mean_rk4(q, p, v, bg, ba, w1, a1, w2, a2, dt, gravity):
    """Classic RK4 with linearly-interpolated IMU inputs
    (Propagator::predict_mean_rk4, Propagator.cpp:507-587); the quaternion
    is integrated in R⁴ via q̇ = ½ Ω(ω) q and renormalized."""
    w1h, w2h = w1 - bg, w2 - bg
    a1h, a2h = a1 - ba, a2 - ba
    wm = 0.5 * (w1h + w2h)
    am = 0.5 * (a1h + a2h)

    def deriv(qk, vk, w, a):
        qd = 0.5 * (lie.Omega(w) @ qk)
        Rt = lie.quat_2_rot(qk / torch.linalg.vector_norm(qk)).T
        return qd, vk, Rt @ a - gravity

    k1q, k1p, k1v = deriv(q, v, w1h, a1h)
    k2q, k2p, k2v = deriv(q + 0.5 * dt * k1q, v + 0.5 * dt * k1v, wm, am)
    k3q, k3p, k3v = deriv(q + 0.5 * dt * k2q, v + 0.5 * dt * k2v, wm, am)
    k4q, k4p, k4v = deriv(q + dt * k3q, v + dt * k3v, w2h, a2h)

    q_new = lie.quat_norm(q + dt / 6.0 * (k1q + 2 * k2q + 2 * k3q + k4q))
    p_new = p + dt / 6.0 * (k1p + 2 * k2p + 2 * k3p + k4p)
    v_new = v + dt / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
    return q_new, p_new, v_new, wm, am


def _qc(cfg: FilterConfig, dt):
    """Continuous noise densities scaled for discrete time: [n, 12]."""
    dev, dtype = dt.device, dt.dtype
    dens = torch.tensor([cfg.sigma_w**2] * 3 + [cfg.sigma_a**2] * 3
                        + [cfg.sigma_wb**2] * 3 + [cfg.sigma_ab**2] * 3,
                        dtype=dtype, device=dev)
    inv_dt = torch.where(dt > 0, 1.0 / torch.clamp(dt, min=1e-12), 0.0)
    return dens[None, :] * inv_dt[:, None]


def _phi_qd(lin, new, gravity, dt, cfg: FilterConfig, aux):
    """Error-state Φ [n,15,15], B [n,15,24] and Qd [n,15,15] for n intervals
    (compute_F_and_G_discrete parity, Propagator.cpp:830-963), with the
    FEJ-consistent integrated-displacement rotation Jacobians
        F_pθ = -⌊ p_new - p_k - v_k dt + ½ g dt² ⌋ R_kᵀ
        F_vθ = -⌊ v_new - v_k + g dt ⌋ R_kᵀ
    at the linearization values (q_lin, p_lin, v_lin).  `dt` [n]."""
    q_lin, p_lin, v_lin = lin
    q_new, p_new, v_new = new
    Dw, Da, Tg, R_w, R_a, w_hat, a_hat, u_w, u_a = aux
    n = dt.shape[0]
    dtype, dev = dt.dtype, dt.device
    RwDw = R_w @ Dw
    RaDa = R_a @ Da
    dt3 = dt[:, None, None]

    R_k = lie.quat_2_rot(q_lin)
    R_kT = R_k.mT
    dR = lie.quat_2_rot(q_new) @ R_kT
    Jr_dR = lie.Jr_so3(lie.log_so3(dR))
    dRJr = dR @ Jr_dR * dt3

    I3 = torch.eye(3, dtype=dtype, device=dev)
    dtv = dt[:, None]
    Fth_bg = -dRJr @ RwDw
    Fth_ba = dRJr @ (RwDw @ Tg @ RaDa)
    Fp_th = -lie.skew(p_new - p_lin - v_lin * dtv
                      + 0.5 * gravity * dtv * dtv) @ R_kT
    Fv_th = -lie.skew(v_new - v_lin + gravity * dtv) @ R_kT
    RtDa = R_kT @ RaDa

    Phi = dt.new_zeros((n, 15, 15))
    Phi[:, 0:3, 0:3] = dR
    Phi[:, 0:3, 9:12] = Fth_bg
    Phi[:, 0:3, 12:15] = Fth_ba
    Phi[:, 3:6, 0:3] = Fp_th
    Phi[:, 3:6, 3:6] = I3
    Phi[:, 3:6, 6:9] = I3 * dt3
    Phi[:, 3:6, 12:15] = -0.5 * dt3 * dt3 * RtDa
    Phi[:, 6:9, 0:3] = Fv_th
    Phi[:, 6:9, 6:9] = I3
    Phi[:, 6:9, 12:15] = -dt3 * RtDa
    Phi[:, 9:12, 9:12] = I3
    Phi[:, 12:15, 12:15] = I3

    # intrinsic columns B over [dw(6) da(6) tg(9) thw(3)]
    B = dt.new_zeros((n, 15, 24))
    model = cfg.imu_model
    if cfg.calib_imu_intrinsics:
        H_Da = _H_scale6(u_a, model)
        B[:, 0:3, 0:6] = dRJr @ R_w @ _H_scale6(u_w, model)
        B[:, 0:3, 6:12] = -dRJr @ (RwDw @ Tg @ R_a) @ H_Da
        B[:, 3:6, 6:12] = 0.5 * dt3 * dt3 * R_kT @ R_a @ H_Da
        B[:, 6:9, 6:12] = dt3 * R_kT @ R_a @ H_Da
        if model == "rpng":
            sA = lie.skew(a_hat)
            B[:, 0:3, 21:24] = -dRJr @ (RwDw @ Tg) @ sA
            B[:, 3:6, 21:24] = 0.5 * dt3 * dt3 * R_kT @ sA
            B[:, 6:9, 21:24] = dt3 * R_kT @ sA
        else:
            B[:, 0:3, 21:24] = dRJr @ lie.skew(w_hat)
    if cfg.calib_imu_g_sensitivity:
        B[:, 0:3, 12:21] = -dRJr @ RwDw @ _H_tg(a_hat)

    # G [15,12] over noise [n_g n_a n_wg n_wa]
    G = dt.new_zeros((n, 15, 12))
    G[:, 0:3, 0:3] = Fth_bg
    G[:, 0:3, 3:6] = Fth_ba
    G[:, 3:6, 3:6] = -0.5 * dt3 * dt3 * RtDa
    G[:, 6:9, 3:6] = -dt3 * RtDa
    G[:, 9:12, 6:9] = I3 * dt3
    G[:, 12:15, 9:12] = I3 * dt3
    Qd = (G * _qc(cfg, dt)[:, None, :]) @ G.mT
    return Phi, B, Qd


def _xi_sum(w_hat, a_hat, dt):
    """(R_ktok1, Ξ₁, Ξ₂, Jr_ktok1, Ξ₃, Ξ₄) for n intervals — the ACI²
    integration components (compute_Xi_sum parity, Propagator.cpp:588-668):
    Ξ₁ = ∫ exp(ωτ)ᵀ dτ, Ξ₂ = ∬ exp(ωτ)ᵀ, Ξ₃/Ξ₄ their ∂/∂ω contractions.
    The constant-ω closed forms and the small-ω limits are both evaluated
    and selected per interval (denominators clamped so the unselected
    branch stays finite).  w_hat, a_hat [n, 3], dt [n]."""
    I3 = torch.eye(3, dtype=w_hat.dtype, device=w_hat.device)
    w_norm = torch.linalg.vector_norm(w_hat, dim=-1)
    small = (w_norm < (math.pi / 360.0))[:, None, None]
    wn = torch.clamp(w_norm, min=1e-12)
    k_hat = w_hat / wn[:, None]
    d_th = w_norm * dt
    d_t2, d_t3 = dt * dt, dt * dt * dt
    wn2, wn3 = wn * wn, wn * wn * wn
    cos_dth, sin_dth = torch.cos(d_th), torch.sin(d_th)
    d_th2, d_th3 = d_th * d_th, d_th * d_th * d_th
    sK = lie.skew(k_hat)
    sK2 = sK @ sK
    sA = lie.skew(a_hat)
    ka = torch.sum(k_hat * a_hat, dim=-1)[:, None, None]

    def c(x):  # per-interval scalar as a [n, 1, 1] factor
        return x[:, None, None]

    R_ktok1 = lie.exp_so3(-w_hat * dt[:, None])
    Jr_ktok1 = lie.Jr_so3(-w_hat * dt[:, None])

    # constant-omega closed forms (Propagator.cpp:620-640)
    Xi1_big = (I3 * c(dt) + c((1.0 - cos_dth) / wn) * sK
               + c(dt - sin_dth / wn) * sK2)
    Xi2_big = (c(0.5 * d_t2) * I3 + c((d_th - sin_dth) / wn2) * sK
               + c(0.5 * d_t2 - (1.0 - cos_dth) / wn2) * sK2)
    Xi3_big = (c(0.5 * d_t2) * sA
               + c((sin_dth - d_th) / wn2) * (sA @ sK)
               + c((sin_dth - d_th * cos_dth) / wn2) * (sK @ sA)
               + c(0.5 * d_t2 - (1.0 - cos_dth) / wn2) * (sA @ sK2)
               + c(0.5 * d_t2 + (1.0 - cos_dth - d_th * sin_dth) / wn2)
               * (sK2 @ sA + ka * sK)
               - c((3.0 * sin_dth - 2.0 * d_th - d_th * cos_dth) / wn2)
               * ka * sK2)
    Xi4_big = (c(d_t3 / 6.0) * sA
               + c((2.0 * (1.0 - cos_dth) - d_th2) / (2.0 * wn3)) * (sA @ sK)
               + c((2.0 * (1.0 - cos_dth) - d_th * sin_dth) / wn3)
               * (sK @ sA)
               + c((sin_dth - d_th) / wn3 + d_t3 / 6.0) * (sA @ sK2)
               + c((d_th - 2.0 * sin_dth + d_th3 / 6.0 + d_th * cos_dth)
                   / wn3) * (sK2 @ sA + ka * sK)
               + c((4.0 * cos_dth - 4.0 + d_th2 + d_th * sin_dth) / wn3)
               * ka * sK2)

    # small-omega limits (Propagator.cpp:642-656)
    Xi1_small = c(dt) * (I3 + c(sin_dth) * sK + c(1.0 - cos_dth) * sK2)
    Xi2_small = c(0.5 * dt) * Xi1_small
    Xi3_small = c(0.5 * d_t2) * (
        sA + c(sin_dth) * (-(sA @ sK) + sK @ sA + ka * sK2)
        + c(1.0 - cos_dth) * (sA @ sK2 + sK2 @ sA + ka * sK))
    Xi4_small = c(dt / 3.0) * Xi3_small

    return (R_ktok1, torch.where(small, Xi1_small, Xi1_big),
            torch.where(small, Xi2_small, Xi2_big), Jr_ktok1,
            torch.where(small, Xi3_small, Xi3_big),
            torch.where(small, Xi4_small, Xi4_big))


def _analytic_precompute(state: VioState, win: ImuWindow, mats):
    """The carry-independent part of ACI² for every interval at once:
    corrected samples averaged over each interval (predict_and_compute's
    w_hat_avg/a_hat_avg, Propagator.cpp:404-431) and the Ξ-series.
    Returns (dts, w_hat, a_hat, u_wm, u_am, xis)."""
    dts = torch.clamp(win.t[1:] - win.t[:-1], min=0.0)
    wc, ac, u_w, u_a = correct_imu(state, win.w, win.a, mats)
    w_hat = 0.5 * (wc[:-1] + wc[1:])
    a_hat = 0.5 * (ac[:-1] + ac[1:])
    u_wm = 0.5 * (u_w[:-1] + u_w[1:])
    u_am = 0.5 * (u_a[:-1] + u_a[1:])
    return dts, w_hat, a_hat, u_wm, u_am, _xi_sum(w_hat, a_hat, dts)


def _phi_qd_analytic(lin, new, gravity, dt, cfg: FilterConfig, aux, xi):
    """Analytic Φ [n,15,15], B [n,15,24] and Qd [n,15,15]
    (compute_F_and_G_analytic parity, Propagator.cpp:694-829, both IMU
    models).  The θ-columns are the discrete form's FEJ integrated-
    displacement Jacobians; the bias and noise columns use the Ξ integrals.
    `lin` and `new` carry rotations (R_GtoI), not quaternions."""
    R_k, p_lin, v_lin = lin
    R_new, p_new, v_new = new
    Dw, Da, Tg, R_w, R_a, w_hat, a_hat, u_w, u_a = aux
    _, Xi1, Xi2, Jr_ktok1, Xi3, Xi4 = xi
    n = dt.shape[0]
    dtype, dev = dt.dtype, dt.device
    RwDw = R_w @ Dw
    RwDwTg = RwDw @ Tg
    RaDa = R_a @ Da
    dt3 = dt[:, None, None]
    dtv = dt[:, None]

    R_kT = R_k.mT
    dR = R_new @ R_kT
    dRJr = dR @ Jr_ktok1 * dt3  # dR_ktok1 · Jr(−ω dt) · dt

    I3 = torch.eye(3, dtype=dtype, device=dev)
    Fp_th = -lie.skew(p_new - p_lin - v_lin * dtv
                      + 0.5 * gravity * dtv * dtv) @ R_kT
    Fv_th = -lie.skew(v_new - v_lin + gravity * dtv) @ R_kT
    Fth_bg = -dRJr @ RwDw
    Fp_bg = R_kT @ Xi4 @ RwDw
    Fv_bg = R_kT @ Xi3 @ RwDw
    Fth_ba = dRJr @ RwDwTg @ RaDa
    Fp_ba = -R_kT @ (Xi2 + Xi4 @ RwDwTg) @ RaDa
    Fv_ba = -R_kT @ (Xi1 + Xi3 @ RwDwTg) @ RaDa

    Phi = dt.new_zeros((n, 15, 15))
    Phi[:, 0:3, 0:3] = dR
    Phi[:, 0:3, 9:12] = Fth_bg
    Phi[:, 0:3, 12:15] = Fth_ba
    Phi[:, 3:6, 0:3] = Fp_th
    Phi[:, 3:6, 3:6] = I3
    Phi[:, 3:6, 6:9] = I3 * dt3
    Phi[:, 3:6, 9:12] = Fp_bg
    Phi[:, 3:6, 12:15] = Fp_ba
    Phi[:, 6:9, 0:3] = Fv_th
    Phi[:, 6:9, 6:9] = I3
    Phi[:, 6:9, 9:12] = Fv_bg
    Phi[:, 6:9, 12:15] = Fv_ba
    Phi[:, 9:12, 9:12] = I3
    Phi[:, 12:15, 12:15] = I3

    # intrinsic columns B over [dw(6) da(6) tg(9) thw(3)]; thw holds
    # ∂/∂R_GYROtoIMU (kalibr) or ∂/∂R_ACCtoIMU (rpng)
    B = dt.new_zeros((n, 15, 24))
    model = cfg.imu_model
    if cfg.calib_imu_intrinsics:
        H_Dw = R_w @ _H_scale6(u_w, model)
        H_Da = R_a @ _H_scale6(u_a, model)
        B[:, 0:3, 0:6] = dRJr @ H_Dw
        B[:, 3:6, 0:6] = -R_kT @ Xi4 @ H_Dw
        B[:, 6:9, 0:6] = -R_kT @ Xi3 @ H_Dw
        B[:, 0:3, 6:12] = -dRJr @ RwDwTg @ H_Da
        B[:, 3:6, 6:12] = R_kT @ (Xi2 + Xi4 @ RwDwTg) @ H_Da
        B[:, 6:9, 6:12] = R_kT @ (Xi1 + Xi3 @ RwDwTg) @ H_Da
        if model == "rpng":
            sA = lie.skew(a_hat)
            B[:, 0:3, 21:24] = -dRJr @ RwDwTg @ sA
            B[:, 3:6, 21:24] = R_kT @ (Xi2 + Xi4 @ RwDwTg) @ sA
            B[:, 6:9, 21:24] = R_kT @ (Xi1 + Xi3 @ RwDwTg) @ sA
        else:
            sW = lie.skew(w_hat)
            B[:, 0:3, 21:24] = dRJr @ sW
            B[:, 3:6, 21:24] = -R_kT @ Xi4 @ sW
            B[:, 6:9, 21:24] = -R_kT @ Xi3 @ sW
    if cfg.calib_imu_g_sensitivity:
        H_Tg = RwDw @ _H_tg(a_hat)
        B[:, 0:3, 12:21] = -dRJr @ H_Tg
        B[:, 3:6, 12:21] = R_kT @ Xi4 @ H_Tg
        B[:, 6:9, 12:21] = R_kT @ Xi3 @ H_Tg

    # G [15,12] over [n_g n_a n_wg n_wa] (Propagator.cpp:816-827)
    G = dt.new_zeros((n, 15, 12))
    G[:, 0:3, 0:3] = Fth_bg
    G[:, 3:6, 0:3] = Fp_bg
    G[:, 6:9, 0:3] = Fv_bg
    G[:, 0:3, 3:6] = Fth_ba
    G[:, 3:6, 3:6] = Fp_ba
    G[:, 6:9, 3:6] = Fv_ba
    G[:, 9:12, 6:9] = I3 * dt3
    G[:, 12:15, 9:12] = I3 * dt3
    Qd = (G * _qc(cfg, dt)[:, None, :]) @ G.mT
    return Phi, B, Qd


def _rotation_prefixes(R_steps):
    """Inclusive prefix products pref[k] = R_steps[k] @ … @ R_steps[0] in
    ⌈log₂ n⌉ levels of batched 3×3 products (Hillis–Steele)."""
    pref = R_steps
    d = 1
    while d < pref.shape[0]:
        pref = torch.cat([pref[:d], pref[d:] @ pref[:-d]])
        d *= 2
    return pref


def _analytic_window(state: VioState, cfg: FilterConfig, win: ImuWindow,
                     gravity, R3, mats):
    """ACI² over the window: the mean is closed form given the interval
    rotations (rotation prefixes, then v and p by two cumulative sums).
    Returns ((q, p, v), dts, (Phis, Bs, Qds))."""
    Dw, Da, Tg, R_w, R_a = mats
    dts, w_hats, a_hats, u_wm, u_am, xis = _analytic_precompute(state, win,
                                                                mats)
    R0 = R3[0]
    pref = _rotation_prefixes(xis[0])  # pref[k] = R_{0→k+1}
    R_end = pref @ R0  # R_GtoI at interval ends
    R_start = torch.cat([R0[None], R_end[:-1]])
    R_startT = R_start.mT
    a_col = a_hats[..., None]
    # v_{k+1} = v_k + R_startᵀ(Ξ₁ a) − g dt
    acc_v = ((R_startT @ (xis[1] @ a_col))[..., 0]
             - gravity[None] * dts[:, None])
    v_end = state.v[None] + torch.cumsum(acc_v, dim=0)
    v_start = torch.cat([state.v[None], v_end[:-1]])
    # p_{k+1} = p_k + v_k dt + R_startᵀ(Ξ₂ a) − ½ g dt²
    acc_p = (v_start * dts[:, None]
             + (R_startT @ (xis[2] @ a_col))[..., 0]
             - 0.5 * gravity[None] * (dts * dts)[:, None])
    p_end = state.p[None] + torch.cumsum(acc_p, dim=0)
    p_start = torch.cat([state.p[None], p_end[:-1]])
    q = lie.quat_multiply(lie.rot_2_quat(pref[-1]), state.q)

    # FEJ (Propagator.cpp:473-479): only the first interval linearizes at
    # the first estimate; afterwards the linearization follows the mean
    R_lin = torch.cat([R3[1][None], R_start[1:]])
    p_lin = torch.cat([state.p_fej[None], p_start[1:]])
    v_lin = torch.cat([state.v_fej[None], v_start[1:]])
    trans = _phi_qd_analytic(
        (R_lin, p_lin, v_lin), (R_end, p_end, v_end), gravity, dts, cfg,
        (Dw, Da, Tg, R_w, R_a, w_hats, a_hats, u_wm, u_am), xis)
    return (q, p_end[-1], v_end[-1]), dts, trans


def _compose_transitions(Phis, Bs, Qds):
    """Tree-reduce the interval transitions into the whole-window (Φ, B, Qd):
        Φ' = Φ_k Φ,  B' = Φ_k B + B_k,  Qd' = Φ_k Qd Φ_kᵀ + Qd_k
    pairwise, ⌈log₂ n⌉ levels (identity padding to a power of two is exact).
    Inputs ordered oldest interval first."""
    n = Phis.shape[0]
    N = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
    if N != n:
        pad = N - n
        eye = torch.eye(15, dtype=Phis.dtype, device=Phis.device)
        Phis = torch.cat([Phis, eye.expand(pad, 15, 15)])
        Bs = torch.cat([Bs, Bs.new_zeros((pad,) + Bs.shape[1:])])
        Qds = torch.cat([Qds, Qds.new_zeros((pad, 15, 15))])
    while N > 1:
        N //= 2
        Pe = Phis.reshape(N, 2, 15, 15)
        Be = Bs.reshape(N, 2, 15, Bs.shape[-1])
        Qe = Qds.reshape(N, 2, 15, 15)
        P0, P1 = Pe[:, 0], Pe[:, 1]  # 0 = earlier, 1 = later
        Phis = P1 @ P0
        Bs = P1 @ Be[:, 0] + Be[:, 1]
        Qds = P1 @ Qe[:, 0] @ P1.mT + Qe[:, 1]
    return Phis[0], Bs[0], Qds[0]


def _mask_padded(Phis, Bs, Qds, dts):
    """Padded (dt=0) intervals are exact no-ops even when the linearization
    point differs from the estimate."""
    ok = (dts > 0)[:, None, None]
    eye = torch.eye(15, dtype=Phis.dtype, device=Phis.device)
    return (torch.where(ok, Phis, eye), torch.where(ok, Bs, 0.0),
            torch.where(ok, Qds, 0.0))


def _loop_window(step, mean, fej, biases, mats, win: ImuWindow, gravity,
                 cfg: FilterConfig):
    """rk4 or discrete over the window: the mean recursion as a Python loop
    over the intervals, then every interval's Φ/B/Qd in one batch, the first
    linearized at the FEJ values (q, p, v) `fej`, the others at the mean.
    Returns ((q, p, v), dts, (Phis, Bs, Qds))."""
    (q, p, v), (bg, ba) = mean, biases
    dtype, dev = gravity.dtype, gravity.device
    K = win.t.shape[0]
    dts = torch.clamp(win.t[1:] - win.t[:-1], min=0.0)
    wc, ac, u_w, u_a = _correct(bg, ba, win.w, win.a, mats)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    outs = []
    for k in range(K - 1):
        q, p, v, w_hat, a_hat = step(q, p, v, zero3, zero3, wc[k], ac[k],
                                     wc[k + 1], ac[k + 1], dts[k], gravity)
        outs.append((q, p, v, w_hat, a_hat))
    q_end, p_end, v_end, w_hats, a_hats = (torch.stack(x) for x in zip(*outs))
    q_lin = torch.cat([fej[0][None], q_end[:-1]])
    p_lin = torch.cat([fej[1][None], p_end[:-1]])
    v_lin = torch.cat([fej[2][None], v_end[:-1]])
    trans = _phi_qd(
        (q_lin, p_lin, v_lin), (q_end, p_end, v_end), gravity, dts, cfg,
        (*mats, w_hats, a_hats, u_w[:-1], u_a[:-1]))
    return (q, p, v), dts, trans


def _window_transition(Phis, Bs, Qds, dts):
    """The whole window's (Φ, B, Qd) from the intervals': padded intervals
    masked, the tree composition, Qd symmetrized."""
    Phis, Bs, Qds = _mask_padded(Phis, Bs, Qds, dts)
    Phi, B, Qd = _compose_transitions(Phis, Bs, Qds)
    return Phi, B, 0.5 * (Qd + Qd.T)


def fused_rk4(cfg: FilterConfig) -> bool:
    """Whether `propagate` runs the window through `kernels.imu_rk4_window`:
    rk4 with no B columns (no online IMU-intrinsic calibration)."""
    return (cfg.integration == "rk4" and not cfg.calib_imu_intrinsics
            and not cfg.calib_imu_g_sensitivity)


def propagate(state: VioState, cfg: FilterConfig, win: ImuWindow,
              t_new) -> VioState:
    """Propagate mean + covariance to t_new over the IMU window
    (Propagator::propagate_and_clone's propagation half); FEJ values of the
    IMU state are reset to the propagated estimate.  rk4 without online
    IMU-intrinsic calibration (`fused_rk4`) is one call of
    `kernels.imu_rk4_window` (one kernel launch on CUDA, under vmap too);
    discrete, ACI² and rk4 with those B columns run here."""
    if cfg.integration not in ("rk4", "discrete", "analytical"):
        raise ValueError(f"unknown integration {cfg.integration!r}")
    dtype, dev = state.cov.dtype, state.cov.device
    if fused_rk4(cfg):
        R2 = lie.quat_2_rot(torch.stack([state.imu_q_gyro, state.imu_q_acc]))
        mats = imu_intrinsic_mats(state, cfg.imu_model, R_w=R2[0], R_a=R2[1])
        x = torch.cat([state.q, state.p, state.v, state.q_fej, state.p_fej,
                       state.v_fej, state.bg, state.ba])
        mean, Phi, Qd = kernels.imu_rk4_window(
            x, torch.stack(mats), win.t, win.w, win.a, cfg.gravity_mag,
            cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab)
        q, p, v = torch.split(mean, (4, 3, 3))
        B = None
    else:
        gravity = torch.tensor([0.0, 0.0, cfg.gravity_mag], dtype=dtype,
                               device=dev)
        R3 = lie.quat_2_rot(torch.stack([state.q, state.q_fej,
                                         state.imu_q_gyro, state.imu_q_acc]))
        mats = imu_intrinsic_mats(state, cfg.imu_model, R_w=R3[2], R_a=R3[3])
        if cfg.integration == "analytical":
            (q, p, v), dts, trans = _analytic_window(state, cfg, win, gravity,
                                                     R3, mats)
        else:
            step = (_step_mean_rk4 if cfg.integration == "rk4"
                    else _step_mean_midpoint)
            (q, p, v), dts, trans = _loop_window(
                step, (state.q, state.p, state.v),
                (state.q_fej, state.p_fej, state.v_fej),
                (state.bg, state.ba), mats, win, gravity, cfg)
        Phi, B, Qd = _window_transition(*trans, dts)

    use_B = cfg.calib_imu_intrinsics or cfg.calib_imu_g_sensitivity
    cov = propagate_covariance(state.cov, Phi, Qd, cfg,
                               B=B if use_B else None)
    return state.replace(
        q=q, p=p, v=v, cov=cov, q_fej=q, p_fej=p, v_fej=v,
        t=torch.as_tensor(t_new, dtype=dtype, device=dev),
    )


def fast_state_propagate(state: VioState, cfg: FilterConfig, win: ImuWindow):
    """Mean-only propagation for IMU-rate odometry output
    (Propagator::fast_state_propagate, Propagator.cpp:140-267;
    propagator.py:673-708 of the reference): the pose between camera
    updates, sample by sample, without touching the covariance.  Returns
    (q, p, v) at win.t[-1]."""
    dtype, dev = state.cov.dtype, state.cov.device
    gravity = torch.tensor([0.0, 0.0, cfg.gravity_mag], dtype=dtype,
                           device=dev)
    dts = torch.clamp(win.t[1:] - win.t[:-1], min=0.0)
    wc, ac, _, _ = correct_imu(state, win.w, win.a, model=cfg.imu_model)
    q, p, v = state.q, state.p, state.v
    if cfg.integration == "analytical":
        R_k, Xi1, Xi2, *_ = _xi_sum(0.5 * (wc[:-1] + wc[1:]),
                                    0.5 * (ac[:-1] + ac[1:]), dts)
        a_hat = 0.5 * (ac[:-1] + ac[1:])
        q_steps = lie.rot_2_quat(R_k)
        for k in range(dts.shape[0]):
            R_T = lie.quat_2_rot(q).T
            q_new = lie.quat_multiply(q_steps[k], q)
            dt = dts[k]
            v_new = v + R_T @ (Xi1[k] @ a_hat[k]) - gravity * dt
            p = (p + v * dt + R_T @ (Xi2[k] @ a_hat[k])
                 - 0.5 * gravity * dt * dt)
            q, v = q_new, v_new
        return q, p, v
    step = _step_mean_rk4 if cfg.integration == "rk4" else _step_mean_midpoint
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    for k in range(dts.shape[0]):
        q, p, v, _, _ = step(q, p, v, zero3, zero3, wc[k], ac[k], wc[k + 1],
                             ac[k + 1], dts[k], gravity)
    return q, p, v


def make_window(imu_t, imu_w, imu_a, t0, t1, K, device=None) -> ImuWindow:
    """Host-side: the samples strictly inside (t0, t1) with both ends
    interpolated in, padded to K rows by repeating the last
    (select_imu_readings + interpolate_data, Propagator.cpp:269-393;
    propagator.py:711-754 of the reference).  Returns an f32 ImuWindow on
    `device` (None = CUDA)."""
    from open_vins_tpu_torch import resolve_device

    imu_t = np.asarray(imu_t)
    imu_w, imu_a = np.asarray(imu_w), np.asarray(imu_a)
    idx = np.where((imu_t > t0) & (imu_t < t1))[0]

    def interp(ta):
        i1 = np.clip(np.searchsorted(imu_t, ta, side="right") - 1, 0,
                     len(imu_t) - 2)
        i2 = i1 + 1
        lam = (ta - imu_t[i1]) / max(imu_t[i2] - imu_t[i1], 1e-12)
        lam = np.clip(lam, 0.0, 1.0)
        return ((1 - lam) * imu_w[i1] + lam * imu_w[i2],
                (1 - lam) * imu_a[i1] + lam * imu_a[i2])

    (w0, a0), (w1, a1) = interp(t0), interp(t1)
    ts = np.asarray([t0, *imu_t[idx], t1])
    ws = np.asarray([w0, *imu_w[idx], w1])
    as_ = np.asarray([a0, *imu_a[idx], a1])
    if len(ts) > K:
        raise ValueError(f"IMU window {len(ts)} exceeds static capacity {K}")
    pad = K - len(ts)
    dev = resolve_device(device)

    def tensor(x):
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        return torch.as_tensor(x.astype(np.float32), device=dev)

    return ImuWindow(t=tensor(ts), w=tensor(ws), a=tensor(as_))
