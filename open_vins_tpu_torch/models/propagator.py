"""IMU state-mean + covariance propagation (rk4 and discrete integrators).

Counterpart of `open_vins_tpu/models/propagator.py` (Propagator parity,
Propagator.cpp:71-130, 395-587, 830-963).  The mean recursion over the IMU
window is a Python loop (about 10 steps per camera frame); the per-interval
Φ/B/Qd are built in one batch over the intervals and composed by the same
pairwise tree as the reference, so the rounding follows it; the covariance
is touched once.  The analytical (ACI²) integrator comes with the port's
second slice.

State error convention (JPL left error, [δθ δp δv δbg δba]):
    q = [δθ/2, 1] ⊗ q̂ ,  R_GtoI = (I - ⌊δθ⌋) R̂_GtoI
"""

from __future__ import annotations

import dataclasses

import torch

from open_vins_tpu_torch.core.ekf import propagate_covariance
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import TensorRecord, VioState
from open_vins_tpu_torch.ops import lie


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
    Dw, Da, Tg, R_w, R_a = (imu_intrinsic_mats(state, model)
                            if mats is None else mats)
    u_a = a_m - state.ba
    a_hat = _matvec(R_a, _matvec(Da, u_a))
    u_w = w_m - state.bg - _matvec(Tg, a_hat)
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

    Phi = torch.zeros((n, 15, 15), dtype=dtype, device=dev)
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
    B = torch.zeros((n, 15, 24), dtype=dtype, device=dev)
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
    G = torch.zeros((n, 15, 12), dtype=dtype, device=dev)
    G[:, 0:3, 0:3] = Fth_bg
    G[:, 0:3, 3:6] = Fth_ba
    G[:, 3:6, 3:6] = -0.5 * dt3 * dt3 * RtDa
    G[:, 6:9, 3:6] = -dt3 * RtDa
    G[:, 9:12, 6:9] = I3 * dt3
    G[:, 12:15, 9:12] = I3 * dt3
    Qd = (G * _qc(cfg, dt)[:, None, :]) @ G.mT
    return Phi, B, Qd


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


def propagate(state: VioState, cfg: FilterConfig, win: ImuWindow,
              t_new) -> VioState:
    """Propagate mean + covariance to t_new over the IMU window
    (Propagator::propagate_and_clone's propagation half); FEJ values of the
    IMU state are reset to the propagated estimate."""
    if cfg.integration == "analytical":
        raise NotImplementedError(
            "integration='analytical' (ACI²) is ported with the second slice "
            "of the port (SLAM, delayed init, joint qr update, ACI²)")
    if cfg.integration not in ("rk4", "discrete"):
        raise ValueError(f"unknown integration {cfg.integration!r}")
    dtype, dev = state.cov.dtype, state.cov.device
    gravity = torch.tensor([0.0, 0.0, cfg.gravity_mag], dtype=dtype,
                           device=dev)
    K = win.t.shape[0]
    R3 = lie.quat_2_rot(torch.stack([state.q, state.q_fej, state.imu_q_gyro,
                                     state.imu_q_acc]))
    mats = imu_intrinsic_mats(state, cfg.imu_model, R_w=R3[2], R_a=R3[3])
    Dw, Da, Tg, R_w, R_a = mats

    dts = torch.clamp(win.t[1:] - win.t[:-1], min=0.0)
    wc, ac, u_w, u_a = correct_imu(state, win.w, win.a, mats)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    step = _step_mean_rk4 if cfg.integration == "rk4" else _step_mean_midpoint

    q, p, v = state.q, state.p, state.v
    outs = []
    for k in range(K - 1):
        q, p, v, w_hat, a_hat = step(q, p, v, zero3, zero3, wc[k], ac[k],
                                     wc[k + 1], ac[k + 1], dts[k], gravity)
        outs.append((q, p, v, w_hat, a_hat))
    q_end, p_end, v_end, w_hats, a_hats = (torch.stack(x) for x in zip(*outs))

    q_lin = torch.cat([state.q_fej[None], q_end[:-1]])
    p_lin = torch.cat([state.p_fej[None], p_end[:-1]])
    v_lin = torch.cat([state.v_fej[None], v_end[:-1]])
    Phis, Bs, Qds = _phi_qd(
        (q_lin, p_lin, v_lin), (q_end, p_end, v_end), gravity, dts, cfg,
        (Dw, Da, Tg, R_w, R_a, w_hats, a_hats, u_w[:-1], u_a[:-1]))

    Phis, Bs, Qds = _mask_padded(Phis, Bs, Qds, dts)
    Phi, B, Qd = _compose_transitions(Phis, Bs, Qds)
    Qd = 0.5 * (Qd + Qd.T)

    use_B = cfg.calib_imu_intrinsics or cfg.calib_imu_g_sensitivity
    cov = propagate_covariance(state.cov, Phi, Qd, cfg,
                               B=B if use_B else None)
    return state.replace(
        q=q, p=p, v=v, cov=cov, q_fej=q, p_fej=p, v_fej=v,
        t=torch.as_tensor(t_new, dtype=dtype, device=dev),
    )
