"""Uniform cumulative cubic B-spline on SE(3), batched over query times.

A frozen copy of `open_vins_tpu_torch/sim/bspline.py` (BsplineSE3,
ov_core/src/sim/BsplineSE3.h:30-120) for the benchmark's generator: the
given uniform-rate poses are the control points, a pose is
T(t) = T_{i-1} A₁ A₂ A₃ with A_j = exp(b̃_j(u) Ω_j), and the relative twists Ω_k = log(T_{k-1}⁻¹ T_k) are computed once.

ω, v and a come from the closed-form derivatives of the product, as
BsplineSE3 derives them: dA_j/dt = A_j Ω̂_j ḃ_j and
d²A_j/dt² = A_j (Ω̂_j² ḃ_j² + Ω̂_j b̈_j), since exp(bΩ̂) commutes with Ω̂.

Convention: transforms are body-to-global, T = (R_ItoG, p_IinG); the body
angular velocity is ω = unskew(Rᵀ Ṙ) and the acceleration is the global p̈.
"""

from __future__ import annotations

import dataclasses

import torch

from vio_bench.plain import lie


@dataclasses.dataclass
class Bspline:
    ctrl_R: torch.Tensor  # [N, 3, 3] body-to-global rotations
    ctrl_p: torch.Tensor  # [N, 3] positions
    omegas: torch.Tensor  # [N-1, 6] relative twists log(T_{k-1}⁻¹ T_k)
    dt: torch.Tensor  # scalar control-point spacing (seconds)
    t0: torch.Tensor  # scalar start time of the control grid


def _cumulative_basis(u):
    """Cumulative cubic basis b̃₁..b̃₃ at normalized u ∈ [0, 1), with its
    first and second derivatives in u."""
    u2 = u * u
    u3 = u2 * u
    b = ((5.0 + 3.0 * u - 3.0 * u2 + u3) / 6.0,
         (1.0 + 3.0 * u + 3.0 * u2 - 2.0 * u3) / 6.0,
         u3 / 6.0)
    db = ((3.0 - 6.0 * u + 3.0 * u2) / 6.0,
          (3.0 + 6.0 * u - 6.0 * u2) / 6.0,
          3.0 * u2 / 6.0)
    ddb = (u - 1.0, 1.0 - 2.0 * u, u)
    return b, db, ddb


def fit(times, Rs, ps) -> Bspline:
    """A spline whose control points are the given uniform-rate poses
    (BsplineSE3::feed_trajectory): times [N] sorted and evenly spaced,
    Rs [N, 3, 3], ps [N, 3], all on one device."""
    dt = (times[-1] - times[0]) / (times.shape[0] - 1)
    prev_inv = Rs[:-1].mT
    rel_R = prev_inv @ Rs[1:]
    rel_p = (prev_inv @ (ps[1:] - ps[:-1])[..., None])[..., 0]
    w = lie.log_so3(rel_R)
    rho = (lie.Jl_so3_inv(w) @ rel_p[..., None])[..., 0]
    return Bspline(ctrl_R=Rs, ctrl_p=ps, omegas=torch.cat([w, rho], dim=-1),
                   dt=dt, t0=times[0])


def _evaluate(spline: Bspline, t, order: int):
    """(R0, p0, [A, Ȧ, Ä][:order+1]) at times t [...]: T(t) = (R0, p0)·A,
    A and its time derivatives as [..., 4, 4]."""
    n = spline.ctrl_R.shape[0]
    s = (t - spline.t0) / spline.dt
    # segment [t_i, t_{i+1}) uses control points i-1 .. i+2
    i = torch.clamp(torch.floor(s).to(torch.int64), 1, n - 3)
    u = s - i.to(s.dtype)
    b, db, ddb = _cumulative_basis(u)
    om = [spline.omegas[i - 1], spline.omegas[i], spline.omegas[i + 1]]
    A = [lie.exp_se3(b[j][..., None] * om[j]) for j in range(3)]
    out = [A[0] @ A[1] @ A[2]]
    if order >= 1:
        rate = 1.0 / spline.dt  # du/dt
        W = [lie.hat_se3(o) for o in om]
        d1 = [A[j] @ W[j] * (db[j] * rate)[..., None, None]
              for j in range(3)]
        out.append(d1[0] @ A[1] @ A[2] + A[0] @ d1[1] @ A[2]
                   + A[0] @ A[1] @ d1[2])
    if order >= 2:
        d2 = [A[j] @ (W[j] @ W[j] * ((db[j] * rate) ** 2)[..., None, None]
                      + W[j] * (ddb[j] * rate * rate)[..., None, None])
              for j in range(3)]
        out.append(d2[0] @ A[1] @ A[2] + A[0] @ d2[1] @ A[2]
                   + A[0] @ A[1] @ d2[2]
                   + 2.0 * (d1[0] @ d1[1] @ A[2] + d1[0] @ A[1] @ d1[2]
                            + A[0] @ d1[1] @ d1[2]))
    return spline.ctrl_R[i - 1], spline.ctrl_p[i - 1], out


def _apply(R0, p0, M):
    """(R0 M_R, p0 + R0 M_t) of a pose A; R0 M_t alone for a derivative
    (p0 = None)."""
    R = R0 @ M[..., :3, :3]
    t = (R0 @ M[..., :3, 3:4])[..., 0]
    return R, t if p0 is None else p0 + t


def pose(spline: Bspline, t):
    """T(t) -> (R_ItoG [..., 3, 3], p_IinG [..., 3]) at times t [...]."""
    R0, p0, (A,) = _evaluate(spline, t, 0)
    return _apply(R0, p0, A)


def velocity(spline: Bspline, t):
    """(ω_body [..., 3], v_global [..., 3]) at times t [...]."""
    R0, p0, (A, dA) = _evaluate(spline, t, 1)
    R, _ = _apply(R0, p0, A)
    Rdot, v = _apply(R0, None, dA)
    return lie.unskew(R.mT @ Rdot), v


def acceleration(spline: Bspline, t):
    """(ω_body, ω̇_body, v_global, a_global), each [..., 3], at times t."""
    R0, p0, (A, dA, ddA) = _evaluate(spline, t, 2)
    R, _ = _apply(R0, p0, A)
    Rdot, v = _apply(R0, None, dA)
    Rddot, a = _apply(R0, None, ddA)
    w = lie.unskew(R.mT @ Rdot)
    wdot = lie.unskew(Rdot.mT @ Rdot + R.mT @ Rddot)
    return w, wdot, v, a


def imu_measurement(spline: Bspline, t, gravity):
    """Noise-free IMU samples at times t: (ω_m body rate, a_m specific force
    in the body frame), each [..., 3].  The world is z-up with gravity
    stored as [0, 0, +9.81], so a_m = R_GtoI (a_global + g)
    (Simulator::get_next_imu's true-signal path)."""
    R0, p0, (A, dA, ddA) = _evaluate(spline, t, 2)
    R, _ = _apply(R0, p0, A)
    Rdot, _ = _apply(R0, None, dA)
    _, a = _apply(R0, None, ddA)
    w = lie.unskew(R.mT @ Rdot)
    return w, (R.mT @ (a + gravity)[..., None])[..., 0]
