"""JPL quaternion and SO(3) functions on torch tensors.

A frozen copy of `open_vins_tpu_torch/ops/lie.py`, so that the benchmark's
generator and reference import nothing of the program under test.  Every
function takes batched inputs (leading dims broadcast).

Conventions (JPL, as in Trawny & Roumeliotis TR-2005-002):
  * quaternion q = [x, y, z, w]  (vector part first, scalar last)
  * R(q) = (2w^2 - 1) I - 2 w [q_v]_x + 2 q_v q_v^T  rotates global -> local
  * q ⊗ p satisfies R(q ⊗ p) = R(q) R(p)
  * the JPL twist: for q = [k sin(θ/2), cos(θ/2)], R(q) = exp_so3(-θk), so
    `axis_angle_2_quat` negates the vector part and `log_so3` returns -θk.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def skew(v):
    """[v]_x skew-symmetric matrix. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    flat = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return flat.reshape(v.shape[:-1] + (3, 3))


def unskew(m):
    """Inverse of `skew`. (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def quat_norm(q):
    """Normalize, keeping the scalar part non-negative (JPL canonical)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def _quat_product(q, p):
    """Unnormalized JPL product q ⊗ p."""
    qv, q4 = q[..., :3], q[..., 3:4]
    pv, p4 = p[..., :3], p[..., 3:4]
    qv, pv = torch.broadcast_tensors(qv, pv)
    vec = q4 * pv + p4 * qv - torch.linalg.cross(qv, pv, dim=-1)
    sca = q4 * p4 - torch.sum(qv * pv, dim=-1, keepdim=True)
    return torch.cat([vec, sca], dim=-1)


def quat_multiply(q, p):
    """JPL quaternion product q ⊗ p with R(q⊗p) = R(q)R(p)."""
    return quat_norm(_quat_product(q, p))


def quat_2_rot(q):
    """JPL quaternion -> rotation matrix (global-to-local)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    d = 2.0 * w * w - 1.0
    flat = torch.stack(
        [
            d + 2.0 * x * x, 2.0 * (w * z + x * y), 2.0 * (x * z - w * y),
            2.0 * (x * y - w * z), d + 2.0 * y * y, 2.0 * (w * x + y * z),
            2.0 * (w * y + x * z), 2.0 * (y * z - w * x), d + 2.0 * z * z,
        ],
        dim=-1,
    )
    return flat.reshape(q.shape[:-1] + (3, 3))


def rot_2_quat(R):
    """Rotation matrix -> JPL quaternion (Shepperd's method, branch-free:
    the largest of the four candidate pivots is selected per element)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cw = 1.0 + tr
    cx = 1.0 + 2.0 * R[..., 0, 0] - tr
    cy = 1.0 + 2.0 * R[..., 1, 1] - tr
    cz = 1.0 + 2.0 * R[..., 2, 2] - tr
    # JPL: R12 - R21 = -4 w x (sign flip vs Hamilton); sums are convention
    # independent
    sxy = R[..., 0, 1] + R[..., 1, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    szx = R[..., 2, 0] + R[..., 0, 2]
    dyz = R[..., 1, 2] - R[..., 2, 1]
    dzx = R[..., 2, 0] - R[..., 0, 2]
    dxy = R[..., 0, 1] - R[..., 1, 0]

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    w0 = 0.5 * safe_sqrt(cw)
    q_w = torch.stack([dyz / (4.0 * w0), dzx / (4.0 * w0), dxy / (4.0 * w0),
                       w0], dim=-1)
    x1 = 0.5 * safe_sqrt(cx)
    q_x = torch.stack([x1, sxy / (4.0 * x1), szx / (4.0 * x1),
                       dyz / (4.0 * x1)], dim=-1)
    y2 = 0.5 * safe_sqrt(cy)
    q_y = torch.stack([sxy / (4.0 * y2), y2, syz / (4.0 * y2),
                       dzx / (4.0 * y2)], dim=-1)
    z3 = 0.5 * safe_sqrt(cz)
    q_z = torch.stack([szx / (4.0 * z3), syz / (4.0 * z3), z3,
                       dxy / (4.0 * z3)], dim=-1)

    idx = torch.argmax(torch.stack([cw, cx, cy, cz], dim=-1), dim=-1)
    qs = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # (..., 4, 4)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return quat_norm(q)


def _sinc_half(theta2):
    """sin(t)/t with Taylor fallback; input is t^2."""
    t = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(t), t)
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)


def _one_minus_cos_over_t2(theta2):
    """(1-cos t)/t^2 with Taylor fallback; input is t^2."""
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(torch.clamp(safe, min=_EPS))
    return torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / safe)


def _t_minus_sin_over_t3(theta2):
    """(t - sin t)/t^3 with Taylor fallback; input is t^2."""
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(torch.clamp(safe, min=_EPS))
    return torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                       (t - torch.sin(t)) / (safe * t))


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w):
    """SO(3) exponential map (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    A = _sinc_half(theta2)[..., None, None]
    B = _one_minus_cos_over_t2(theta2)[..., None, None]
    W = skew(w)
    return _eye_like(W) + A * W + B * (W @ W)


def log_so3(R):
    """SO(3) logarithm through the Shepperd-stable quaternion:
    log(R) = -θ k with θ = 2 atan2(|q_v|, q_w) (stable near π)."""
    q = rot_2_quat(R)
    qv, qw = q[..., :3], q[..., 3]
    n2 = torch.sum(qv * qv, dim=-1)
    n = torch.sqrt(torch.clamp(n2, min=_EPS))
    small = n2 < 1e-14
    theta = 2.0 * torch.atan2(n, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS), theta / n)
    return -scale[..., None] * qv


def axis_angle_2_quat(w):
    """Rotation vector -> JPL quaternion with R(q) = exp_so3(w) (the vector
    part is negated: the JPL twist above)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-10
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(theta),
                                                  theta))
    vec = -k * w
    sca = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_norm(torch.cat([vec, sca], dim=-1))


def Jl_so3(w):
    """Left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    B = _one_minus_cos_over_t2(theta2)[..., None, None]
    C = _t_minus_sin_over_t3(theta2)[..., None, None]
    W = skew(w)
    return _eye_like(W) + B * W + C * (W @ W)


def Jr_so3(w):
    """Right Jacobian of SO(3): Jr(w) = Jl(-w)."""
    return Jl_so3(-w)


def Jl_so3_inv(w):
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    half = 0.5 * t
    one = torch.ones_like(theta2)
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * t / torch.tan(torch.where(small, one, half)))
        / torch.where(small, one, theta2))
    W = skew(w)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def Omega(w):
    """Quaternion-kinematics Ω(w) (JPL): q̇ = 0.5 Ω(w) q."""
    W = -skew(w)
    top = torch.cat([W, w[..., :, None]], dim=-1)
    bot = torch.cat([-w[..., None, :], torch.zeros_like(w[..., :1, None])],
                    dim=-1)
    return torch.cat([top, bot], dim=-2)


def _homogeneous(top):
    """[..., 3, 4] -> [..., 4, 4] with the last row [0, 0, 0, 1]."""
    bot = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                      device=top.device)
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)


def exp_se3(v):
    """SE(3) exponential: v = [ω; ρ] (..., 6) -> (..., 4, 4)."""
    w, rho = v[..., :3], v[..., 3:]
    t = (Jl_so3(w) @ rho[..., None])
    return _homogeneous(torch.cat([exp_so3(w), t], dim=-1))


def hat_se3(v):
    """se(3) hat: (..., 6) -> (..., 4, 4)."""
    top = torch.cat([skew(v[..., :3]), v[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)
