"""Camera projection models (pinhole radtan + equidistant): distortion, its
analytic Jacobians and undistortion.

Counterpart of `distort`, `undistort` and `distort_jacobians_soa` in
`open_vins_tpu/ops/cameras.py` (reference math CamRadtan.h:100-200,
CamEqui.h:100-235).  Undistortion runs the reference's fixed iteration
count, so both packages do the same arithmetic (not OpenCV's loop).  Intrinsics layout: zeta = [fx, fy, cx, cy, d0..d3];
radtan d = [k1, k2, p1, p2], equi d = [k1, k2, k3, k4].
"""

from __future__ import annotations

import torch

RADTAN = "radtan"
EQUI = "equi"

_UNDISTORT_ITERS = 25  # the reference's fixed count (<1e-10 at the corners)


def _distort_norm_radtan(zeta, xy):
    k1, k2, p1, p2 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _distort_norm_equi(zeta, xy):
    k1, k2, k3, k4 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r2 < 1e-16, torch.ones_like(r), theta_d / r)
    return torch.stack([x * scale, y * scale], dim=-1)


_DISTORT_NORM = {RADTAN: _distort_norm_radtan, EQUI: _distort_norm_equi}


def distort(model: str, zeta, uv_norm):
    """Normalized image coords -> raw pixel coords. (..., 2) -> (..., 2);
    zeta [8] (or broadcastable [..., 8])."""
    d = _DISTORT_NORM[model](zeta, uv_norm)
    fx, fy, cx, cy = zeta[..., 0], zeta[..., 1], zeta[..., 2], zeta[..., 3]
    return torch.stack([fx * d[..., 0] + cx, fy * d[..., 1] + cy], dim=-1)


def _undistort_norm_radtan(zeta, target):
    """Fixed-point iteration x <- (x_d - tangential(x)) / radial(x)."""
    k1, k2, p1, p2 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
    x, y = target[..., 0], target[..., 1]
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (target[..., 0] - dx) / radial, (target[..., 1] - dy) / radial
    return torch.stack([x, y], dim=-1)


def _undistort_norm_equi(zeta, target):
    """|xy_d| = θ_d: scalar Newton for θ, then rescale by tan θ / θ_d."""
    k1, k2, k3, k4 = zeta[..., 4], zeta[..., 5], zeta[..., 6], zeta[..., 7]
    theta_d = torch.sqrt(torch.clamp(torch.sum(target * target, dim=-1),
                                     min=1e-24))
    theta = theta_d
    for _ in range(_UNDISTORT_ITERS):
        t2 = theta * theta
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        dpoly = (3.0 * k1 * t2 + 5.0 * k2 * t2 * t2 + 7.0 * k3 * t2 ** 3
                 + 9.0 * k4 * t2 ** 4)
        f = theta * poly - theta_d
        df = poly + dpoly
        theta = theta - f / torch.where(torch.abs(df) > 1e-6, df, 1.0)
    scale = torch.where(theta_d > 1e-9, torch.tan(theta) / theta_d, 1.0)
    return target * scale[..., None]


_UNDISTORT_NORM = {RADTAN: _undistort_norm_radtan, EQUI: _undistort_norm_equi}


def undistort(model: str, zeta, uv_px):
    """Raw pixel coords -> normalized image coords. (..., 2) -> (..., 2);
    zeta [8] (or broadcastable [..., 8])."""
    fx, fy, cx, cy = zeta[..., 0], zeta[..., 1], zeta[..., 2], zeta[..., 3]
    target = torch.stack([(uv_px[..., 0] - cx) / fx,
                          (uv_px[..., 1] - cy) / fy], dim=-1)
    return _UNDISTORT_NORM[model](zeta, target)


def _distort_jac_soa_radtan(zc, x, y):
    """zc [8, M], x/y [M] -> (uv [2,M], J_pt [2,2,M], J_zeta [2,8,M])."""
    fx, fy, cx, cy, k1, k2, p1, p2 = (zc[i] for i in range(8))
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    u = fx * xd + cx
    v = fy * yd + cy
    dk = k1 + 2.0 * k2 * r2  # d radial / d r2
    dxd_dx = radial + 2.0 * x * x * dk + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = 2.0 * x * y * dk + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dx = dxd_dy
    dyd_dy = radial + 2.0 * y * y * dk + 6.0 * p1 * y + 2.0 * p2 * x
    J_pt = torch.stack([
        torch.stack([fx * dxd_dx, fx * dxd_dy]),
        torch.stack([fy * dyd_dx, fy * dyd_dy]),
    ])
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    J_zeta = torch.stack([
        torch.stack([xd, zero, one, zero, fx * x * r2, fx * x * r2 * r2,
                     fx * 2.0 * x * y, fx * (r2 + 2.0 * x * x)]),
        torch.stack([zero, yd, zero, one, fy * y * r2, fy * y * r2 * r2,
                     fy * (r2 + 2.0 * y * y), fy * 2.0 * x * y]),
    ])
    return torch.stack([u, v]), J_pt, J_zeta


def _distort_jac_soa_equi(zc, x, y):
    """Equidistant model, same contract as the radtan variant."""
    fx, fy, cx, cy, k1, k2, k3, k4 = (zc[i] for i in range(8))
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    small = r2 < 1e-16
    theta = torch.atan(r)
    t2 = theta * theta
    poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
    theta_d = theta * poly
    scale = torch.where(small, torch.ones_like(r), theta_d / r)
    xd = x * scale
    yd = y * scale
    u = fx * xd + cx
    v = fy * yd + cy
    dthd_dth = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2
                                            + t2 * (7.0 * k3 + 9.0 * k4 * t2)))
    dth_dr = 1.0 / (1.0 + r2)
    zero = torch.zeros_like(x)
    r_safe = torch.clamp(r, min=1e-12)
    dscale_dr = torch.where(small, zero, (dthd_dth * dth_dr - scale) / r_safe)
    rx = torch.where(small, zero, x / r_safe)
    ry = torch.where(small, zero, y / r_safe)
    dxd_dx = scale + x * dscale_dr * rx
    dxd_dy = x * dscale_dr * ry
    dyd_dx = y * dscale_dr * rx
    dyd_dy = scale + y * dscale_dr * ry
    J_pt = torch.stack([
        torch.stack([fx * dxd_dx, fx * dxd_dy]),
        torch.stack([fy * dyd_dx, fy * dyd_dy]),
    ])
    one = torch.ones_like(x)
    t3 = t2 * theta
    safe_inv_r = torch.where(small, zero, 1.0 / r_safe)
    dthd_k = [t3, t3 * t2, t3 * t2 * t2, t3 * t2 * t2 * t2]
    J_zeta = torch.stack([
        torch.stack([xd, zero, one, zero]
                    + [fx * x * safe_inv_r * d for d in dthd_k]),
        torch.stack([zero, yd, zero, one]
                    + [fy * y * safe_inv_r * d for d in dthd_k]),
    ])
    return torch.stack([u, v]), J_pt, J_zeta


_DISTORT_JAC_SOA = {RADTAN: _distort_jac_soa_radtan,
                    EQUI: _distort_jac_soa_equi}


def distort_jacobians_soa(model: str, zeta_cols, x, y):
    """SoA distortion: zeta_cols [8, M], x/y [M] →
    (uv_pred [2,M], d_uv/d_uvnorm [2,2,M], d_uv/d_zeta [2,8,M])."""
    return _DISTORT_JAC_SOA[model](zeta_cols, x, y)
