"""Static (standstill) initialization.

Counterpart of `open_vins_tpu/init/static_init.py`
(ov_init::StaticInitializer, StaticInitializer.cpp:37-220): two half-windows
of IMU samples, the newer of which must show an excitation jerk (or must
not, when not waiting for one) and the older of which must be quiet; the
gravity direction from the quiet window's mean specific force by
Gram-Schmidt; the gyro bias the mean gyro; the accel bias the mean accel
minus gravity; a diagonal initial covariance.  Fixed-size buffers with a
validity mask, so nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.ops import lie


class StaticInitOptions(NamedTuple):
    """InertialInitializerOptions subset (InertialInitializerOptions.h)."""

    window_time: float = 0.75  # seconds per half-window (init_window_time/2)
    imu_thresh: float = 1.0  # accel std threshold of the jerk test
    wait_for_jerk: bool = True
    gravity_mag: float = 9.81
    # initial standard deviations (diagonal prior)
    sigma_q: float = 0.02
    sigma_p: float = 1e-4
    sigma_v: float = 0.05
    sigma_bg: float = 0.005
    sigma_ba: float = 0.05


@dataclasses.dataclass
class StaticInitResult(TensorRecord):
    success: torch.Tensor  # bool
    q_GtoI: torch.Tensor  # [4] JPL
    p: torch.Tensor  # [3] (zero)
    v: torch.Tensor  # [3] (zero)
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    prior_diag15: torch.Tensor  # [15] diagonal covariance of the IMU block


def gram_schmidt_gravity(z):
    """R_GtoI from the gravity direction z in the IMU frame (helper.h:138):
    columns (x, y, ẑ) with x from e1 by Gram-Schmidt against ẑ — the
    rotation that takes the world's e_z to the measured direction."""
    z = z / torch.linalg.vector_norm(z)
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device)
    x = e1 - z * torch.dot(z, e1)
    x = x / torch.linalg.vector_norm(x)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=1)


def try_static_init(opts: StaticInitOptions, imu_t, imu_w, imu_a, mask,
                    t_newest) -> StaticInitResult:
    """One static-init attempt on a buffered IMU window: imu_t [K],
    imu_w / imu_a [K, 3], `mask` [K] the valid samples, t_newest the time
    the init applies at.  Window 2 is (t_newest − window, t_newest], window
    1 the window before it."""
    dtype, dev = imu_a.dtype, imu_a.device
    t1_lo = t_newest - 2.0 * opts.window_time
    t1_hi = t_newest - opts.window_time
    in1 = mask & (imu_t >= t1_lo) & (imu_t < t1_hi)
    in2 = mask & (imu_t >= t1_hi) & (imu_t <= t_newest)

    def mean_std(x, m):
        mf = m.to(dtype)[:, None]
        n = torch.clamp(mf.sum(), min=1.0)
        mu = (x * mf).sum(dim=0) / n
        var = (((x - mu) ** 2) * mf).sum(dim=0) / torch.clamp(n - 1.0,
                                                             min=1.0)
        return mu, torch.sqrt(var.sum()), n

    a1_mu, a1_std, n1 = mean_std(imu_a, in1)
    _, a2_std, n2 = mean_std(imu_a, in2)
    w1_mu, _, _ = mean_std(imu_w, in1)

    success = (n1 > 5) & (n2 > 5) & (a1_std < opts.imu_thresh)
    if opts.wait_for_jerk:
        success = success & (a2_std > opts.imu_thresh)
    else:  # both windows still: the device starts from standstill
        success = success & (a2_std < opts.imu_thresh)

    R_GtoI = gram_schmidt_gravity(a1_mu)
    gravity = torch.tensor([0.0, 0.0, opts.gravity_mag], dtype=dtype,
                           device=dev)
    prior = torch.tensor(
        [opts.sigma_q ** 2] * 3 + [opts.sigma_p ** 2] * 3
        + [opts.sigma_v ** 2] * 3 + [opts.sigma_bg ** 2] * 3
        + [opts.sigma_ba ** 2] * 3, dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    return StaticInitResult(
        success=success, q_GtoI=lie.rot_2_quat(R_GtoI), p=z3, v=z3,
        bg=w1_mu, ba=a1_mu - R_GtoI @ gravity, prior_diag15=prior)
