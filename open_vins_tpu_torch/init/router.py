"""Initialization router: static or dynamic.

Counterpart of `open_vins_tpu/init/router.py`
(ov_init::InertialInitializer, InertialInitializer.cpp:55-159): the feature
disparity over two half-windows decides the route — a still platform
(low disparity) waits for a jerk and runs the static initializer, a moving
one runs the dynamic initializer.  `average_disparity`, `decide` and the
host half of `build_dyn_input` are numpy; the attempts run on the device
of the tensors they are given, and each reads its success flag on the host
once, inside the `INIT_SUCCESS_READ` span.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.init import dynamic_init, static_init
from open_vins_tpu_torch.utils.profiling import annotate

# span (`utils.profiling.annotate`) around an attempt's one host read of
# its success flag
INIT_SUCCESS_READ = "init.success_read"


class RouterOptions(NamedTuple):
    window_time: float = 1.0  # half-window seconds (init_window_time/2)
    imu_thresh: float = 1.0
    max_disparity: float = 10.0  # px over the window => moving
    wait_for_jerk: bool = True
    gravity_mag: float = 9.81


def average_disparity(tracks_uv, tracks_t, t_lo, t_hi):
    """Mean displacement (px) between the oldest and newest observation of
    each track inside [t_lo, t_hi]; tracks_uv a list of [K_i, 2] arrays
    with their times tracks_t, a list of [K_i]."""
    disps = []
    for uv, ts in zip(tracks_uv, tracks_t):
        ts = np.asarray(ts)
        sel = (ts >= t_lo) & (ts <= t_hi)
        if sel.sum() < 2:
            continue
        u = np.asarray(uv)[sel]
        disps.append(np.linalg.norm(u[-1] - u[0]))
    return float(np.mean(disps)) if disps else 0.0


def decide(opts: RouterOptions, disparity_w1, disparity_w2):
    """(use_static, use_dynamic) from the two half-window disparities
    (InertialInitializer.cpp:104-158): both quiet -> static (the static
    initializer waits for the jerk), motion in either -> dynamic."""
    moving = (disparity_w1 > opts.max_disparity) or (
        disparity_w2 > opts.max_disparity)
    return (not moving), moving


def _succeeded(res) -> bool:
    with annotate(INIT_SUCCESS_READ):
        return bool(res.success)


def try_initialize(opts: RouterOptions, imu_t, imu_w, imu_a, t_newest,
                   disparity_w1, disparity_w2, dyn_input=None,
                   dyn_opts=None):
    """One routed attempt on the IMU buffer imu_t [K], imu_w / imu_a
    [K, 3] (tensors; the static attempt runs on their device).  Returns
    (kind, result) with kind in {"none", "static", "dynamic"}.
    `dyn_input` (dynamic_init.DynInitInput) comes from the caller, which
    owns the feature tracks, when motion is detected."""
    use_static, use_dynamic = decide(opts, disparity_w1, disparity_w2)
    if use_static:
        sopts = static_init.StaticInitOptions(
            window_time=opts.window_time, imu_thresh=opts.imu_thresh,
            wait_for_jerk=opts.wait_for_jerk, gravity_mag=opts.gravity_mag)
        res = static_init.try_static_init(sopts, imu_t, imu_w, imu_a,
                                          imu_t <= t_newest, float(t_newest))
        if _succeeded(res):
            return "static", res
        return "none", None
    if use_dynamic and dyn_input is not None:
        dopts = dyn_opts or dynamic_init.DynamicInitOptions(
            gravity_mag=opts.gravity_mag)
        res = dynamic_init.initialize(dyn_input, dopts)
        if _succeeded(res):
            return "dynamic", res
    return "none", None


def build_dyn_input(track_hist, t_poses, make_window, R_ItoC, p_IinC,
                    max_feats=50, K=32, min_obs=3, device=None):
    """A DynInitInput on `device` (None = CUDA) from live tracker history
    (DynamicInitializer.cpp:90-180's feature and IMU gathering):

    - track_hist: dict id -> (list[t], list[uvn 2-vector]) of camera 0;
    - t_poses: the P ascending pose times (camera frames in the window);
    - make_window: (t0, t1, K) -> (n, t[K+1], w[K+1, 3], a[K+1, 3]), the
      native SensorHub window packer (padded by repeating the last row:
      dt = 0 no-ops of the preintegration).

    Returns None when fewer than 8 features are seen at `min_obs` poses or
    a segment has no IMU samples."""
    t_poses = np.asarray(t_poses, dtype=np.float64)
    P = len(t_poses)
    feats = []
    for _, (ts, uvns) in track_hist.items():
        ts = np.asarray(ts)
        row = np.zeros((P, 2), dtype=np.float32)
        mask = np.zeros((P,), dtype=bool)
        for j, tp in enumerate(t_poses):
            k = np.argmin(np.abs(ts - tp))
            if abs(ts[k] - tp) < 1e-4:
                row[j] = uvns[k]
                mask[j] = True
        if mask.sum() >= min_obs:
            feats.append((mask.sum(), row, mask))
    if len(feats) < 8:
        return None
    feats.sort(key=lambda x: -x[0])
    feats = feats[:max_feats]
    uvn = np.zeros((max_feats, P, 2), dtype=np.float32)
    obs_mask = np.zeros((max_feats, P), dtype=bool)
    for i, (_, row, mask) in enumerate(feats):
        uvn[i], obs_mask[i] = row, mask

    imu_t = np.zeros((P - 1, K + 1), dtype=np.float32)
    imu_w = np.zeros((P - 1, K + 1, 3), dtype=np.float32)
    imu_a = np.zeros((P - 1, K + 1, 3), dtype=np.float32)
    for i in range(P - 1):
        n, wt, ww, wa = make_window(float(t_poses[i]), float(t_poses[i + 1]),
                                    K)
        if n <= 0:
            return None
        imu_t[i], imu_w[i], imu_a[i] = wt, ww, wa

    dev = resolve_device(device)

    def tensor(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=dev)

    return dynamic_init.DynInitInput(
        t_pose=tensor(t_poses, np.float32), imu_t=tensor(imu_t),
        imu_w=tensor(imu_w), imu_a=tensor(imu_a), uvn=tensor(uvn),
        obs_mask=tensor(obs_mask), R_ItoC=tensor(R_ItoC, np.float32),
        p_IinC=tensor(p_IinC, np.float32))
