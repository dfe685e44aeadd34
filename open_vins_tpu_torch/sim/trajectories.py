"""Groundtruth trajectory files for the simulator.

Counterpart of `open_vins_tpu/sim/trajectories.py` (the reference's
DatasetReader::load_simulated_trajectory, dataset_reader.h:177-247, and the
BsplineSE3::feed_trajectory re-gridding, BsplineSE3.cpp:27-100).  Rows are
``timestamp p_IinG(3) q_GtoI(4, JPL xyzw)``; control poses sit on a uniform
grid over the file's timeline, each linearly interpolated from its bounding
rows.  Parsing and gridding are numpy; the trajectory comes back as float32
tensors (times [K], R_ItoG [K, 3, 3], p_IinG [K, 3]) on `device`
(None = CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.ops import lie


def _read_rows(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    arr = np.asarray(rows, dtype=np.float64)
    if len(arr) < 8:
        raise ValueError(f"trajectory too short: {path}")
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]  # t, p, q_GtoI (JPL xyzw)


def _interp_poses(t, p, q, grid):
    """Linearly interpolate positions and (sign-aligned, normalized)
    quaternions at the grid times; clamps outside [t[0], t[-1]] (frozen end
    poses)."""
    idx = np.clip(np.searchsorted(t, grid, side="right") - 1, 0, len(t) - 2)
    t0, t1 = t[idx], t[idx + 1]
    lam = np.clip((grid - t0) / np.maximum(t1 - t0, 1e-9), 0.0, 1.0)
    p_out = (1.0 - lam)[:, None] * p[idx] + lam[:, None] * p[idx + 1]
    q0, q1 = q[idx], q[idx + 1]
    q1 = q1 * np.where(np.sum(q0 * q1, axis=1) < 0.0, -1.0, 1.0)[:, None]
    q_out = (1.0 - lam)[:, None] * q0 + lam[:, None] * q1
    q_out /= np.maximum(np.linalg.norm(q_out, axis=1, keepdims=True), 1e-12)
    return p_out, q_out


def _to_traj(times_rel, p, q_GtoI, device):
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    return f32(times_rel), lie.quat_2_rot(f32(q_GtoI)).mT, f32(p)


def load_trajectory_file(path, device=None):
    """Parse a trajectory file -> (times [K], R_ItoG [K, 3, 3], p [K, 3]).

    Times start at 0; control poses sit on a uniform grid over the true
    timeline at dt = max(mean Δt, 0.05) s (the reference's BsplineSE3
    control density)."""
    t, p, q = _read_rows(path)
    dt = max(float(np.mean(np.diff(t))), 0.05)
    n = int(np.floor((t[-1] - t[0]) / dt)) + 1
    grid = t[0] + np.arange(n) * dt
    p_g, q_g = _interp_poses(t, p, q, grid)
    return _to_traj(np.arange(n) * dt, p_g, q_g, device)


def load_trajectory_padded(path, n_ctrl, dt=0.05, t_skip=0.0, device=None):
    """Like `load_trajectory_file`, but with exactly `n_ctrl` control points
    at spacing `dt`: grid times beyond the file's end freeze at the final
    pose (zero velocity; the IMU then measures pure gravity).  `t_skip`
    drops the first seconds of the file before gridding (the reference's
    per-sequence bag start offsets, run_ros_eth.sh:34-47).
    Returns (traj, valid_duration_s): the span of real motion after the
    skip."""
    t, p, q = _read_rows(path)
    grid = t[0] + t_skip + np.arange(n_ctrl) * dt
    p_g, q_g = _interp_poses(t, p, q, grid)
    valid = float(min(max(t[-1] - t[0] - t_skip, 0.0), (n_ctrl - 1) * dt))
    return _to_traj(np.arange(n_ctrl) * dt, p_g, q_g, device), valid


# per-sequence start skips over the EuRoC MH ground-stationary periods: the
# reference's bag start offsets (ov_msckf/scripts/run_ros_eth.sh:34-47)
EUROC_START_SKIP = {
    "MH_01_easy": 40.0, "MH_02_easy": 35.0, "MH_03_medium": 5.0,
    "MH_04_difficult": 10.0, "MH_05_difficult": 5.0,
}


def motion_skip(path, t_skip, start_offset, thresh=0.8):
    """Extra seconds (beyond t_skip) until sustained motion: the earliest τ
    with net displacement |p(τ+3 s) − p(τ)| ≥ 1.2·thresh meters, capped at
    30 s (the skip-until-motion start, Simulator.cpp:80-109, at the corpus
    level).  Net displacement over a 3 s window, so mocap noise and a
    single hop before takeoff do not count."""
    t, p, _ = _read_rows(path)
    t = t - t[0]
    i0 = int(np.searchsorted(t, t_skip + start_offset))
    if i0 >= len(t) - 2:
        return 0.0
    tt = t[i0:]
    pp = p[i0:]
    j3 = np.clip(np.searchsorted(tt, tt + 3.0), 0, len(tt) - 1)
    disp3 = np.linalg.norm(pp[j3] - pp, axis=1)
    idx = np.where(disp3 >= 1.2 * thresh)[0]
    if len(idx) == 0:
        return 0.0
    return float(min(tt[idx[0]] - tt[0], 30.0))
