"""Seeded visual-inertial simulator.

Counterpart of `open_vins_tpu/sim/simulator.py` (the reference simulator,
ov_msckf/src/sim/Simulator.{h,cpp}): an SE(3) B-spline trajectory, IMU
samples at `imu_rate` with white noise and bias random walks, per-camera
projections of a persistent feature map with stable ids (the TrackSIM
contract, TrackSIM.cpp:30-79) and pixel noise, an optional perturbed
starting calibration, and a groundtruth oracle.  `get_imu` and `get_cam`
are vectorized over steps and frames.

Randomness.  Every random number of a run is drawn once, on the host, into
one record (`SimDraws`, or `CalibDraws` for `perturb_calib`) from
numpy.random.Generator(PCG64(seed)); `build` and `perturb_calib` then only
scale and shift these draws.  So one seed gives the same stream on the CPU
and on the GPU, and a test can pass in the reference package's own
`jax.random` draws and hold the port to its output.  The record keeps unit
draws (uniforms on [0, 1), standard normals); the scaling is the
reference's arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.ops import cameras, lie
from open_vins_tpu_torch.sim import bspline


class SimParams(NamedTuple):
    """Static simulator configuration (the reference's fields and
    defaults)."""

    imu_rate: float = 200.0
    cam_rate: float = 20.0
    num_cams: int = 1
    num_pts: int = 100  # features returned per camera per frame
    map_size: int = 4096  # persistent map size
    sigma_w: float = 1.6968e-4  # gyro white noise density (rad/s/sqrt(Hz))
    sigma_wb: float = 1.9393e-5  # gyro bias random walk
    sigma_a: float = 2.0e-3  # accel white noise density
    sigma_ab: float = 3.0e-3  # accel bias random walk
    sigma_pix: float = 1.0  # pixel noise std
    gravity_mag: float = 9.81
    min_depth: float = 5.0
    max_depth: float = 10.0
    width: int = 752
    height: int = 480
    cam_model: str = cameras.RADTAN
    duration: float = 60.0  # simulated seconds after the start offset
    start_offset: float = 2.0  # skip the first spline seconds
    distance_threshold: float = 0.0  # >0: also skip forward until the
    # platform has moved this far along its path (Simulator.cpp:80-109)
    map_duration: float = 0.0  # >0: sample the map over the first
    # map_duration seconds only (padded replays freeze their end pose)
    min_view_depth: float = 0.1  # a map point is measurable only while its
    # camera depth exceeds this (Simulator.cpp project_pointcloud: 0.1 m)


@dataclasses.dataclass
class SimDraws(TensorRecord):
    """Every random number of one simulated run, as unit draws."""

    map_t: torch.Tensor  # [M] uniform: the map's sample times
    map_cam: torch.Tensor  # [M] int32 in [0, num_cams): the map's cameras
    map_uv: torch.Tensor  # [M, 2] uniform: the map's pixels
    map_depth: torch.Tensor  # [M] uniform: the map's depths
    bias_g_inc: torch.Tensor  # [n_imu+1, 3] normal: gyro bias increments
    bias_a_inc: torch.Tensor  # [n_imu+1, 3] normal: accel bias increments
    imu_w: torch.Tensor  # [n_imu+1, 3] normal: gyro white noise
    imu_a: torch.Tensor  # [n_imu+1, 3] normal: accel white noise
    pix: torch.Tensor  # [n_frames, num_cams, num_pts, 2] normal: pixel noise


@dataclasses.dataclass
class CalibDraws(TensorRecord):
    """The standard normals of `perturb_calib` for N cameras."""

    dt: torch.Tensor  # []
    intr: torch.Tensor  # [N, 8]
    rot: torch.Tensor  # [N, 3]
    pos: torch.Tensor  # [N, 3]
    imu_dw: torch.Tensor  # [6]
    imu_da: torch.Tensor  # [6]
    gyro_rot: torch.Tensor  # [3]
    acc_rot: torch.Tensor  # [3]
    imu_tg: torch.Tensor  # [9]


@dataclasses.dataclass
class SimData(TensorRecord):
    """The built simulator: spline, map, calibration, bias walks, noise."""

    spline: bspline.Bspline
    map_pts: torch.Tensor  # [M, 3] global feature positions
    cam_intr: torch.Tensor  # [num_cams, 8]
    cam_R_ItoC: torch.Tensor  # [num_cams, 3, 3]
    cam_p_IinC: torch.Tensor  # [num_cams, 3]
    calib_dt: torch.Tensor  # scalar true camera-IMU time offset
    bias_g_traj: torch.Tensor  # [n_imu+1, 3] true gyro bias per IMU step
    bias_a_traj: torch.Tensor  # [n_imu+1, 3]
    gravity: torch.Tensor  # [3]
    t_start: torch.Tensor  # scalar simulation start time
    imu_w: torch.Tensor  # [n_imu+1, 3] standard normals (SimDraws)
    imu_a: torch.Tensor  # [n_imu+1, 3]
    pix: torch.Tensor  # [n_frames, num_cams, num_pts, 2]


@dataclasses.dataclass
class ImuSample(TensorRecord):
    t: torch.Tensor  # [S] time relative to t_start
    wm: torch.Tensor  # [S, 3] measured angular velocity
    am: torch.Tensor  # [S, 3] measured specific force


@dataclasses.dataclass
class CamFrame(TensorRecord):
    t: torch.Tensor  # [K] frame time (IMU clock) relative to t_start
    ids: torch.Tensor  # [K, num_cams, num_pts] int32 feature ids (-1)
    uvs: torch.Tensor  # [K, num_cams, num_pts, 2] raw pixels
    uvs_norm: torch.Tensor  # [K, num_cams, num_pts, 2] normalized
    mask: torch.Tensor  # [K, num_cams, num_pts] validity


@dataclasses.dataclass
class PerturbedCalib(TensorRecord):
    """The estimator's starting calibration (the truth stays in SimData)."""

    cam_intr: torch.Tensor  # [N, 8]
    cam_R_ItoC: torch.Tensor  # [N, 3, 3]
    cam_p_IinC: torch.Tensor  # [N, 3]
    calib_dt: torch.Tensor  # scalar
    imu_dw: torch.Tensor  # [6]
    imu_da: torch.Tensor  # [6]
    imu_tg: torch.Tensor  # [9]
    imu_q_gyro: torch.Tensor  # [4] JPL gyro-frame rotation
    imu_q_acc: torch.Tensor  # [4] JPL accel-frame rotation (rpng model)


def n_imu_steps(params: SimParams) -> int:
    return int(round(params.duration * params.imu_rate))


def n_cam_frames(params: SimParams) -> int:
    return int(round(params.duration * params.cam_rate))


def imu_per_cam(params: SimParams) -> int:
    r = params.imu_rate / params.cam_rate
    if abs(r - round(r)) >= 1e-9:
        raise ValueError("imu_rate must be a multiple of cam_rate")
    return int(round(r))


def draw(params: SimParams, seed: int) -> SimDraws:
    """All random numbers of a run from numpy's PCG64(seed), as CPU
    tensors."""
    rng = np.random.Generator(np.random.PCG64(seed))
    M, n = params.map_size, n_imu_steps(params) + 1
    shape_pix = (n_cam_frames(params), params.num_cams, params.num_pts, 2)

    def uni(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32))

    def nrm(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    return SimDraws(
        map_t=uni(M),
        map_cam=torch.from_numpy(rng.integers(0, params.num_cams, M,
                                              dtype=np.int32)),
        map_uv=uni(M, 2), map_depth=uni(M),
        bias_g_inc=nrm(n, 3), bias_a_inc=nrm(n, 3),
        imu_w=nrm(n, 3), imu_a=nrm(n, 3), pix=nrm(*shape_pix))


def draw_calib(num_cams: int, seed: int) -> CalibDraws:
    """The standard normals of `perturb_calib` from numpy's PCG64(seed)."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def nrm(*shape):
        return torch.from_numpy(np.asarray(
            rng.standard_normal(shape, dtype=np.float32)))

    N = num_cams
    return CalibDraws(dt=nrm(), intr=nrm(N, 8), rot=nrm(N, 3), pos=nrm(N, 3),
                      imu_dw=nrm(6), imu_da=nrm(6), gyro_rot=nrm(3),
                      acc_rot=nrm(3), imu_tg=nrm(9))


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def default_calib(params: SimParams, device=None):
    """EuRoC-like calibration of num_cams cameras: (intr [N, 8],
    R_ItoC [N, 3, 3], p_IinC [N, 3])."""
    dev = resolve_device(device)
    intr = _f32([458.654, 457.296, 367.215, 248.375, -0.2834, 0.0739, 2e-4,
                 1.76e-5], dev).repeat(params.num_cams, 1)
    base = _f32([-1.2, 1.2, -1.2], dev)
    Rs = torch.stack([lie.exp_so3(base * (1.0 + 0.02 * i))
                      for i in range(params.num_cams)])
    ps = torch.stack([_f32([0.05 * i, -0.01, 0.02], dev)
                      for i in range(params.num_cams)])
    return intr, Rs, ps


def sine_trajectory(duration: float, dt: float = 0.1, device=None):
    """The default trajectory (a 3D sinusoid, like the rpng sim paths):
    (times [K], R_ItoG [K, 3, 3], p [K, 3])."""
    dev = resolve_device(device)
    n = int(duration / dt) + 8
    t = torch.arange(n, device=dev).to(torch.float32) * dt
    p = torch.stack([2.0 * torch.sin(0.6 * t), 2.0 * torch.cos(0.6 * t),
                     1.0 + 0.5 * torch.sin(0.9 * t)], dim=-1)
    yaw = 0.6 * t + 0.3 * torch.sin(0.5 * t)
    pitch = 0.2 * torch.sin(0.7 * t)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    Rz = torch.stack([torch.stack([cy, -sy, zero], -1),
                      torch.stack([sy, cy, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    Ry = torch.stack([torch.stack([cp, zero, sp], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sp, zero, cp], -1)], -2)
    return t, Rz @ Ry, p


def _uniform(u01, lo, hi):
    """jax.random.uniform's scaling of unit draws onto [lo, hi)."""
    return torch.maximum(lo, u01 * (hi - lo) + lo)


def _skip_until_motion(spline, params: SimParams, t_start, t_max):
    """Advance the start in camera periods until the accumulated path
    length exceeds distance_threshold (Simulator.cpp:80-109).  The start
    times are the reference's float32 running sums; their poses are
    evaluated in one batch."""
    cam_dt = np.float32(1.0 / params.cam_rate)
    ts = [np.float32(t_start)]
    while ts[-1] < t_max:
        ts.append(np.float32(ts[-1] + cam_dt))
    dev = spline.ctrl_p.device
    _, p = bspline.pose(spline, torch.as_tensor(np.asarray(ts), device=dev))
    steps = torch.linalg.vector_norm(p[1:] - p[:-1], dim=-1).cpu().tolist()
    dist, j = 0.0, 0
    while dist <= params.distance_threshold and ts[j] < t_max:
        dist += steps[j]
        j += 1
    return _f32(float(ts[j]), dev)


def build(params: SimParams, seed: int = 0, traj=None, calib=None,
          calib_dt: float = 0.0, draws: SimDraws | None = None,
          device=None) -> SimData:
    """The simulator on `device` (None = CUDA): spline, feature map, bias
    walks and noise.  `draws` defaults to `draw(params, seed)`; `traj` to
    the sine trajectory, `calib` to `default_calib`."""
    dev = resolve_device(device)
    if traj is None:
        traj = sine_trajectory(params.duration + 2.0 * params.start_offset
                               + 2.0, device=dev)
    times, Rs, ps = (x.to(dev) for x in traj)
    spline = bspline.fit(times, Rs, ps)
    if calib is None:
        calib = default_calib(params, dev)
    cam_intr, cam_R_ItoC, cam_p_IinC = (x.to(dev) for x in calib)
    if draws is None:
        draws = draw(params, seed)
    d = type(draws)(**{k: v.to(dev) for k, v in draws.items()})

    t_start = spline.t0 + params.start_offset
    if params.distance_threshold > 0.0:
        t0 = np.float32(spline.t0.item())
        span = float(np.float32(times[-1].item()) - np.float32(times[0].item()))
        t_max = np.float32(np.float32(np.float32(t0 + np.float32(span))
                                      - np.float32(params.duration))
                           - np.float32(1.0))
        t_start = _skip_until_motion(spline, params, t_start.item(), t_max)

    # the persistent feature map: camera poses sampled along the run, rays
    # cast through random pixels to random depths
    map_dur = (params.map_duration if params.map_duration > 0.0
               else params.duration)
    ts = _uniform(d.map_t, t_start, t_start + map_dur)
    ci = d.map_cam.long()
    uv = d.map_uv * _f32([params.width - 40.0, params.height - 40.0],
                         dev) + 20.0
    depth = _uniform(d.map_depth, _f32(params.min_depth, dev),
                     _f32(params.max_depth, dev))
    R_ItoG, p_IinG = bspline.pose(spline, ts)
    uvn = cameras.undistort(params.cam_model, cam_intr[ci], uv)
    ray_C = torch.cat([uvn, torch.ones_like(uvn[:, :1])], dim=-1) \
        * depth[:, None]
    p_in_I = (cam_R_ItoC[ci].mT @ (ray_C - cam_p_IinC[ci])[..., None])
    map_pts = p_IinG + (R_ItoG @ p_in_I)[..., 0]

    # true bias random walks: cumulative sums of discrete increments
    sqrt_dt = torch.sqrt(_f32(1.0 / params.imu_rate, dev))

    def walk(sigma, inc):
        inc = (_f32(sigma, dev) * sqrt_dt) * inc
        inc[0] = 0.0
        return torch.cumsum(inc, dim=0)

    return SimData(
        spline=spline, map_pts=map_pts, cam_intr=cam_intr,
        cam_R_ItoC=cam_R_ItoC, cam_p_IinC=cam_p_IinC,
        calib_dt=_f32(calib_dt, dev),
        bias_g_traj=walk(params.sigma_wb, d.bias_g_inc),
        bias_a_traj=walk(params.sigma_ab, d.bias_a_inc),
        gravity=_f32([0.0, 0.0, params.gravity_mag], dev),
        t_start=t_start, imu_w=d.imu_w, imu_a=d.imu_a, pix=d.pix)


def get_imu(sim: SimData, params: SimParams, steps) -> ImuSample:
    """Measured IMU samples at integer steps [S] (Simulator::get_next_imu,
    Simulator.cpp:311-390): spline-exact ω and a, plus bias, plus white
    noise of discrete std σ/√dt."""
    dt = 1.0 / params.imu_rate
    t = sim.t_start + steps.to(torch.float32) * dt
    w_true, a_true = bspline.imu_measurement(sim.spline, t, sim.gravity)
    root_dt = torch.sqrt(_f32(dt, t.device))
    nw = (_f32(params.sigma_w, t.device) / root_dt) * sim.imu_w[steps]
    na = (_f32(params.sigma_a, t.device) / root_dt) * sim.imu_a[steps]
    return ImuSample(t=t - sim.t_start, wm=w_true + sim.bias_g_traj[steps] + nw,
                     am=a_true + sim.bias_a_traj[steps] + na)


def get_cam(sim: SimData, params: SimParams, frames) -> CamFrame:
    """The persistent map projected into every camera at integer frames [K]
    (Simulator::get_next_cam + project_pointcloud, Simulator.cpp:391-500):
    points in front of the camera (depth > min_view_depth) and inside the
    image, the first num_pts of them by map index (so ids persist across
    frames), pixel noise added to the raw uv.  Frame times are stamped in
    the camera clock; the true IMU time is t_cam + calib_dt."""
    P, M = params.num_pts, sim.map_pts.shape[0]
    t_cam = sim.t_start + frames.to(torch.float32) / params.cam_rate
    R_ItoG, p_IinG = bspline.pose(sim.spline, t_cam + sim.calib_dt)
    p_I = (sim.map_pts[None] - p_IinG[:, None]) @ R_ItoG  # [K, M, 3]
    p_C = (p_I[:, None] @ sim.cam_R_ItoC.mT[None]
           + sim.cam_p_IinC[None, :, None])  # [K, C, M, 3]
    z = p_C[..., 2]
    zmin = params.min_view_depth
    safe_z = torch.where(z > zmin, z, 1.0)
    intr = sim.cam_intr[None, :, None]  # [1, C, 1, 8]
    uv = cameras.distort(params.cam_model, intr, p_C[..., :2] / safe_z[..., None])
    valid = ((z > zmin) & (uv[..., 0] > 0.0) & (uv[..., 0] < params.width)
             & (uv[..., 1] > 0.0) & (uv[..., 1] < params.height))
    # the first P valid map indices, then the first invalid ones: a
    # deterministic order (the keys are distinct)
    order = torch.arange(M, device=z.device)
    key = torch.where(valid, order, M + order)
    idx = torch.topk(key, P, dim=-1, largest=False, sorted=True).indices
    sel_valid = torch.gather(valid, -1, idx)
    uv_sel = torch.gather(uv, -2, idx[..., None].expand(idx.shape + (2,)))
    uv_meas = uv_sel + _f32(params.sigma_pix, z.device) * sim.pix[frames]
    return CamFrame(
        t=t_cam - sim.t_start,
        ids=torch.where(sel_valid, idx, -1).to(torch.int32),
        uvs=uv_meas,
        uvs_norm=cameras.undistort(params.cam_model, intr, uv_meas),
        mask=sel_valid)


def view_margins(sim: SimData, params: SimParams, frame: int, cam: int):
    """How far every map point is from flipping in or out of view at
    `frame` of camera `cam`, noise-free and in float64: (distance of its
    pixel to the image border [M] (inf behind the depth gate), distance of
    its depth to min_view_depth [M]).  An f32 rounding can flip a point
    whose margin is a rounding error wide."""
    sp = bspline.Bspline(**{k: v.double() for k, v in sim.spline.items()})
    t = (sim.t_start.double() + frame / params.cam_rate
         + sim.calib_dt.double())
    R, p = (x[0] for x in bspline.pose(sp, t[None]))
    p_C = ((sim.map_pts.double() - p) @ R) @ sim.cam_R_ItoC[cam].double().T \
        + sim.cam_p_IinC[cam].double()
    z = p_C[:, 2]
    zmin = params.min_view_depth
    uv = cameras.distort(params.cam_model, sim.cam_intr[cam].double(),
                         p_C[:, :2] / z[:, None])
    edge = torch.stack([uv[:, 0], params.width - uv[:, 0], uv[:, 1],
                        params.height - uv[:, 1]], -1).abs().min(-1).values
    return torch.where(z > zmin, edge, torch.inf), (z - zmin).abs()


def get_true_bias(sim: SimData, params: SimParams, t_rel):
    """True (bg, ba) at the IMU step nearest to the relative times t_rel."""
    step = torch.clamp(torch.round(t_rel * params.imu_rate).to(torch.int64),
                       0, sim.bias_g_traj.shape[0] - 1)
    return sim.bias_g_traj[step], sim.bias_a_traj[step]


def get_state(sim: SimData, params: SimParams, t_rel):
    """Groundtruth at relative times t_rel [...] (Simulator::get_state,
    Simulator.cpp:267-310): (q_GtoI (JPL), p_IinG, v_IinG, bg, ba)."""
    t = sim.t_start + t_rel
    R_ItoG, p = bspline.pose(sim.spline, t)
    _, v = bspline.velocity(sim.spline, t)
    bg, ba = get_true_bias(sim, params, t_rel)
    return lie.rot_2_quat(R_ItoG.mT), p, v, bg, ba


def perturb_calib(seed: int, calib, calib_dt=0.0, imu_intrinsics=False,
                  g_sensitivity=False, imu_model="kalibr",
                  draws: CalibDraws | None = None,
                  device=None) -> PerturbedCalib:
    """A Gaussian perturbation of the calibration the estimator starts from
    (Simulator::perturb_parameters, Simulator.cpp:209-265, with its scales):
    dt 0.01 s, focal and center 1.0 px, distortion 0.005, extrinsic rotation
    0.001 rad and position 0.01 m, Dw/Da 0.004, Tg 0.004, sensor-frame
    rotations 0.002 rad.  `draws` defaults to `draw_calib(N, seed)`."""
    dev = resolve_device(device)
    cam_intr, cam_R_ItoC, cam_p_IinC = (x.to(dev) for x in calib)
    N = cam_intr.shape[0]
    if draws is None:
        draws = draw_calib(N, seed)
    d = type(draws)(**{k: v.to(dev) for k, v in draws.items()})
    dt = _f32(calib_dt, dev) + 0.01 * d.dt
    scale = torch.cat([torch.ones((N, 4), device=dev),
                       0.005 * torch.ones((N, 4), device=dev)], dim=1)
    intr = cam_intr + scale * d.intr
    R = lie.exp_so3(0.001 * d.rot) @ cam_R_ItoC
    p = cam_p_IinC + 0.01 * d.pos
    ident6 = ([1.0, 0.0, 1.0, 0.0, 0.0, 1.0] if imu_model == "rpng"
              else [1.0, 0.0, 0.0, 1.0, 0.0, 1.0])
    dw, da = _f32(ident6, dev), _f32(ident6, dev)
    tg = torch.zeros(9, device=dev)
    q_gyro = q_acc = _f32([0.0, 0.0, 0.0, 1.0], dev)
    if imu_intrinsics:
        dw = dw + 0.004 * d.imu_dw
        da = da + 0.004 * d.imu_da
        q_gyro = lie.rot_2_quat(lie.exp_so3(0.002 * d.gyro_rot))
        q_acc = lie.rot_2_quat(lie.exp_so3(0.002 * d.acc_rot))
    if g_sensitivity:
        tg = tg + 0.004 * d.imu_tg
    return PerturbedCalib(cam_intr=intr, cam_R_ItoC=R, cam_p_IinC=p,
                          calib_dt=dt, imu_dw=dw, imu_da=da, imu_tg=tg,
                          imu_q_gyro=q_gyro, imu_q_acc=q_acc)
