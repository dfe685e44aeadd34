"""The benchmark's input generator: B simulated visual-inertial streams at
once, every random number drawn on the device from the run's seed.

A frozen copy of the port's simulator (`sim/simulator.build`, `get_imu`,
`get_cam`, `get_state` and `models/runner.stage_run`), rewritten batched
over streams.  Every stream flies the same sine trajectory
(`sine_trajectory`), so the spline, the IMU's true signal and the
groundtruth are computed once; the streams differ in their draws: the persistent feature map, the bias
random walks, the IMU white noise and the pixel noise.  The arithmetic of
one stream is the port's, operation for operation, so that stream b equals
the port's staging of the same draws (`vio_bench/tests/test_gen.py`).

Streams are made in chunks of `chunk` streams, each chunk from its own
`torch.Generator` seeded by (seed, chunk index), so that the
[frames, map, 3] projection stays small.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vio_bench.plain import bspline, cameras, lie

# the port's SimParams defaults (sim/simulator.py)
SIM_DEFAULTS = dict(
    imu_rate=200.0, cam_rate=20.0, num_cams=1, num_pts=100, map_size=4096,
    sigma_w=1.6968e-4, sigma_wb=1.9393e-5, sigma_a=2.0e-3, sigma_ab=3.0e-3,
    sigma_pix=1.0, gravity_mag=9.81, min_depth=5.0, max_depth=10.0,
    width=752, height=480, cam_model=cameras.RADTAN, duration=60.0,
    start_offset=2.0, min_view_depth=0.1, trajectory="sine")


@dataclass
class Sim:
    """Simulator settings: the port's SimParams fields this generator
    uses (no distance threshold, map over the whole run), and the
    trajectory, which is the port's sine trajectory: no trajectory file
    is read."""

    imu_rate: float
    cam_rate: float
    num_cams: int
    num_pts: int
    map_size: int
    sigma_w: float
    sigma_wb: float
    sigma_a: float
    sigma_ab: float
    sigma_pix: float
    gravity_mag: float
    min_depth: float
    max_depth: float
    width: int
    height: int
    cam_model: str
    duration: float
    start_offset: float
    min_view_depth: float
    trajectory: str

    @classmethod
    def from_dict(cls, d):
        unknown = set(d) - set(SIM_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown simulator keys {sorted(unknown)}")
        if d.get("trajectory", "sine") != "sine":
            raise ValueError("the generator flies the sine trajectory only")
        return cls(**{**SIM_DEFAULTS, **d})

    @property
    def n_imu(self) -> int:
        return int(round(self.duration * self.imu_rate))

    @property
    def n_frames(self) -> int:
        return int(round(self.duration * self.cam_rate))

    @property
    def ipc(self) -> int:
        r = self.imu_rate / self.cam_rate
        if abs(r - round(r)) >= 1e-9:
            raise ValueError("imu_rate must be a multiple of cam_rate")
        return int(round(r))


@dataclass
class Draws:
    """Every random number of B streams, as unit draws ([B, ...])."""

    map_t: torch.Tensor  # [B, M] uniform
    map_cam: torch.Tensor  # [B, M] int32 in [0, num_cams)
    map_uv: torch.Tensor  # [B, M, 2] uniform
    map_depth: torch.Tensor  # [B, M] uniform
    bias_g_inc: torch.Tensor  # [B, n_imu+1, 3] normal
    bias_a_inc: torch.Tensor  # [B, n_imu+1, 3] normal
    imu_w: torch.Tensor  # [B, n_imu+1, 3] normal
    imu_a: torch.Tensor  # [B, n_imu+1, 3] normal
    pix: torch.Tensor  # [B, n_frames, num_cams, num_pts, 2] normal


@dataclass
class Streams:
    """B staged streams: what `runner.stage_run` and `runner.sim_calib`
    give per stream, stacked over streams (fields shared by every stream
    are expanded, not copied).  Frame k of the filter is staged frame k+1:
    its IMU window covers steps [k·ipc, (k+1)·ipc]."""

    win_t: torch.Tensor  # [B, K, ipc+1]
    win_w: torch.Tensor  # [B, K, ipc+1, 3]
    win_a: torch.Tensor  # [B, K, ipc+1, 3]
    t_new: torch.Tensor  # [B, K]
    ids: torch.Tensor  # [B, K, N, P] int32
    uv: torch.Tensor  # [B, K, N, P, 2]
    uvn: torch.Tensor  # [B, K, N, P, 2]
    mask: torch.Tensor  # [B, K, N, P] bool
    gt_q: torch.Tensor  # [B, K+1, 4] JPL q_GtoI at every camera time
    gt_p: torch.Tensor  # [B, K+1, 3]
    gt_v: torch.Tensor  # [B, K+1, 3]
    bias_g0: torch.Tensor  # [B, 3]
    bias_a0: torch.Tensor  # [B, 3]
    cam_R_ItoC: torch.Tensor  # [B, N, 3, 3]
    cam_p_IinC: torch.Tensor  # [B, N, 3]
    cam_intr: torch.Tensor  # [B, N, 8]

    @property
    def n_streams(self) -> int:
        return self.ids.shape[0]

    @property
    def n_frames(self) -> int:
        return self.ids.shape[1]


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def default_calib(sim: Sim, dev):
    """The port's EuRoC-like calibration (`simulator.default_calib`)."""
    intr = _f32([458.654, 457.296, 367.215, 248.375, -0.2834, 0.0739, 2e-4,
                 1.76e-5], dev).repeat(sim.num_cams, 1)
    base = _f32([-1.2, 1.2, -1.2], dev)
    Rs = torch.stack([lie.exp_so3(base * (1.0 + 0.02 * i))
                      for i in range(sim.num_cams)])
    ps = torch.stack([_f32([0.05 * i, -0.01, 0.02], dev)
                      for i in range(sim.num_cams)])
    return intr, Rs, ps


def sine_trajectory(duration: float, dev, dt: float = 0.1):
    """The port's default trajectory (`simulator.sine_trajectory`)."""
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


def draw(sim: Sim, B: int, gen: torch.Generator, dev) -> Draws:
    """B streams' unit draws from `gen`, in a few large calls on `dev`."""
    M, n = sim.map_size, sim.n_imu + 1
    kw = dict(generator=gen, device=dev, dtype=torch.float32)
    return Draws(
        map_t=torch.rand((B, M), **kw),
        map_cam=torch.randint(0, sim.num_cams, (B, M), generator=gen,
                              device=dev, dtype=torch.int32),
        map_uv=torch.rand((B, M, 2), **kw),
        map_depth=torch.rand((B, M), **kw),
        bias_g_inc=torch.randn((B, n, 3), **kw),
        bias_a_inc=torch.randn((B, n, 3), **kw),
        imu_w=torch.randn((B, n, 3), **kw),
        imu_a=torch.randn((B, n, 3), **kw),
        pix=torch.randn((B, sim.n_frames, sim.num_cams, sim.num_pts, 2),
                        **kw))


def _uniform(u01, lo, hi):
    return torch.maximum(lo, u01 * (hi - lo) + lo)


class Generator:
    """What every stream shares (spline, calibration, true IMU signal,
    groundtruth), and `stage(draws)` for the rest."""

    def __init__(self, sim: Sim, dev):
        self.sim, self.dev = sim, dev
        times, Rs, ps = sine_trajectory(
            sim.duration + 2.0 * sim.start_offset + 2.0, dev)
        self.spline = bspline.fit(times, Rs, ps)
        self.intr, self.R_ItoC, self.p_IinC = default_calib(sim, dev)
        self.gravity = _f32([0.0, 0.0, sim.gravity_mag], dev)
        self.t_start = self.spline.t0 + sim.start_offset
        # the true IMU signal at every IMU step (get_imu's shared part)
        dt = 1.0 / sim.imu_rate
        steps = torch.arange(sim.n_imu + 1, device=dev)
        t = self.t_start + steps.to(torch.float32) * dt
        self.w_true, self.a_true = bspline.imu_measurement(self.spline, t,
                                                           self.gravity)
        self.imu_t = t - self.t_start
        # the camera poses of every frame (calib_dt = 0) and groundtruth
        frames = torch.arange(sim.n_frames, device=dev)
        t_cam = self.t_start + frames.to(torch.float32) / sim.cam_rate
        self.cam_R_ItoG, self.cam_p_IinG = bspline.pose(self.spline,
                                                        t_cam + 0.0)
        self.cam_t = t_cam - self.t_start
        tg = self.t_start + self.cam_t
        R_ItoG, p = bspline.pose(self.spline, tg)
        _, v = bspline.velocity(self.spline, tg)
        self.gt_q, self.gt_p, self.gt_v = lie.rot_2_quat(R_ItoG.mT), p, v

    def stage(self, d: Draws) -> Streams:
        """The streams of one batch of draws (`simulator.build` +
        `runner.stage_run` per stream)."""
        sim, dev = self.sim, self.dev
        B = d.map_t.shape[0]
        map_pts = self._map(d)
        sqrt_dt = torch.sqrt(_f32(1.0 / sim.imu_rate, dev))

        def walk(sigma, inc):
            inc = (_f32(sigma, dev) * sqrt_dt) * inc
            inc[:, 0] = 0.0
            return torch.cumsum(inc, dim=1)

        bias_g = walk(sim.sigma_wb, d.bias_g_inc)
        bias_a = walk(sim.sigma_ab, d.bias_a_inc)
        root_dt = torch.sqrt(_f32(1.0 / sim.imu_rate, dev))
        nw = (_f32(sim.sigma_w, dev) / root_dt) * d.imu_w
        na = (_f32(sim.sigma_a, dev) / root_dt) * d.imu_a
        wm = self.w_true + bias_g + nw
        am = self.a_true + bias_a + na

        ids, uvs, uvn, mask = self._cams(map_pts, d.pix)
        K, ipc = sim.n_frames, sim.ipc
        win = ((torch.arange(1, K, device=dev)[:, None] - 1) * ipc
               + torch.arange(ipc + 1, device=dev)[None, :])  # [K-1, ipc+1]

        def shared(x):
            return x.expand((B,) + x.shape)

        return Streams(
            win_t=shared(self.imu_t[win]), win_w=wm[:, win], win_a=am[:, win],
            t_new=shared(self.cam_t[1:]), ids=ids[:, 1:], uv=uvs[:, 1:],
            uvn=uvn[:, 1:], mask=mask[:, 1:],
            gt_q=shared(self.gt_q), gt_p=shared(self.gt_p),
            gt_v=shared(self.gt_v),
            bias_g0=bias_g[:, 0], bias_a0=bias_a[:, 0],
            cam_R_ItoC=shared(self.R_ItoC), cam_p_IinC=shared(self.p_IinC),
            cam_intr=shared(self.intr))

    def _map(self, d: Draws):
        """The persistent feature map [B, M, 3] (simulator.build)."""
        sim, dev = self.sim, self.dev
        ts = _uniform(d.map_t, self.t_start, self.t_start + sim.duration)
        ci = d.map_cam.long()
        uv = d.map_uv * _f32([sim.width - 40.0, sim.height - 40.0], dev) \
            + 20.0
        depth = _uniform(d.map_depth, _f32(sim.min_depth, dev),
                         _f32(sim.max_depth, dev))
        R_ItoG, p_IinG = bspline.pose(self.spline, ts)
        uvn = cameras.undistort(sim.cam_model, self.intr[ci], uv)
        ray_C = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1) \
            * depth[..., None]
        p_in_I = (self.R_ItoC[ci].mT
                  @ (ray_C - self.p_IinC[ci])[..., None])
        return p_IinG + (R_ItoG @ p_in_I)[..., 0]

    def _cams(self, map_pts, pix):
        """Every frame's measurements (simulator.get_cam) of every stream:
        (ids, uvs, uvs_norm, mask), each [B, K, N, P, ...]."""
        sim = self.sim
        P, M = sim.num_pts, map_pts.shape[1]
        p_I = (map_pts[:, None] - self.cam_p_IinG[None, :, None]) \
            @ self.cam_R_ItoG[None]  # [B, K, M, 3]
        p_C = (p_I[:, :, None] @ self.R_ItoC.mT[None, None]
               + self.p_IinC[None, None, :, None])  # [B, K, N, M, 3]
        del p_I
        z = p_C[..., 2]
        zmin = sim.min_view_depth
        safe_z = torch.where(z > zmin, z, 1.0)
        intr = self.intr[None, :, None]
        uv = cameras.distort(sim.cam_model, intr,
                             p_C[..., :2] / safe_z[..., None])
        del p_C, safe_z
        valid = ((z > zmin) & (uv[..., 0] > 0.0) & (uv[..., 0] < sim.width)
                 & (uv[..., 1] > 0.0) & (uv[..., 1] < sim.height))
        order = torch.arange(M, device=z.device)
        key = torch.where(valid, order, M + order)
        idx = torch.topk(key, P, dim=-1, largest=False, sorted=True).indices
        sel_valid = torch.gather(valid, -1, idx)
        uv_sel = torch.gather(uv, -2, idx[..., None].expand(idx.shape + (2,)))
        uv_meas = uv_sel + _f32(sim.sigma_pix, z.device) * pix
        return (torch.where(sel_valid, idx, -1).to(torch.int32), uv_meas,
                cameras.undistort(sim.cam_model, intr, uv_meas), sel_valid)


def chunk_seed(seed: int, chunk: int) -> int:
    """The generator seed of one chunk of streams: distinct per (seed,
    chunk), any seed up to 2**62."""
    return (int(seed) * 1_000_003 + chunk) % (2 ** 63 - 1)


def make_streams(sim: Sim, n_streams: int, seed: int, dev,
                 chunk: int = 32) -> Streams:
    """`n_streams` streams from `seed`, generated `chunk` streams at a
    time into preallocated [n_streams, ...] tensors (shared fields stay
    expanded)."""
    g = Generator(sim, dev)
    out = None
    for c in range(math.ceil(n_streams / chunk)):
        lo = c * chunk
        B = min(chunk, n_streams - lo)
        gen = torch.Generator(device=dev)
        gen.manual_seed(chunk_seed(seed, c))
        part = g.stage(draw(sim, B, gen, dev))
        if out is None:
            out = {}
            for f in Streams.__dataclass_fields__:
                x = getattr(part, f)
                out[f] = (x[:1].expand((n_streams,) + x.shape[1:])
                          if x.stride(0) == 0 else
                          x.new_empty((n_streams,) + x.shape[1:]))
        for f, x in out.items():
            if x.stride(0) != 0:
                x[lo:lo + B] = getattr(part, f)
        del part
    return Streams(**out)
