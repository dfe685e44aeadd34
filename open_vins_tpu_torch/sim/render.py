"""Rendered camera images: the simulator's persistent map splatted as
Gaussian sprites, so that the real KLT front end can run in closed loop.

Counterpart of `open_vins_tpu/sim/render.py`.  Every map point becomes a
sprite of deterministic brightness at its true (noise-free) projection, so
a perfect tracker reproduces the noise-free measurement stream.  A
Gaussian sprite is separable, so a frame is one product
gy.T @ (amp · gx) with gy [M, H] and gx [M, W] (f32, TF32 off).  `render`
draws any number of frames and cameras as one batched product.
"""

from __future__ import annotations

import math

import torch

from open_vins_tpu_torch.ops import cameras
from open_vins_tpu_torch.sim import bspline, simulator


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def render(sim: simulator.SimData, params: simulator.SimParams, frames,
           cams=None, gain=1.0, offset=0.0, blob_sigma=1.7, background=0.08):
    """Images [K, C, H, W] of integer frames [K] and cameras `cams` (a
    list; None = every camera), float32 in about [0, 1].  `gain` and
    `offset` model an illumination change."""
    dev = sim.map_pts.device
    frames = torch.as_tensor(frames, device=dev)
    cams = list(range(params.num_cams)) if cams is None else list(cams)
    t_cam = sim.t_start + frames.to(torch.float32) / params.cam_rate
    R_ItoG, p_IinG = bspline.pose(sim.spline, t_cam + sim.calib_dt)
    p_I = (sim.map_pts[None] - p_IinG[:, None]) @ R_ItoG  # [K, M, 3]
    R_ItoC = sim.cam_R_ItoC[cams]
    p_C = p_I[:, None] @ R_ItoC.mT[None] + sim.cam_p_IinC[cams][None, :,
                                                                 None]
    z = p_C[..., 2]  # [K, C, M]
    safe_z = torch.where(z > 0.1, z, 1.0)
    uv = cameras.distort(params.cam_model, sim.cam_intr[cams][None, :, None],
                         p_C[..., :2] / safe_z[..., None])
    m = 2.0  # a sprite must fit inside the frame to be a clean corner
    valid = ((z > 0.1) & (uv[..., 0] > m) & (uv[..., 0] < params.width - m)
             & (uv[..., 1] > m) & (uv[..., 1] < params.height - m))

    M = sim.map_pts.shape[0]
    # per-feature brightness from a golden-ratio hash: the same in every
    # frame and both stereo eyes
    amp = 0.45 + 0.55 * torch.remainder(
        torch.arange(M, device=dev).to(torch.float32) * 0.6180339887, 1.0)
    amp = torch.where(valid, amp, 0.0)

    xs = torch.arange(params.width, device=dev).to(torch.float32)
    ys = torch.arange(params.height, device=dev).to(torch.float32)
    sigma = _f32(blob_sigma, dev)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    gx = torch.exp(-(xs - uv[..., 0:1]) ** 2 * inv2s2)  # [K, C, M, W]
    gy = torch.exp(-(ys - uv[..., 1:2]) ** 2 * inv2s2)  # [K, C, M, H]
    img = gy.mT @ (amp[..., None] * gx)  # [K, C, H, W]

    # a smooth low background keeps equalization well conditioned without
    # adding trackable corners
    bg = _f32(background, dev) * (
        0.5 + 0.25 * torch.sin(xs[None, :] * (2.0 * math.pi / params.width))
        + 0.25 * torch.cos(ys[:, None] * (2.0 * math.pi / params.height)))
    img = torch.clamp(img + bg, 0.0, 1.5)
    return torch.clamp(_f32(gain, dev) * img + _f32(offset, dev), 0.0, 2.0)


def render_frame(sim: simulator.SimData, params: simulator.SimParams, frame,
                 cam: int = 0, gain=1.0, offset=0.0, blob_sigma=1.7,
                 background=0.08):
    """One camera frame [H, W] at an integer frame index."""
    return render(sim, params, [frame], [cam], gain=gain, offset=offset,
                  blob_sigma=blob_sigma, background=background)[0, 0]


def render_run(sim: simulator.SimData, params: simulator.SimParams,
               cam: int = 0, gain=1.0, offset=0.0):
    """Every frame of the run of one camera, [n_frames, H, W], as one
    batched call."""
    frames = torch.arange(simulator.n_cam_frames(params),
                          device=sim.map_pts.device)
    return render(sim, params, frames, [cam], gain=gain, offset=offset)[:, 0]
