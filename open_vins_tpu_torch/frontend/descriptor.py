"""Descriptor-based feature tracking.

Counterpart of `open_vins_tpu/frontend/descriptor.py`
(ov_core::TrackDescriptor: grid detection, descriptors, the knn ratio test
robust_ratio_test:538, the symmetry test :554 and RANSAC).  The descriptor
is an ORB-steered, normalized 16x16 intensity patch: sampled on a lattice
rotated to the keypoint's intensity-centroid orientation (cv::ORB's
IC_Angle).  Matching is one [N, 256] x [256, N] product, then the ratio,
score and mutual-consistency masks.  The reference's per-feature `vmap`s
are batched bilinear samples here.

Id inheritance scatters only the matched rows (the mutual test makes their
targets unique); the reference scatters every row with -1 for the
unmatched ones, which can overwrite an inherited id where an unmatched
row's best match collides with a matched row's.
"""

from __future__ import annotations

import dataclasses

import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.frontend import klt, ransac
from open_vins_tpu_torch.ops import cameras

PATCH = 16  # descriptor patch side
DESC_DIM = PATCH * PATCH
ORI_RADIUS = 7  # intensity-centroid disc radius


def _offsets(lo, hi, dtype, device, shift=0.0, scale=1.0):
    offs = (torch.arange(lo, hi, device=device).to(dtype) + shift) * scale
    return torch.meshgrid(offs, offs, indexing="ij")


def patch_orientation(img, pts, mask, radius=ORI_RADIUS):
    """Keypoint orientations [N] by intensity centroid (cv::ORB IC_Angle):
    θ = atan2(m01, m10) of the patch mass over a disc; 0 where mask is
    False."""
    oy, ox = _offsets(-radius, radius + 1, img.dtype, img.device)
    disc = ((ox ** 2 + oy ** 2) <= radius ** 2).to(img.dtype)
    patch = klt._bilinear(img, pts[:, 1, None, None] + oy,
                          pts[:, 0, None, None] + ox) * disc
    m10 = torch.sum(patch * ox, dim=(1, 2))
    m01 = torch.sum(patch * oy, dim=(1, 2))
    return torch.atan2(m01, m10) * mask.to(img.dtype)


def extract(img, pts, mask, steered=True, scale=1.0):
    """Steered normalized-patch descriptors at pts [N, 2] -> [N, 256]: the
    16x16 lattice rotated to each keypoint's orientation and scaled by
    `scale`; zero rows where mask is False (they never match)."""
    half = PATCH // 2
    oy, ox = _offsets(-half, half, img.dtype, img.device, 0.5, scale)
    if steered:
        theta = patch_orientation(img, pts, mask)
    else:
        theta = torch.zeros((pts.shape[0],), dtype=img.dtype,
                            device=img.device)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    rx = c * ox - s * oy
    ry = s * ox + c * oy
    v = klt._bilinear(img, pts[:, 1, None, None] + ry,
                      pts[:, 0, None, None] + rx).reshape(pts.shape[0], -1)
    v = v - torch.mean(v, dim=1, keepdim=True)
    n = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    v = v / torch.clamp(n, min=1e-6)
    return v * mask.to(img.dtype)[:, None]


def match(desc0, desc1, mask0, mask1, ratio=0.85, min_score=0.5):
    """NCC matching with the ratio and symmetry tests
    (robust_match / robust_ratio_test / robust_symmetry_test,
    TrackDescriptor.cpp:480-575).  Returns (idx1_for_0 [N0],
    matched [N0])."""
    S = desc0 @ desc1.T
    S = torch.where(mask0[:, None] & mask1[None, :], S,
                    torch.full_like(S, -2.0))
    best1 = torch.argmax(S, dim=1)
    s_sorted = torch.topk(S, 2, dim=1).values
    ratio_ok = s_sorted[:, 1] < ratio * s_sorted[:, 0]
    score_ok = s_sorted[:, 0] > min_score
    best0 = torch.argmax(S, dim=0)
    mutual = best0[best1] == torch.arange(desc0.shape[0], device=S.device)
    return best1, mask0 & score_ok & ratio_ok & mutual


@dataclasses.dataclass
class DescTrackerState(TensorRecord):
    prev_desc: torch.Tensor  # [P, 256]
    prev_pts: torch.Tensor  # [P, 2]
    ids: torch.Tensor  # [P] int32
    valid: torch.Tensor  # [P] bool
    next_id: torch.Tensor  # [] int32


def init_tracker(num_pts, device=None):
    """An empty descriptor tracker on `device` (None = CUDA)."""
    dev = resolve_device(device)
    return DescTrackerState(
        prev_desc=torch.zeros((num_pts, DESC_DIM), dtype=torch.float32,
                              device=dev),
        prev_pts=torch.zeros((num_pts, 2), dtype=torch.float32, device=dev),
        ids=torch.full((num_pts,), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((num_pts,), dtype=torch.bool, device=dev),
        next_id=torch.tensor(0, dtype=torch.int32, device=dev))


def inherit_ids(ids_prev, idx1, matched, n_cur):
    """Ids [n_cur] of the current detections: ids_prev[i] at idx1[i] for
    every matched row i, -1 elsewhere.  Only matched rows are written
    (their targets are unique); the rest land in a spare slot."""
    target = torch.where(matched, idx1, n_cur)
    out = torch.full((n_cur + 1,), -1, dtype=torch.int32,
                     device=ids_prev.device)
    out[target] = torch.where(matched, ids_prev, -1).to(torch.int32)
    return out[:n_cur]


def track_frame(state: DescTrackerState, img, zeta, params: klt.KltParams,
                sets_of, cam_model="radtan", first_frame: bool = False):
    """Detect-and-match tracking (TrackDescriptor::feed_monocular).
    `sets_of`: mask -> RANSAC sets (`ransac.sampler`).  Returns (new_state,
    ids, uv, uvn, mask) in FrameInput layout."""
    P = state.prev_pts.shape[0]
    img = klt.equalize(img)
    pts, det_ok = klt.detect_grid(
        img, torch.zeros((1, 2), dtype=img.dtype, device=img.device),
        torch.zeros((1,), dtype=torch.bool, device=img.device), params, P)
    desc = extract(img, pts, det_ok)

    idx1, matched = match(state.prev_desc, desc, state.valid, det_ok)
    if first_frame:
        matched = torch.zeros_like(matched)

    uvn0 = cameras.undistort(cam_model, zeta, state.prev_pts)
    uvn1_all = cameras.undistort(cam_model, zeta, pts)
    uvn1 = uvn1_all[idx1]
    max_f = torch.maximum(zeta[0], zeta[1])
    inl, _ = ransac.ransac_from_sets(uvn0, uvn1, matched, sets_of(matched),
                                     thresh=2.0 / max_f)
    matched = matched & inl

    ids_cur = inherit_ids(state.ids, idx1, matched, P)
    is_new = det_ok & (ids_cur < 0)
    n_new_before = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
    ids_cur = torch.where(is_new, state.next_id + n_new_before,
                          ids_cur).to(torch.int32)
    next_id = (state.next_id + torch.sum(is_new.to(torch.int32))).to(
        torch.int32)
    valid_cur = det_ok & (ids_cur >= 0)
    new_state = DescTrackerState(prev_desc=desc, prev_pts=pts, ids=ids_cur,
                                 valid=valid_cur, next_id=next_id)
    return new_state, ids_cur, pts, uvn1_all, valid_cur
