"""The image feature tracker: the TrackKLT orchestration layer.

Counterpart of `open_vins_tpu/frontend/tracker.py`
(TrackKLT::feed_new_camera / feed_monocular, TrackKLT.cpp:34-201,
395-529).  Per camera the state is the previous image, the tracked points
and their ids; one frame is
    equalize → pyramidal LK from the previous frame → in-bound and quality
    masks → fundamental-matrix RANSAC → grid re-detection into the free
    slots → fresh ids,
and the output is the fixed-shape (ids, uv, uvn, mask) packet of
`models.manager.FrameInput` (the TrackSIM contract).  `track_frame_multi`
adds N cameras: cam 0 is the temporal master and every other camera is
joined to it by a master → cam_i KLT pass with its own RANSAC, sharing the
master's ids (`track_frame_stereo` is N = 2).

Where the reference splits a PRNG key held in its state, the RANSAC sets
here come from `sets_of`, a function mask [N] -> [K, 8] that the caller
passes (`ransac.sampler` of a seeded `torch.Generator`); one call per
RANSAC, in the reference's order.  `first_frame` is a Python bool.
"""

from __future__ import annotations

import dataclasses

import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.frontend import klt, ransac
from open_vins_tpu_torch.ops import cameras


@dataclasses.dataclass
class TrackerState(TensorRecord):
    prev_img: torch.Tensor  # [H, W]
    pts: torch.Tensor  # [P, 2] current pixel positions
    ids: torch.Tensor  # [P] int32 (-1 = empty slot)
    valid: torch.Tensor  # [P] bool
    next_id: torch.Tensor  # [] int32


def init_tracker(height, width, num_pts, num_aruco_tags=0, device=None):
    """An empty tracker on `device` (None = CUDA).  `num_aruco_tags`
    reserves ids [0, 4·tags] for aruco tag corners; natural features start
    above (TrackBase.h:117, `currid = 4*max_aruco + 1`)."""
    dev = resolve_device(device)
    return TrackerState(
        prev_img=torch.zeros((height, width), dtype=torch.float32,
                             device=dev),
        pts=torch.zeros((num_pts, 2), dtype=torch.float32, device=dev),
        ids=torch.full((num_pts,), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((num_pts,), dtype=torch.bool, device=dev),
        next_id=torch.tensor(4 * num_aruco_tags + 1 if num_aruco_tags > 0
                             else 0, dtype=torch.int32, device=dev))


def _mask_at(det_mask, pts):
    """det_mask [H, W] at the pixels nearest to pts [N, 2]."""
    H, W = det_mask.shape
    iy = torch.clamp(torch.round(pts[:, 1]).to(torch.int64), 0, H - 1)
    ix = torch.clamp(torch.round(pts[:, 0]).to(torch.int64), 0, W - 1)
    return det_mask[iy, ix]


def _fill_free(ok, pts1, ids, next_id, new_pts, new_ok):
    """The reference's slot placement (tracker.py:101-116): the r-th free
    slot's index, used as a detection index, fills the slot of rank r
    wherever that detection is good; fresh ids count up in slot order.
    Returns (pts, ids, valid, next_id)."""
    T = ok.shape[0]
    free = ~ok
    free_rank = torch.cumsum(free.to(torch.int32), dim=0) - 1
    # det_for_slot[r] = index of the free slot of rank r (T where none);
    # the ranks of free slots are unique, the dropped writes land in [T]
    target = torch.where(free, free_rank.to(torch.int64), T)
    det_for_slot = torch.full((T + 1,), T, dtype=torch.int64,
                              device=ok.device)
    det_for_slot[target] = torch.arange(T, device=ok.device)
    det_for_slot = det_for_slot[:T]
    det_idx = torch.clamp(det_for_slot, 0, T - 1)
    take_det = free & (det_for_slot < T) & new_ok[det_idx]
    pts_out = torch.where(take_det[:, None], new_pts[det_idx], pts1)
    n_new_before = torch.cumsum(take_det.to(torch.int32), dim=0) - 1
    ids_out = torch.where(take_det, next_id + n_new_before, ids)
    valid_out = ok | take_det
    ids_out = torch.where(valid_out, ids_out, -1).to(torch.int32)
    next_id = (next_id + torch.sum(take_det.to(torch.int32))).to(torch.int32)
    return pts_out, ids_out, valid_out, next_id


def track_frame(state: TrackerState, img, zeta, params: klt.KltParams,
                sets_of, cam_model: str = "radtan", first_frame: bool = False,
                hist_method: str = "STRETCH", det_mask=None):
    """One frame of one camera.  Returns (new_state, ids, uv, uvn, mask).

    `sets_of`: mask [P] -> RANSAC sets [K, 8] (`ransac.sampler`).
    `first_frame`: skip tracking, only detect.  `hist_method`: NONE |
    HISTOGRAM | CLAHE | STRETCH (TrackKLT.cpp:56-75).  `det_mask`: optional
    [H, W] bool, True = usable (TrackBase.h:97-104 `use_mask`): features
    are neither detected nor kept where it is False."""
    P = state.pts.shape[0]
    img = klt.equalize_method(img, hist_method)

    pts1, ok = klt.track(state.prev_img, img, state.pts, params)
    ok = ok & state.valid
    if first_frame:
        ok = torch.zeros_like(ok)
    if det_mask is not None:
        ok = ok & _mask_at(det_mask, pts1)

    # RANSAC on undistorted normalized coordinates (TrackKLT.cpp:829-886)
    uvn0 = cameras.undistort(cam_model, zeta, state.pts)
    uvn1 = cameras.undistort(cam_model, zeta, pts1)
    max_f = torch.maximum(zeta[0], zeta[1])
    inliers, _ = ransac.ransac_from_sets(uvn0, uvn1, ok, sets_of(ok),
                                         thresh=2.0 / max_f)
    ok = ok & inliers

    # re-detect into the free slots (grid + occupancy dedup)
    new_pts, new_ok = klt.detect_grid(img, pts1, ok, params, P)
    if det_mask is not None:
        new_ok = new_ok & _mask_at(det_mask, new_pts)
    pts_out, ids_out, valid_out, next_id = _fill_free(
        ok, pts1, state.ids, state.next_id, new_pts, new_ok)
    uvn_out = cameras.undistort(cam_model, zeta, pts_out)
    new_state = TrackerState(prev_img=img, pts=pts_out, ids=ids_out,
                             valid=valid_out, next_id=next_id)
    return new_state, ids_out, pts_out, uvn_out, valid_out


def track_frame_multi(state: TrackerState, imgs, zetas,
                      params: klt.KltParams, sets_of,
                      cam_model: str = "radtan", first_frame: bool = False,
                      hist_method: str = "STRETCH", det_mask=None):
    """N cameras (TrackKLT::feed_new_camera's per-pair loop,
    TrackKLT.cpp:80-93, and feed_stereo:202-393): cam 0 is tracked in time
    by `track_frame`; every other camera gets a master → cam_i KLT pass on
    the current frame and its own RANSAC, and shares the master's ids.

    imgs [N, H, W], zetas [N, 8].  Returns (new_state, ids [N, P],
    uv [N, P, 2], uvn [N, P, 2], mask [N, P]) in FrameInput layout;
    `det_mask` applies to the master camera."""
    new_state, ids, uv_0, uvn_0, mask_0 = track_frame(
        state, imgs[0], zetas[0], params, sets_of, cam_model=cam_model,
        first_frame=first_frame, hist_method=hist_method, det_mask=det_mask)
    ids_all, uv_all, uvn_all, mask_all = [ids], [uv_0], [uvn_0], [mask_0]
    max_f = torch.maximum(zetas[0][0], zetas[0][1])
    for i in range(1, imgs.shape[0]):
        img_i = klt.equalize_method(imgs[i], hist_method)
        uv_i, ok_i = klt.track(new_state.prev_img, img_i, uv_0, params)
        uvn_i = cameras.undistort(cam_model, zetas[i], uv_i)
        both = mask_0 & ok_i
        inl, _ = ransac.ransac_from_sets(uvn_0, uvn_i, both, sets_of(both),
                                         thresh=2.0 / max_f)
        mask_i = both & inl
        ids_all.append(torch.where(mask_i, ids, -1))
        uv_all.append(uv_i)
        uvn_all.append(uvn_i)
        mask_all.append(mask_i)
    return (new_state, torch.stack(ids_all), torch.stack(uv_all),
            torch.stack(uvn_all), torch.stack(mask_all))


def track_frame_stereo(state: TrackerState, img_l, img_r, zeta_l, zeta_r,
                       params: klt.KltParams, sets_of,
                       cam_model: str = "radtan", first_frame: bool = False,
                       hist_method: str = "STRETCH", det_mask=None):
    """Stereo tracking: the N = 2 case of `track_frame_multi` (left eye
    the temporal master, TrackKLT::feed_stereo, TrackKLT.cpp:202-393)."""
    return track_frame_multi(
        state, torch.stack([img_l, img_r]), torch.stack([zeta_l, zeta_r]),
        params, sets_of, cam_model=cam_model, first_frame=first_frame,
        hist_method=hist_method, det_mask=det_mask)
