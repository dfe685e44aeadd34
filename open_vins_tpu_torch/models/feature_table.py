"""Device-side feature track table — the FeatureDatabase as fixed-shape
tensors.

Counterpart of `open_vins_tpu/models/feature_table.py` (FeatureDatabase +
Feature parity, FeatureDatabase.h:54-167): a [T]-row table with an id
column and a bit-packed observation mask `mbits` [T, N] int32 — bit c of
word (t, n) = "row t has a valid observation at clone slot c from camera n".
Marginalizing a clone is one AND-mask; "lost" / "full-window" queries are
popcounts.  Requires max_clones <= 32.

Every write is a device-side select, so ingestion never waits for the
device; duplicate ids of one camera average, and allocation past the free
list drops, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import TensorRecord


@dataclasses.dataclass
class FeatureTable(TensorRecord):
    ids: torch.Tensor  # [T] int32, -1 = free row
    uv: torch.Tensor  # [T, C, N, 2] raw pixel obs by clone slot / camera
    uvn: torch.Tensor  # [T, C, N, 2] normalized obs
    mbits: torch.Tensor  # [T, N] int32 — bit c set = valid obs at slot c
    seen: torch.Tensor  # [T] bool — observed in the current frame


def popcount32(x):
    """Per-element population count of an int32 tensor (SWAR, in int32:
    the arithmetic right shift and the wrapping multiply give the same bits
    as the reference's)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def init_table(cfg: FilterConfig, max_tracks: int, device) -> FeatureTable:
    C, N = cfg.max_clones, cfg.num_cams
    if C > 32:
        raise ValueError("bit-packed mask holds one clone bit per int32 word")
    return FeatureTable(
        ids=torch.full((max_tracks,), -1, dtype=torch.int32, device=device),
        uv=torch.zeros((max_tracks, C, N, 2), dtype=torch.float32,
                       device=device),
        uvn=torch.zeros((max_tracks, C, N, 2), dtype=torch.float32,
                        device=device),
        mbits=torch.zeros((max_tracks, N), dtype=torch.int32, device=device),
        seen=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
    )


def mask_bool(table: FeatureTable):
    """Unpack mbits to the logical [T, C, N] bool mask."""
    C = table.uv.shape[1]
    c = torch.arange(C, dtype=torch.int32, device=table.mbits.device)
    return ((table.mbits[:, None, :] >> c[None, :, None]) & 1) > 0


def obs_bit(table: FeatureTable, rows, slot, cam):
    """Valid-observation bits of table rows at (slot, cam): integer tensors
    that broadcast together.  Rows outside [0, T) read the nearest row, as
    in the reference."""
    rows, slot, cam = torch.broadcast_tensors(rows, slot, cam)
    T = table.mbits.shape[0]
    word = table.mbits[torch.clamp(rows, 0, T - 1).long(), cam.long()]
    return ((word >> slot.to(torch.int32)) & 1) > 0


def ingest_frame(table: FeatureTable, cfg: FilterConfig, head_slot,
                 ids, uv, uvn, meas_mask) -> FeatureTable:
    """Write one frame of measurements into clone column `head_slot`
    (TrackBase::feed_new_camera → FeatureDatabase::update_feature parity):
    existing ids append an observation, unseen ids take free rows in
    ascending row order.  Cameras are ingested in turn so a stereo feature
    seen by both eyes takes one row.  ids/meas_mask [N, P], uv/uvn [N, P, 2].

    The row ← measurement map is a dense [T, P] bool matrix W (matches plus
    allocations), so nothing waits on a data-dependent size: a row's values
    are W·uv over its hit count, which is exact for one hit and averages
    duplicate ids of one camera.
    """
    T, C = table.uv.shape[:2]
    dev = table.ids.device
    rows_t = torch.arange(T, dtype=torch.int32, device=dev)
    slot_onehot = torch.arange(C, device=dev) == head_slot  # [C]
    head_bit = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=dev),
        head_slot.to(torch.int32))
    seen = torch.zeros((T,), dtype=torch.bool, device=dev)
    new_ids, new_uv, new_uvn, new_bits = (table.ids, table.uv, table.uvn,
                                          table.mbits)

    for cam in range(cfg.num_cams):
        cam_ids = ids[cam]  # [P]
        cam_mask = meas_mask[cam] & (cam_ids >= 0)

        # match incoming ids against table rows: [T, P]
        eq = (new_ids[:, None] == cam_ids[None, :]) & cam_mask[None, :]
        has_match = eq.any(dim=0)

        # allocate free rows for new ids (rank order into the free list);
        # ranks beyond the free list hit the T sentinel and drop
        is_new = cam_mask & ~has_match
        sorted_free = torch.sort(torch.where(new_ids < 0, rows_t, T)).values
        new_rank = torch.cumsum(is_new.to(torch.int32), 0) - 1
        alloc_row = sorted_free[torch.clamp(new_rank, 0, T - 1).long()]
        alloc_ok = is_new & (new_rank < T) & (alloc_row < T)
        alloc_hit = ((rows_t[:, None] == alloc_row[None, :])
                     & alloc_ok[None, :])  # [T, P]

        W = eq | alloc_hit  # row t <- measurement p
        Wf = W.to(uv.dtype)
        row_any = W.any(dim=1)
        inv_hits = 1.0 / torch.clamp(Wf.sum(dim=1), min=1.0)
        uv_t = (Wf @ uv[cam]) * inv_hits[:, None]  # [T, 2]
        uvn_t = (Wf @ uvn[cam]) * inv_hits[:, None]
        id_t = torch.where(W, cam_ids[None, :], -1).amax(dim=1)

        sel = (row_any[:, None] & slot_onehot[None, :])[..., None]  # [T,C,1]
        new_uv = new_uv.clone()
        new_uvn = new_uvn.clone()
        new_uv[:, :, cam, :] = torch.where(sel, uv_t[:, None, :],
                                           new_uv[:, :, cam, :])
        new_uvn[:, :, cam, :] = torch.where(sel, uvn_t[:, None, :],
                                            new_uvn[:, :, cam, :])
        new_bits = new_bits.clone()
        new_bits[:, cam] = torch.where(row_any, new_bits[:, cam] | head_bit,
                                       new_bits[:, cam])
        new_ids = torch.where(alloc_hit.any(dim=1), id_t, new_ids)
        seen = seen | row_any

    return table.replace(ids=new_ids, uv=new_uv, uvn=new_uvn, mbits=new_bits,
                         seen=seen)


def clear_clone_column(table: FeatureTable, slot) -> FeatureTable:
    """Invalidate all observations at a marginalized clone slot
    (FeatureDatabase::cleanup_measurements parity) — one AND-mask."""
    bit = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=table.mbits.device),
        slot.to(torch.int32))
    return table.replace(mbits=table.mbits & ~bit)


def clear_rows(table: FeatureTable, rows_mask) -> FeatureTable:
    """Drop all observations of the given rows, keeping their ids."""
    return table.replace(mbits=torch.where(rows_mask[:, None], 0,
                                           table.mbits))


def row_obs_counts(table: FeatureTable):
    """[T] number of valid observations per row."""
    return popcount32(table.mbits).sum(dim=1, dtype=torch.int32)


def lost_rows(table: FeatureTable):
    """Rows with history but not seen this frame
    (features_not_containing_newer parity) — MSCKF update candidates."""
    return (table.ids >= 0) & ~table.seen & (row_obs_counts(table) > 0)


def full_window_rows(table: FeatureTable, state_n_clones, cfg: FilterConfig):
    """Rows observed in every active clone (features_containing(margtime)
    parity) — SLAM promotion / forced-MSCKF candidates."""
    any_cam = table.mbits[:, 0]
    for n in range(1, table.mbits.shape[1]):
        any_cam = any_cam | table.mbits[:, n]
    return (table.ids >= 0) & (popcount32(any_cam) >= state_n_clones)


def free_rows(table: FeatureTable, rows_mask) -> FeatureTable:
    """Remove the given rows entirely (post-update cleanup parity)."""
    keep = ~rows_mask
    return table.replace(
        ids=torch.where(keep, table.ids, -1),
        mbits=torch.where(keep[:, None], table.mbits, 0),
        seen=table.seen & keep,
    )
