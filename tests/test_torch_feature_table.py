"""Parity of the port's feature table with the JAX package: ingestion
(matches, duplicate ids of one camera, free-list allocation, a full table,
stereo), the triage queries and the SWAR popcount, all exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import feature_table as jft
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import feature_table as tft
from torch_port_helpers import assert_table_equal, np_of


def _frames(rng, num_cams, P, n_frames, duplicates):
    """Seeded frames mixing continuing tracks, fresh ids, masked and -1
    entries (and, if asked, repeated ids within one camera)."""
    pool = rng.permutation(400).astype(np.int32)
    cursor = 0
    for frame in range(n_frames):
        n_old = min(frame * 3, P - 2)
        old = pool[max(0, cursor - n_old):cursor]
        fresh = pool[cursor:cursor + (P - old.size)]
        cursor += fresh.size
        ids_f = np.concatenate([old, fresh])[:P]
        ids = np.stack([rng.permutation(ids_f) for _ in range(num_cams)])
        if duplicates:
            ids[:, 1] = ids[:, 0]
        ids = np.where(rng.uniform(size=ids.shape) > 0.9, -1, ids)
        uv = rng.normal(size=(num_cams, P, 2)).astype(np.float32) * 100
        mask = rng.uniform(size=(num_cams, P)) > 0.2
        yield frame, ids.astype(np.int32), uv, uv * 0.01, mask


@pytest.mark.parametrize("num_cams,T,P,duplicates", [
    (1, 24, 10, False), (1, 24, 10, True), (2, 16, 8, False),
    (1, 8, 12, False),  # table fills up: allocation past the free list drops
])
def test_ingest_matches_jax(num_cams, T, P, duplicates):
    kw = dict(max_clones=5, max_slam=0, num_cams=num_cams)
    jc, tc = JCfg(**kw), TCfg(**kw)
    tab_j, tab_t = jft.init_table(jc, T), tft.init_table(tc, T, "cpu")
    rng = np.random.default_rng(3 + T + P)
    for frame, ids, uv, uvn, mask in _frames(rng, num_cams, P, 8, duplicates):
        head = frame % jc.max_clones
        if frame and head == 0:  # marginalize as the filter does
            slot = (head + 1) % jc.max_clones
            tab_j = jft.clear_clone_column(tab_j, jnp.asarray(slot))
            tab_t = tft.clear_clone_column(tab_t, torch.tensor(slot))
        tab_j = jft.ingest_frame(tab_j, jc, jnp.asarray(head),
                                 jnp.asarray(ids), jnp.asarray(uv),
                                 jnp.asarray(uvn), jnp.asarray(mask))
        tab_t = tft.ingest_frame(tab_t, tc, torch.tensor(head),
                                 torch.as_tensor(ids), torch.as_tensor(uv),
                                 torch.as_tensor(uvn), torch.as_tensor(mask))
        assert_table_equal(tab_t, tab_j, where=f"frame {frame}")
        n_clones = min(frame + 1, jc.max_clones)
        np.testing.assert_array_equal(np_of(tft.lost_rows(tab_t)),
                                      np.asarray(jft.lost_rows(tab_j)))
        np.testing.assert_array_equal(
            np_of(tft.full_window_rows(tab_t, torch.tensor(n_clones), tc)),
            np.asarray(jft.full_window_rows(tab_j, jnp.asarray(n_clones),
                                            jc)))
        np.testing.assert_array_equal(np_of(tft.row_obs_counts(tab_t)),
                                      np.asarray(jft.row_obs_counts(tab_j)))
        np.testing.assert_array_equal(np_of(tft.mask_bool(tab_t)),
                                      np.asarray(jft.mask_bool(tab_j)))
    if T < P:
        assert (np_of(tab_t.ids) >= 0).all()
    # free a seeded subset of rows
    drop = np.random.default_rng(1).uniform(size=T) > 0.5
    assert_table_equal(tft.free_rows(tab_t, torch.as_tensor(drop)),
                       jft.free_rows(tab_j, jnp.asarray(drop)))


def test_duplicate_ids_average():
    cfg = TCfg(max_clones=3, max_slam=0, num_cams=1)
    tab = tft.init_table(cfg, 4, "cpu")
    ids = torch.tensor([[5, 5, 6]], dtype=torch.int32)
    uv = torch.tensor([[[0.0, 2.0], [4.0, 6.0], [1.0, 1.0]]])
    tab = tft.ingest_frame(tab, cfg, torch.tensor(0), ids, uv, uv,
                           torch.ones((1, 3), dtype=torch.bool))
    # both copies of id 5 get the average of their measurements (each takes
    # a row, and each row averages the two hits it matches on the next
    # frame; on the first frame each new row holds its own measurement)
    assert sorted(np_of(tab.ids).tolist()) == [-1, 5, 5, 6]
    tab = tft.ingest_frame(tab, cfg, torch.tensor(1), ids, uv, uv,
                           torch.ones((1, 3), dtype=torch.bool))
    rows5 = np.where(np_of(tab.ids) == 5)[0]
    np.testing.assert_array_equal(np_of(tab.uv)[rows5, 1, 0],
                                  [[2.0, 4.0], [2.0, 4.0]])


def test_popcount32():
    x = np.random.default_rng(0).integers(-2**31, 2**31, size=4096,
                                          dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    got = np_of(tft.popcount32(torch.as_tensor(x)))
    np.testing.assert_array_equal(got, np.asarray(jft.popcount32(
        jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, [bin(int(v) & 0xFFFFFFFF).count("1") for v in x])
    assert got.dtype == np.int32


def test_obs_bit_and_clear_rows():
    kw = dict(max_clones=5, max_slam=0, num_cams=2)
    jc, tc = JCfg(**kw), TCfg(**kw)
    T, P = 16, 8
    tab_j, tab_t = jft.init_table(jc, T), tft.init_table(tc, T, "cpu")
    rng = np.random.default_rng(7)
    for frame, ids, uv, uvn, mask in _frames(rng, 2, P, 4, False):
        args = (ids, uv, uvn, mask)
        tab_j = jft.ingest_frame(tab_j, jc, jnp.asarray(frame),
                                 *map(jnp.asarray, args))
        tab_t = tft.ingest_frame(tab_t, tc, torch.tensor(frame),
                                 *map(torch.as_tensor, args))
    rows = rng.integers(-2, T + 2, size=(6, 5)).astype(np.int32)
    slots = rng.integers(0, jc.max_clones, size=(6, 5)).astype(np.int32)
    for cam in range(2):
        np.testing.assert_array_equal(
            np_of(tft.obs_bit(tab_t, torch.as_tensor(rows),
                              torch.as_tensor(slots), torch.tensor(cam))),
            np.asarray(jft.obs_bit(tab_j, jnp.asarray(rows),
                                   jnp.asarray(slots), cam)))
    drop = rng.uniform(size=T) > 0.5
    assert_table_equal(tft.clear_rows(tab_t, torch.as_tensor(drop)),
                       jft.clear_rows(tab_j, jnp.asarray(drop)))
