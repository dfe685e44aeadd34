"""The port's KLT and descriptor trackers against the JAX package's over a
few numpy-made frames (CPU, small images), with JAX's own RANSAC
hypothesis sets handed to the port (`JaxSets`: the reference's key chain,
one split per RANSAC, its Gumbel top-k on the port's mask).

Tolerances: ids and masks equal, points within 1e-3 px, on every frame;
the descriptor tracker's ids and masks equal and points within 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.frontend import descriptor as jdesc
from open_vins_tpu.frontend import klt as jklt
from open_vins_tpu.frontend import tracker as jtracker
from open_vins_tpu_torch.frontend import descriptor, klt, tracker
from test_torch_frontend import jax_sets, texture, warp
from torch_port_helpers import np_of, one_torch_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 160, 224
N_FRAMES = 5
PARAMS = klt.KltParams(num_pyr=4, win=7, iters=12, num_features=40,
                       grid_x=8, grid_y=6)
JPARAMS = jklt.KltParams(*PARAMS)
ZETA = np.float32([[230.0, 231.0, 111.5, 79.5, -0.05, 0.01, 1e-4, -2e-4],
                   [229.0, 230.0, 112.0, 80.0, -0.04, 0.01, 0.0, 1e-4],
                   [231.0, 229.5, 111.0, 79.0, -0.05, 0.02, 1e-4, 0.0]])


class JaxSets:
    """The JAX tracker's hypothesis sets: PRNGKey(seed), then per RANSAC
    `key, sub = split(key)` and `ransac_fundamental`'s draw from `sub` on
    the given mask."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, mask):
        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(jax_sets(sub, jnp.asarray(np_of(mask))))


def frames(n_cams):
    """[N_FRAMES, n_cams, H, W]: a texture drifting by about 2 px a frame
    with a slight rotation; camera i sees it shifted 3·i px sideways."""
    base = texture(H, W, seed=12)
    return np.stack([np.stack([
        warp(base, 2.1 * k - 3.0 * c, -1.3 * k, deg=0.4 * k)
        for c in range(n_cams)]) for k in range(N_FRAMES)])


def assert_packets_equal(got, want, k):
    ids, uv, uvn, mask = (np_of(x) for x in got)
    jids, juv, juvn, jmask = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(mask, jmask, err_msg=f"frame {k} mask")
    np.testing.assert_array_equal(ids, jids, err_msg=f"frame {k} ids")
    np.testing.assert_allclose(uv[mask], juv[jmask], rtol=0, atol=1e-3,
                               err_msg=f"frame {k} uv")
    np.testing.assert_allclose(uvn[mask], juvn[jmask], rtol=0, atol=1e-5,
                               err_msg=f"frame {k} uvn")


def run_both(n_cams, hist_method="STRETCH", det_mask=None, aruco=0):
    """Both trackers over the frames; checks every frame's packet and
    returns the port's mean tracks per frame."""
    imgs = frames(max(n_cams, 1))
    jst = jtracker.init_tracker(H, W, PARAMS.num_features,
                                num_aruco_tags=aruco)
    st = tracker.init_tracker(H, W, PARAMS.num_features,
                              num_aruco_tags=aruco, device="cpu")
    assert int(st.next_id) == int(jst.next_id)
    sets = JaxSets(0)
    jmask = None if det_mask is None else jnp.asarray(det_mask)
    tmask = None if det_mask is None else torch.as_tensor(det_mask)
    counts = []
    for k in range(N_FRAMES):
        first = k == 0
        if n_cams == 1:
            jst, *jout = jtracker.track_frame(
                jst, jnp.asarray(imgs[k, 0]), jnp.asarray(ZETA[0]), JPARAMS,
                first_frame=first, hist_method=hist_method, det_mask=jmask)
            st, *out = tracker.track_frame(
                st, t(imgs[k, 0]), t(ZETA[0]), PARAMS, sets,
                first_frame=first, hist_method=hist_method, det_mask=tmask)
        else:
            jst, *jout = jtracker.track_frame_multi(
                jst, jnp.asarray(imgs[k]), jnp.asarray(ZETA[:n_cams]),
                JPARAMS, first_frame=first, hist_method=hist_method)
            st, *out = tracker.track_frame_multi(
                st, t(imgs[k]), t(ZETA[:n_cams]), PARAMS, sets,
                first_frame=first, hist_method=hist_method)
        assert_packets_equal(out, jout, k)
        assert int(st.next_id) == int(jst.next_id)
        np.testing.assert_array_equal(np_of(st.valid), np.asarray(jst.valid))
        counts.append(int(np_of(out[3]).sum()))
    return np.mean(counts[1:])


def test_track_frame_matches_jax():
    assert run_both(1) > 25


@pytest.mark.parametrize("method", ["NONE", "HISTOGRAM", "CLAHE"])
def test_track_frame_hist_methods_match_jax(method):
    assert run_both(1, hist_method=method) > 20


def test_track_frame_det_mask_matches_jax():
    mask = np.ones((H, W), bool)
    mask[:, : W // 3] = False
    got = run_both(1, det_mask=mask, aruco=2)
    assert got > 10


@pytest.mark.parametrize("n_cams", [2, 3])
def test_track_frame_multi_matches_jax(n_cams):
    assert run_both(n_cams) > 25 * n_cams


def test_track_frame_stereo_is_multi():
    imgs = frames(2)
    a = tracker.init_tracker(H, W, PARAMS.num_features, device="cpu")
    b = tracker.init_tracker(H, W, PARAMS.num_features, device="cpu")
    sa, sb = JaxSets(3), JaxSets(3)
    for k in range(2):
        a, *oa = tracker.track_frame_stereo(
            a, t(imgs[k, 0]), t(imgs[k, 1]), t(ZETA[0]), t(ZETA[1]), PARAMS,
            sa, first_frame=k == 0)
        b, *ob = tracker.track_frame_multi(b, t(imgs[k]), t(ZETA[:2]),
                                           PARAMS, sb, first_frame=k == 0)
        for x, y in zip(oa, ob):
            assert torch.equal(x, y)


def test_descriptor_parts_match_jax():
    img = frames(1)[1, 0]
    pts, ok = klt.detect_grid(t(img), torch.zeros((1, 2)),
                              torch.zeros(1, dtype=torch.bool), PARAMS, 40)
    jpts, jok = jnp.asarray(np_of(pts)), jnp.asarray(np_of(ok))
    np.testing.assert_allclose(
        np_of(descriptor.patch_orientation(t(img), pts, ok)),
        np.asarray(jdesc.patch_orientation(jnp.asarray(img), jpts, jok)),
        rtol=0, atol=1e-4)
    for steered, scale in ((True, 1.0), (False, 1.5)):
        np.testing.assert_allclose(
            np_of(descriptor.extract(t(img), pts, ok, steered, scale)),
            np.asarray(jdesc.extract(jnp.asarray(img), jpts, jok, steered,
                                     scale)), rtol=0, atol=1e-4)
    img2 = t(frames(1)[2, 0])
    pts2, ok2 = klt.detect_grid(img2, torch.zeros((1, 2)),
                                torch.zeros(1, dtype=torch.bool), PARAMS, 40)
    d0 = descriptor.extract(t(img), pts, ok)
    d1 = descriptor.extract(img2, pts2, ok2)
    idx, matched = descriptor.match(d0, d1, ok, ok2)
    jidx, jmatched = jdesc.match(jnp.asarray(np_of(d0)),
                                 jnp.asarray(np_of(d1)), jok,
                                 jnp.asarray(np_of(ok2)))
    np.testing.assert_array_equal(np_of(matched), np.asarray(jmatched))
    m = np_of(matched)
    np.testing.assert_array_equal(np_of(idx)[m], np.asarray(jidx)[m])
    assert m.sum() > 10


def _collisions(idx1, matched):
    """Unmatched rows whose best match is a matched row's target."""
    taken = set(idx1[matched].tolist())
    return int(sum(1 for j in np.flatnonzero(~matched) if idx1[j] in taken))


def jax_desc_track_frame_matched_scatter(state, img, zeta, params,
                                         first_frame=False):
    """descriptor.py:111-164 of the JAX package with one line changed: the
    inherited ids are scattered from the matched rows only (the others
    target a spare slot), the semantics the port implements."""
    from open_vins_tpu.frontend import ransac as jransac
    from open_vins_tpu.ops import cameras as jcam

    P = state.prev_pts.shape[0]
    img = jklt.equalize(img)
    pts, det_ok = jklt.detect_grid(img, jnp.zeros((1, 2), img.dtype),
                                   jnp.zeros((1,), bool), params, P)
    desc = jdesc.extract(img, pts, det_ok)
    idx1, matched = jdesc.match(state.prev_desc, desc, state.valid, det_ok)
    matched = matched & jnp.logical_not(first_frame)
    uvn0 = jcam.undistort("radtan", zeta, state.prev_pts)
    uvn1_all = jcam.undistort("radtan", zeta, pts)
    key, sub = jax.random.split(state.key)
    inl, _ = jransac.ransac_fundamental(
        uvn0, uvn1_all[idx1], matched, sub,
        thresh=2.0 / jnp.maximum(zeta[0], zeta[1]))
    matched = matched & inl
    ids_cur = jnp.full((P,), -1, jnp.int32).at[
        jnp.where(matched, idx1, P)].set(state.ids, mode="drop")
    is_new = det_ok & (ids_cur < 0)
    n_new_before = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    ids_cur = jnp.where(is_new, state.next_id + n_new_before, ids_cur)
    next_id = state.next_id + jnp.sum(is_new.astype(jnp.int32))
    valid_cur = det_ok & (ids_cur >= 0)
    new_state = jdesc.DescTrackerState(
        prev_desc=desc, prev_pts=pts, ids=ids_cur, valid=valid_cur,
        next_id=next_id, key=key)
    return new_state, ids_cur, pts, uvn1_all, valid_cur


def run_desc_both(imgs, jax_step, check_collisions):
    """Both descriptor trackers over imgs [K, H, W]; checks every frame's
    packet and returns the port's mean inherited ids per frame."""
    jst = jdesc.init_tracker(PARAMS.num_features)
    st = descriptor.init_tracker(PARAMS.num_features, device="cpu")
    sets = JaxSets(5)
    step = jax.jit(jax_step, static_argnames=("params", "first_frame"))
    inherited = []
    for k in range(len(imgs)):
        first = k == 0
        if check_collisions and not first:
            eq = jklt.equalize(jnp.asarray(imgs[k]))
            det, dok = jklt.detect_grid(eq, jnp.zeros((1, 2)),
                                        jnp.zeros(1, bool), JPARAMS,
                                        PARAMS.num_features)
            idx1, mt = jdesc.match(jst.prev_desc,
                                   jdesc.extract(eq, det, dok), jst.valid,
                                   dok)
            assert _collisions(np.asarray(idx1), np.asarray(mt)) == 0
        jst, *jout = step(jst, jnp.asarray(imgs[k]), jnp.asarray(ZETA[0]),
                          JPARAMS, first_frame=first)
        st, *out = descriptor.track_frame(st, t(imgs[k]), t(ZETA[0]),
                                          PARAMS, sets, first_frame=first)
        assert_packets_equal(out, jout, k)
        assert int(st.next_id) == int(jst.next_id)
        if not first:  # detections that kept an id of an earlier frame
            inherited.append(int((np_of(out[3]) & (np_of(out[0])
                                                   < n_before)).sum()))
        n_before = int(np_of(st.next_id))
    return np.mean(inherited)


def test_descriptor_tracker_matches_jax_without_collision():
    """A camera at rest: every previous detection's best match is its own
    (checked: no unmatched row targets a matched row's detection), so the
    reference's scatter of every row and the port's of the matched rows
    agree exactly."""
    imgs = np.stack([texture(H, W, seed=3)] * N_FRAMES)
    assert run_desc_both(imgs, jdesc.track_frame, True) > 30


def test_descriptor_tracker_matches_jax_on_moving_frames():
    """Moving frames, where rows collide in nearly every frame: the JAX
    tracker with the matched-rows scatter agrees with the port exactly."""
    assert run_desc_both(frames(1)[:, 0], jax_desc_track_frame_matched_scatter,
                         False) > 15


def test_descriptor_collision_keeps_matched_id():
    """Rows 0 and 2 of the previous frame both match detection 1 best;
    row 0 is the mutual match.  The port keeps its id 7 at detection 1
    wherever row 2 lies; the reference's scatter of every row writes row
    2's -1 there too (which write lands last is unspecified)."""
    ids_prev = torch.tensor([7, 8, 9], dtype=torch.int32)
    idx1 = torch.tensor([1, 0, 1])
    matched = torch.tensor([True, True, False])
    got = descriptor.inherit_ids(ids_prev, idx1, matched, 3)
    assert got.tolist() == [8, 7, -1]
    # the reference's scatter on the same rows, as descriptor.py:150-152
    # writes it (JAX on the CPU lets the last row win: [8, -1, -1])
    jax_ids = jnp.full((3,), -1, jnp.int32).at[jnp.asarray(np_of(idx1))].set(
        jnp.where(jnp.asarray(np_of(matched)), jnp.asarray(np_of(ids_prev)),
                  -1), mode="drop")
    assert np.asarray(jax_ids)[0] == 8
    assert np.asarray(jax_ids)[1] in (7, -1)
