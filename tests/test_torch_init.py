"""The port's initialization front half against the JAX package: the static
initializer, the router (`decide`, `average_disparity`, `build_dyn_input`,
a routed static attempt), `propagator.make_window` and
`fast_state_propagate`, `manager.propagate_and_clone`,
`get_active_features` and `initialize_from_dynamic`, and background
initialization (`BackgroundInitializer`'s queue and its re-raised
exception, `catch_up`).

Every input is made with numpy from a seed (or read from the committed
fixture's frames) and fed to both packages.  The host functions must agree
exactly; the f32 device functions within the tolerances stated at each
test (a few float32 ulps of the values compared, or the step rule of the
ground rules, 1e-5·‖P‖∞, for a covariance).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.init import background as jbg
from open_vins_tpu.init import dynamic_init as jdi
from open_vins_tpu.init import router as jrouter
from open_vins_tpu.init import static_init as jstatic
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import propagator as jprop
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.init import background as tbg
from open_vins_tpu_torch.init import router as trouter
from open_vins_tpu_torch.init import static_init as tstatic
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import propagator as tprop
from open_vins_tpu_torch.models import runner as trun
from test_init import OPTS, imu_buffer
from torch_port_helpers import (assert_state_close, fixture_problem,
                                jax_frames_to_port, jax_pre_update,
                                jax_state_to_port, jax_table_to_port, np_of,
                                slam_problem, t)

STATIC_CASES = {
    "jerk": dict(jerk_at=1.6),
    "no_jerk": dict(),
    "moving": dict(),
    "attitude_biases": dict(R_GtoI=np.asarray(jlie.exp_so3(jnp.asarray(
        [0.3, -0.2, 0.1]))), bg=np.array([0.01, -0.02, 0.005]),
        ba=np.array([0.05, 0.02, -0.03]), jerk_at=1.6, noise=1e-4),
}


def _static_inputs(name):
    tt, w, a, m = (np.asarray(x) for x in imu_buffer(**STATIC_CASES[name]))
    if name == "moving":  # tests/test_init.py::test_moving_rejected
        a = a + np.sin(np.arange(a.shape[0]) * 0.3)[:, None] * 2.0
    return tt, w.astype(np.float32), a.astype(np.float32), m


@pytest.mark.parametrize("wait_for_jerk", [True, False], ids=["jerk", "still"])
@pytest.mark.parametrize("name", list(STATIC_CASES))
def test_try_static_init_matches_jax(name, wait_for_jerk):
    """tests/test_init.py's windows: the success flag exactly, q within
    2e-6, the biases within 1e-6 (f32 means over a few hundred samples)."""
    tt, w, a, m = _static_inputs(name)
    opts = OPTS._replace(wait_for_jerk=wait_for_jerk)
    want = jstatic.try_static_init(opts, jnp.asarray(tt), jnp.asarray(w),
                                   jnp.asarray(a), jnp.asarray(m),
                                   float(tt[-1]))
    got = tstatic.try_static_init(tstatic.StaticInitOptions(*opts), t(tt),
                                  t(w), t(a), torch.as_tensor(m),
                                  float(tt[-1]))
    assert bool(got.success) == bool(want.success)
    for k, tol in (("q_GtoI", 2e-6), ("bg", 1e-6), ("ba", 1e-6),
                   ("p", 0), ("v", 0), ("prior_diag15", 0)):
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=tol, err_msg=k)


def test_gram_schmidt_gravity_matches_jax():
    rng = np.random.default_rng(5)
    for z in rng.normal(size=(16, 3)).astype(np.float32):
        np.testing.assert_allclose(
            np_of(tstatic.gram_schmidt_gravity(t(z))),
            np.asarray(jstatic.gram_schmidt_gravity(jnp.asarray(z))),
            rtol=0, atol=1e-6)


def test_router_decide_and_disparity_equal_jax():
    """The numpy halves of the router: equal, not close."""
    rng = np.random.default_rng(6)
    for d1, d2 in rng.uniform(0.0, 20.0, size=(32, 2)):
        opts = jrouter.RouterOptions(max_disparity=10.0)
        assert (trouter.decide(trouter.RouterOptions(*opts), d1, d2)
                == jrouter.decide(opts, d1, d2))
    tracks_uv = [rng.normal(size=(n, 2)) * 30 for n in (1, 3, 7, 12)]
    tracks_t = [np.sort(rng.uniform(0, 2, size=len(u))) for u in tracks_uv]
    for lo, hi in ((0.0, 1.0), (0.5, 2.0), (1.9, 2.0), (3.0, 4.0)):
        assert (trouter.average_disparity(tracks_uv, tracks_t, lo, hi)
                == jrouter.average_disparity(tracks_uv, tracks_t, lo, hi))


def _track_hist(rng, t_poses, n_tracks):
    """Synthetic cam-0 track history: each track seen at a random subset of
    the pose times (and at times off the grid)."""
    hist = {}
    for fid in range(n_tracks):
        seen = rng.random(len(t_poses)) < 0.7
        ts = list(np.asarray(t_poses)[seen]) + list(rng.uniform(0, 2, 2))
        hist[fid] = (ts, [rng.normal(size=2).astype(np.float32)
                          for _ in ts])
    return hist


def _packer(rng, n=400):
    imu_t = np.arange(n) * 0.005
    imu_w = rng.normal(size=(n, 3)).astype(np.float32)
    imu_a = rng.normal(size=(n, 3)).astype(np.float32)
    return trun.window_packer(imu_t.astype(np.float32), imu_w, imu_a)


@pytest.mark.parametrize("n_tracks", [5, 60])
def test_build_dyn_input_equals_jax(n_tracks):
    """The host assembly of the dynamic problem: every array equal (None
    alike with too few multi-pose features)."""
    rng = np.random.default_rng(n_tracks)
    t_poses = [0.4 * i for i in range(6)]
    hist = _track_hist(rng, t_poses, n_tracks)
    make_window = _packer(rng)
    R, p = np.eye(3, dtype=np.float32), np.array([0.1, 0, 0], np.float32)
    want = jrouter.build_dyn_input(hist, t_poses, make_window, R, p, K=84)
    got = trouter.build_dyn_input(hist, t_poses, make_window, R, p, K=84,
                                  device="cpu")
    assert (got is None) == (want is None)
    if want is not None:
        for k, v in convert.dyn_input_to_numpy(got).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(want, k)),
                                          err_msg=k)


def test_routed_static_attempt_matches_jax():
    """A still buffer with a jerk routes static in both packages."""
    tt, w, a, _ = _static_inputs("jerk")
    opts = jrouter.RouterOptions(window_time=0.5, imu_thresh=0.5)
    kind_j, res_j = jrouter.try_initialize(opts, tt, w, a, float(tt[-1]),
                                           0.2, 0.4)
    kind_t, res_t = trouter.try_initialize(
        trouter.RouterOptions(*opts), t(tt), t(w), t(a), float(tt[-1]), 0.2,
        0.4)
    assert kind_t == kind_j == "static"
    np.testing.assert_allclose(np_of(res_t.q_GtoI), np.asarray(res_j.q_GtoI),
                               rtol=0, atol=2e-6)
    # moving (disparity above max) with no dynamic input: "none" in both
    assert (trouter.try_initialize(trouter.RouterOptions(*opts), t(tt), t(w),
                                   t(a), float(tt[-1]), 20.0, 0.4)
            == jrouter.try_initialize(opts, tt, w, a, float(tt[-1]), 20.0,
                                      0.4) == ("none", None))


@pytest.mark.parametrize("span", [(0.0123, 0.0987, 24), (0.5, 0.55, 12)])
def test_make_window_matches_jax(span):
    """Slice and interpolate the samples of (t0, t1): equal arrays."""
    rng = np.random.default_rng(7)
    imu_t = np.arange(300) * 0.005
    imu_w, imu_a = rng.normal(size=(2, 300, 3))
    t0, t1, K = span
    want = jprop.make_window(imu_t, imu_w, imu_a, t0, t1, K)
    got = tprop.make_window(imu_t, imu_w, imu_a, t0, t1, K, device="cpu")
    for k in ("t", "w", "a"):
        np.testing.assert_array_equal(np_of(getattr(got, k)),
                                      np.asarray(getattr(want, k)))
    with pytest.raises(ValueError):
        tprop.make_window(imu_t, imu_w, imu_a, 0.0, 1.0, 8, device="cpu")


@pytest.mark.parametrize("integration", ["rk4", "discrete", "analytical"])
def test_fast_state_propagate_matches_jax(integration):
    """The mean-only propagation over the fixture's frame-5 window from its
    groundtruth start: q, p, v within 1e-6 (a few ulps after 10 steps)."""
    pb = fixture_problem()
    jc = pb.cfg_jax._replace(integration=integration)
    frame = jax.tree_util.tree_map(lambda a: jnp.asarray(a[5]), pb.frames)
    st = pb.state._replace(bg=jnp.asarray([0.01, -0.02, 0.005]),
                           ba=jnp.asarray([0.05, 0.02, -0.03]))
    want = jprop.fast_state_propagate(st, jc, frame.win)
    got = tprop.fast_state_propagate(jax_state_to_port(st),
                                     pb.cfg_port._replace(
                                         integration=integration),
                                     jax_frames_to_port(frame).win)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=0,
                                   atol=1e-6)


def _stepped_state(pb, n):
    """The JAX state and table after n frames of the problem."""
    step = jax.jit(lambda s, tb, f: jman.step_frame(s, tb, pb.cfg_jax,
                                                    pb.tri_jax, f))
    st, tb = pb.state, pb.table
    for k in range(n):
        st, tb, _ = step(st, tb, jax.tree_util.tree_map(lambda a: a[k],
                                                        pb.frames))
    return st, tb


@pytest.fixture(scope="module")
def anchored_full():
    """The small SLAM problem in ANCHORED_MSCKF_INVERSE_DEPTH after 12
    frames: the clone ring is full and landmarks are anchored on it."""
    pb = slam_problem("ANCHORED_MSCKF_INVERSE_DEPTH")
    st, tb = _stepped_state(pb, 12)
    assert int(st.n_clones) == pb.cfg_jax.max_clones
    assert bool(np.asarray(st.slam_valid).any())
    return pb, st, tb


def test_propagate_and_clone_matches_jax(anchored_full):
    """From a full ring with anchored landmarks (re-anchor, marginalize,
    propagate, clone): the step rule, 1e-5·‖P‖∞, values within 1e-4."""
    pb, st, _ = anchored_full
    frame = jax.tree_util.tree_map(lambda a: jnp.asarray(a[12]), pb.frames)
    want = jman.propagate_and_clone(st, pb.cfg_jax, frame.win, frame.t_new)
    fr_t = jax_frames_to_port(frame)
    got = tman.propagate_and_clone(jax_state_to_port(st), pb.cfg_port,
                                   fr_t.win, fr_t.t_new)
    assert_state_close(got, want, where="propagate_and_clone")
    for k in ("slam_p", "slam_anchor_slot"):
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_propagate_and_clone_vmap_matches_single(anchored_full):
    """Under torch.func.vmap over two streams (one with a full ring, one
    not), each stream equals its own call: the marginalized state is a
    device select, out of place."""
    pb, st, _ = anchored_full
    frame = jax_frames_to_port(jax.tree_util.tree_map(lambda a: a[12],
                                                      pb.frames))
    full = jax_state_to_port(st)
    fresh = jax_state_to_port(pb.state)
    fresh = fresh.replace(t=full.t)
    both = trun.stack_records([full, fresh])
    frames = trun.stack_records([frame, frame])  # a batched step's frames
    out = torch.func.vmap(lambda s, f: tman.propagate_and_clone(
        s, pb.cfg_port, f.win, f.t_new))(both, frames)
    for b, one in enumerate((full, fresh)):
        want = tman.propagate_and_clone(one, pb.cfg_port, frame.win,
                                        frame.t_new)
        for k, v in want.items():
            np.testing.assert_allclose(np_of(getattr(out, k)[b]), np_of(v),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_get_active_features_matches_jax(anchored_full):
    """The tracked features of frame 12's pre-update table re-triangulated
    for publishing: rows and ids exactly (top_k's tie order), points
    within 1e-4 m."""
    pb, st, tb = anchored_full
    st, tb = jax_pre_update(pb, st, tb, 12)
    want = jman.get_active_features(st, pb.cfg_jax, tb, pb.tri_jax, 16)
    got = tman.get_active_features(jax_state_to_port(st), pb.cfg_port,
                                   jax_table_to_port(tb), pb.tri_port, 16)
    np.testing.assert_array_equal(np_of(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np_of(got[2]), np.asarray(want[2]))
    assert np.asarray(want[2]).sum() > 0
    np.testing.assert_allclose(np_of(got[0]), np.asarray(want[0]), rtol=0,
                               atol=1e-4)


def test_initialize_from_dynamic_matches_jax():
    """The dynamic handoff: the IMU mean and the 15×15 block, the rest of
    the groundtruth start's prior."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(15, 15))
    q = rng.normal(size=4)
    res = {"success": np.bool_(True),
           "q_GtoI": (q / np.linalg.norm(q)).astype(np.float32),
           "p": rng.normal(size=3).astype(np.float32),
           "v": rng.normal(size=3).astype(np.float32),
           "bg": rng.normal(size=3).astype(np.float32) * 1e-3,
           "ba": rng.normal(size=3).astype(np.float32) * 1e-2,
           "cov15": (A @ A.T * 1e-3).astype(np.float32),
           "R_I0toIk": np.tile(np.eye(3, dtype=np.float32), (6, 1, 1)),
           "p_k_in0": np.zeros((6, 3), np.float32)}
    kw = dict(max_clones=5, max_slam=4, calib_cam_extrinsics=True)
    calib = (np.asarray([[0.0, 0.0, 0.0, 1.0]], np.float32),
             np.asarray([[0.1, 0.0, 0.0]], np.float32),
             np.tile(np.float32([400, 400, 320, 240, 0, 0, 0, 0]), (1, 1)))
    want = jman.initialize_from_dynamic(
        JCfg(**kw), jdi.DynInitResult(**res), 2.5, *map(jnp.asarray, calib))
    got = tman.initialize_from_dynamic(
        TCfg(**kw), convert.dyn_result_from_numpy(res, "cpu"), 2.5,
        *map(t, calib))
    for k, v in convert.state_to_numpy(got).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)),
                                      err_msg=k)


def test_background_initializer_queue_semantics():
    """The worker's life cycle as the reference's: queued while running,
    cleared on "none", kept on success (times after t_init only), True
    once succeeded — and, unlike the reference, an attempt's exception
    re-raised on the caller's thread by the next try_to_initialize and by
    join."""
    for mod in (jbg, tbg):
        gate = threading.Event()

        def slow(kind):
            def attempt():
                gate.wait(5.0)
                return kind, ("res" if kind != "none" else None)
            return attempt

        bg = mod.BackgroundInitializer()
        assert not bg.try_to_initialize(1.0, None)
        assert not bg.try_to_initialize(1.0, slow("none"))
        assert bg.busy
        assert not bg.try_to_initialize(1.1, slow("static"))
        gate.set()
        bg.join(5.0)
        assert bg.result is None and bg.queued_times(0.0) == []
        gate.clear()
        assert not bg.try_to_initialize(2.0, slow("dynamic"))
        for tq in (1.9, 2.05, 2.1):
            assert not bg.try_to_initialize(tq, None)
        gate.set()
        bg.join(5.0)
        assert bg.result == ("dynamic", "res", 2.0)
        assert bg.try_to_initialize(2.2, None)
        assert bg.queued_times(2.0) == [2.05, 2.1]

    def boom():
        raise RuntimeError("kernel build failed")

    bg = tbg.BackgroundInitializer()
    bg.try_to_initialize(1.0, boom)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        bg.join(5.0)
    assert bg.result is None and not bg.busy
    bg.try_to_initialize(1.0, boom)
    while bg.busy:
        pass
    with pytest.raises(RuntimeError, match="kernel build failed"):
        bg.try_to_initialize(1.1, None)
    # the reference reports the same failure as "none"
    bg_j = jbg.BackgroundInitializer()
    bg_j.try_to_initialize(1.0, boom)
    bg_j.join(5.0)
    assert bg_j.result is None


def test_catch_up_matches_jax():
    """The catch-up over 14 queued camera times of the fixture from its
    groundtruth start (clone_rate 2: 7 propagate-and-clones): the step
    rule, 1e-5·‖P‖∞, values within 1e-4."""
    pb = fixture_problem()
    run = trun.SimRun(frames=jax_frames_to_port(pb.frames),
                      gt_q=torch.zeros(1), gt_p=torch.zeros(1),
                      gt_v=torch.zeros(1))
    make_window = trun.window_packer(*trun.imu_stream(run))
    queued = [float(x) for x in np.asarray(pb.frames.t_new)[:14]]
    want = jbg.catch_up(pb.state, pb.cfg_jax, queued, make_window, 200.0)
    got = tbg.catch_up(jax_state_to_port(pb.state), pb.cfg_port, queued,
                       make_window, 200.0)
    assert int(got.n_clones) == int(want.n_clones) == 7
    assert_state_close(got, want, where="catch_up")
