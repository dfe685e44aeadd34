"""The port's renderer, its rendered runs and the stereo estimator against
the JAX package (CPU).

* `render` / `render_frame` on the port's CPU staging of a small stream,
  against JAX's `render_frame` on a JAX SimData built from the same
  staging: within 3e-5.  The f32 image is itself only good to about 2e-5
  of a float64 evaluation of the same sprites (JAX 1.7e-5, the port
  1.9e-5 on this stream: a sprite edge moves 0.36 per pixel of centre,
  and f32 poses put the centres 1e-5 px apart), so 1e-5 cannot hold;
* a 3-frame `run_filter_rendered` at 320x240 mono, the tracker handed JAX's
  RANSAC sets: the packets' ids and masks equal, poses within 1e-4;
* the stereo estimator before any image code: one `step_frame` after
  another at graft-like sizes (5 clones, 12 points, 4 landmark slots, two
  cameras), each from the JAX state, with test_torch_slam.py's
  tolerances; and bench.py's rendered stream's TrackSIM frames (752x480
  stereo, 11 clones, 25 landmark slots, 159 frames) through
  `runner.run_filter` against JAX's run committed in
  `open_vins_tpu_torch/data/rendered_stereo8_seed0_ref.npz`: RMSE within
  0.01 m, NEES within 25 %, landmarks in use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.frontend import klt as jklt
from open_vins_tpu.models import feature_table as jft
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import runner as jrun
from open_vins_tpu.models import triangulation as jtri
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu.sim import render as jrender
from open_vins_tpu.sim import simulator as jsimulator
from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.frontend import klt
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import triangulation as ttri
from open_vins_tpu_torch.sim import render
from test_torch_fixture import (RENDERED_META, RENDERED_REF, jax_run_of_port,
                                jax_sim_of_port, tracksim_meta)
from test_torch_slam import _check_step
from test_torch_tracker import JaxSets
from torch_port_helpers import (jax_state_to_port, np_of,  # noqa: F401
                                one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL_CALIB = {"intr": [[210.0, 209.0, 160.0, 120.0, -0.05, 0.01, 1e-4,
                         -2e-4]] * 2,
               "rot": [[-1.2, 1.2, -1.2]] * 2,
               "p": [[0.0, -0.01, 0.02], [0.11, -0.01, 0.02]]}
SMALL_META = {"sim": dict(imu_rate=200.0, cam_rate=20.0, num_cams=2,
                          num_pts=40, map_size=256, duration=0.2,
                          sigma_pix=0.0, start_offset=3.0, width=320,
                          height=240, min_depth=4.0, max_depth=9.0),
              "traj": None, "seed": 0, "calib": SMALL_CALIB}
KLT = klt.KltParams(num_pyr=4, win=7, iters=12, num_features=40, grid_x=8,
                    grid_y=6)


@pytest.fixture(scope="module")
def small():
    """The port's CPU staging of a 320x240 stereo stream (4 frames)."""
    sim, params, run = convert.stage_stream(SMALL_META, "cpu")
    return sim, params, run, jax_sim_of_port(sim), jsimulator.SimParams(
        **SMALL_META["sim"])


def test_render_frame_matches_jax(small):
    sim, params, _, jsim, jparams = small
    jrend = jax.jit(jrender.render_frame, static_argnames=("params", "cam"))
    for k, c, gain, offset in ((0, 0, 1.0, 0.0), (2, 1, 1.3, -0.05),
                               (3, 0, 0.7, 0.1)):
        want = np.asarray(jrend(jsim, jparams, k, cam=c, gain=gain,
                                offset=offset))
        got = np_of(render.render_frame(sim, params, k, cam=c, gain=gain,
                                        offset=offset))
        assert got.shape == (240, 320) and want.max() > 0.3
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    # one batched call renders what the per-frame calls do
    batch = render.render(sim, params, [0, 2, 3])
    assert batch.shape == (3, 2, 240, 320)
    np.testing.assert_allclose(
        np_of(batch[1, 1]), np_of(render.render_frame(sim, params, 2, cam=1)),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np_of(render.render_run(sim, params, cam=1)),
        np_of(render.render(sim, params, range(4))[:, 1]))
    np.testing.assert_array_equal(
        np_of(trun.render_frames(sim, params, 4, device="cpu")),
        np_of(render.render(sim, params, range(4))))


def test_run_filter_rendered_matches_jax(small):
    """3 frames at 320x240 mono through both pipelines."""
    meta = dict(SMALL_META, sim=dict(SMALL_META["sim"], num_cams=1))
    sim1, params, run1 = convert.stage_stream(meta, "cpu")
    jparams = jsimulator.SimParams(**meta["sim"])
    jsim1, jrun1 = jax_sim_of_port(sim1), jax_run_of_port(run1)
    kw = dict(max_clones=5, max_slam=4, num_cams=1, max_msckf_in_update=8,
              integration="analytical")
    (jst, jtb, jtrk), jouts = jax.jit(lambda s, r: jrun.run_filter_rendered(
        JCfg(**kw), jtri.TriangulationOptions(max_runs=2), s, jparams, r,
        jklt.KltParams(*KLT), max_tracks=64))(jsim1, jrun1)
    (st, tb, trk), outs = trun.run_filter_rendered(
        TCfg(**kw), ttri.TriangulationOptions(max_runs=2), sim1, params, run1,
        KLT, max_tracks=64, sets_of=JaxSets(0), device="cpu")
    assert outs[1].shape == (3, 3)
    np.testing.assert_array_equal(np_of(trk.ids), np.asarray(jtrk.ids))
    np.testing.assert_allclose(np_of(trk.pts)[np_of(trk.valid)],
                               np.asarray(jtrk.pts)[np.asarray(jtrk.valid)],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(np_of(tb.ids), np.asarray(jtb.ids))
    for k in ("n_tracks", "n_msckf", "n_slam"):
        np.testing.assert_array_equal(np_of(getattr(outs[4], k)),
                                      np.asarray(getattr(jouts[4], k)),
                                      err_msg=k)
    assert int(np_of(outs[4].n_tracks)[-1]) > 20
    np.testing.assert_allclose(np_of(outs[1]), np.asarray(jouts[1]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(np_of(outs[0]), np.asarray(jouts[0]), rtol=0,
                               atol=1e-4)
    # the front end alone: rendering inside the loop or before it tracks
    # the same
    _, counts = trun.run_tracker_rendered(sim1, params, KLT, 4,
                                          sets_of=JaxSets(0), device="cpu")
    assert counts.shape == (3,) and int(counts.min()) > 20
    imgs = trun.render_frames(sim1, params, 4, device="cpu")
    _, staged = trun.run_tracker_staged(imgs, sim1, params, KLT,
                                        sets_of=JaxSets(0), device="cpu")
    np.testing.assert_array_equal(np_of(staged), np_of(counts))


def test_stereo_step_parity_graft_size():
    """The stereo estimator one step after another at graft-like sizes
    (`__graft_entry__._build_problem`'s 5 clones, 12 points, 10 Hz, <= 8
    MSCKF features, two Gauss-Newton runs) with two cameras and 4 landmark
    slots, on the port's CPU staging of bench.py's stereo calibration;
    each step from the JAX state."""
    meta = {"sim": dict(imu_rate=100.0, cam_rate=10.0, num_cams=2,
                        num_pts=12, map_size=128, duration=2.0),
            "traj": None, "seed": 0, "calib": RENDERED_META["calib"]}
    sim, _, run = convert.stage_stream(meta, "cpu")
    kw = dict(max_clones=5, max_slam=4, num_cams=2, max_msckf_in_update=8,
              integration="analytical")
    jc, tc = JCfg(**kw), TCfg(**kw)
    jr = jax_run_of_port(run)
    state = jman.initialize_from_gt(
        jc, jr.gt_q[0], jr.gt_p[0], jr.gt_v[0], sim.bias_g_traj[0].numpy(),
        sim.bias_a_traj[0].numpy(), 0.0,
        jax.vmap(jlie.rot_2_quat)(jnp.asarray(sim.cam_R_ItoC.numpy())),
        sim.cam_p_IinC.numpy(), sim.cam_intr.numpy())
    table = jft.init_table(jc, 64)
    tri_j, tri_t = (jtri.TriangulationOptions(max_runs=2),
                    ttri.TriangulationOptions(max_runs=2))
    step = jax.jit(lambda s, tb, f: jman.step_frame(s, tb, jc, tri_j, f))
    n_slam = []
    for k in range(run.frames.t_new.shape[0]):
        frame = jax.tree_util.tree_map(lambda a: a[k], jr.frames)
        post = step(state, table, frame)
        n_slam.append(_check_step(state, table, tc, tri_t,
                                  trun.frame_at(run.frames, k), post, jc,
                                  f"frame {k}"))
        state, table = post[0], post[1]
    assert max(n_slam) > 0, "SLAM never engaged"
    assert jax_state_to_port(state).cov.shape[0] == tc.state_dim


def test_stereo_tracksim_loop_matches_jax():
    """bench.py's rendered stream's TrackSIM frames (with pixel noise)
    through the port's `run_filter` in the rendered pipeline's filter
    configuration, against JAX's `run_filter` on the same staging."""
    ref = convert.load_reference(RENDERED_REF)
    meta = tracksim_meta(ref["meta"])
    sim, _, run = convert.stage_stream(meta, "cpu")
    np.testing.assert_allclose(np_of(run.gt_p), ref["digest_gt_p"], rtol=0,
                               atol=1e-5)
    st, outs = trun.run_filter(
        TCfg(**meta["cfg"]), ttri.TriangulationOptions(), trun.sim_calib(sim),
        run, max_tracks=meta["max_tracks"], device="cpu")
    qs, ps, _, covs6, diag = outs
    rmse, nees = trun.pose_metrics(qs, ps, covs6, run.gt_q, run.gt_p)
    assert bool(torch.isfinite(st.cov).all())
    assert abs(rmse - ref["ref_tracksim_rmse"]) <= 0.01, rmse
    jax_nees = ref["ref_tracksim_nees"]
    assert abs(nees - jax_nees) <= 0.25 * jax_nees, (nees, jax_nees)
    assert float(diag.n_slam.float().mean()) > 0


@pytest.mark.slow
def test_rendered_replay_matches_jax():
    """chip_smoke.py's `rendered_replay` gates on the CPU: bench.py's
    752x480 stereo pipeline on the port's CPU staging, the tracker handed
    the JAX RANSAC sets recorded in the reference for the first 40 frames:
    JAX's packets (ids and masks exactly, points within 5e-3 px) and
    `run_filter_rendered`'s per-frame counts exactly and poses within
    1e-4."""
    from chip_smoke import phase_rendered_replay

    row = phase_rendered_replay(convert.load_reference(RENDERED_REF),
                                device="cpu")
    assert row["frames"] == 40 and row["n_slam_mean"] > 0
