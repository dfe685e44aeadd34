"""Calibration estimated in closed loop, the port against the JAX package:
the prior-and-perturbation loops of tests/test_stereo_calib.py:76-81 (the
camera extrinsics perturbed, with a 0.02 prior), :142-173 (the camera-IMU
time offset with a 0.02 s prior) and tests/test_imu_intrinsics.py:58-88
(the gyro distorted by a scale-and-skew matrix S, Dw with a 0.05 prior).

Each loop starts both packages from the same state (built from the same
numpy arrays) and runs both over the same frames.  In tier-1 it runs the
first 30 frames (1.5 s) of the committed fixture (`msckf_sim20_seed0.npz`:
11 clones, 200 points, <= 40 MSCKF features, rk4), and every frame's
position and calibration values must lie within 1e-3 of JAX's (f32 closed
loops drift apart slowly; the reference's update forms differ from one
another by up to 1.05e-2 m over 20 s).  The slow versions run the JAX
tests' own streams at their full lengths (12 s, 12 s, 15 s; staged by the
JAX simulator and handed to the port) and hold the end values of the
calibration within 2e-3 of JAX's and the position RMSE within 0.01 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import feature_table as jft
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import triangulation as jtri
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import feature_table as tft
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import triangulation as ttri
from torch_port_helpers import (fixture_problem, jax_frames_to_port,
                                jax_state_to_port, np_of)

GYRO_S = np.array([[1.03, 0.0, 0.0], [0.01, 0.97, 0.0], [0.0, 0.005, 1.02]],
                  np.float32)
# kind -> (FilterConfig flags, the calibration values read per frame)
KINDS = {
    "extrinsics": (dict(calib_cam_extrinsics=True),
                   ("calib_ext_q", "calib_ext_p")),
    "time_offset": (dict(calib_cam_timeoffset=True), ("calib_dt",)),
    "imu_intrinsics": (dict(calib_imu_intrinsics=True), ("imu_dw",)),
}


def _start(kind, cfg, st):
    """The JAX start state of a loop: the test's perturbation and prior."""
    diag = jnp.diagonal(st.cov)
    if kind == "extrinsics":
        dth = jnp.asarray([0.01, -0.015, 0.008])
        R = jlie.quat_2_rot(st.calib_ext_q[0])
        st = st._replace(
            calib_ext_q=jlie.rot_2_quat(jlie.exp_so3(-dth) @ R)[None],
            calib_ext_p=st.calib_ext_p + jnp.asarray([0.01, -0.005, 0.008]))
        diag = diag.at[cfg.calib_ext_off:cfg.calib_ext_off + 6].set(0.02**2)
    elif kind == "time_offset":
        diag = diag.at[cfg.calib_dt_off].set(0.02**2)
    else:
        diag = diag.at[cfg.imu_dw_off:cfg.imu_dw_off + 6].set(0.05**2)
        diag = diag.at[cfg.imu_thw_off:cfg.imu_thw_off + 3].set(1e-6)
    return jekf.set_initial_covariance(st, cfg, diag)


def _frames(kind, frames):
    """The frames the loop sees: the gyro distorted by GYRO_S for the
    intrinsics loop (w_m = S w_true)."""
    if kind != "imu_intrinsics":
        return frames
    w = jnp.einsum("ij,fkj->fki", jnp.asarray(GYRO_S), frames.win.w)
    return frames._replace(win=frames.win._replace(w=w))


def _loops(kind, state, frames, base_kw, n, max_tracks):
    """Both packages over the first n frames from the same start:
    per-frame (p, calibration values) of JAX and of the port, and the
    configurations."""
    flags, keys = KINDS[kind]
    kw = dict(base_kw, **flags)
    jc, tc = JCfg(**kw), TCfg(**kw)
    st0 = _start(kind, jc, jman.initialize_from_gt(
        jc, state.q, state.p, state.v, state.bg, state.ba, 0.0,
        state.calib_ext_q, state.calib_ext_p, state.calib_intr))
    frames = jax.tree_util.tree_map(lambda a: jnp.asarray(a[:n]),
                                    _frames(kind, frames))

    def body(carry, frame):
        st, tb = carry
        st, tb, _ = jman.step_frame(st, tb, jc, jtri.TriangulationOptions(),
                                    frame)
        return (st, tb), (st.p,) + tuple(getattr(st, k) for k in keys)

    _, outs_j = jax.jit(lambda s, f: jax.lax.scan(
        body, (s, jft.init_table(jc, max_tracks)), f))(st0, frames)
    st, tb = jax_state_to_port(st0), tft.init_table(tc, max_tracks, "cpu")
    frames_t = jax_frames_to_port(frames)
    outs_t = []
    for k in range(n):
        st, tb, _ = tman.step_frame(st, tb, tc, ttri.TriangulationOptions(),
                                    trun.frame_at(frames_t, k))
        assert torch.isfinite(st.cov).all(), f"frame {k}"
        outs_t.append((st.p,) + tuple(getattr(st, k) for k in keys))
    outs_t = [np.stack([np_of(o[i]) for o in outs_t])
              for i in range(len(outs_j))]
    return [np.asarray(o) for o in outs_j], outs_t


@pytest.mark.parametrize("kind", list(KINDS))
def test_calibration_loop_matches_jax(kind):
    """The first 30 frames of the fixture: positions and calibration
    values within 1e-3 of JAX's on every frame, and the calibration
    moving (the prior lets the updates reach it)."""
    pb = fixture_problem()
    base = dict(pb.cfg_jax._asdict())
    outs_j, outs_t = _loops(kind, pb.state, pb.frames, base, 30, 384)
    for i, (j, t_) in enumerate(zip(outs_j, outs_t)):
        np.testing.assert_allclose(t_, j, rtol=0, atol=1e-3,
                                   err_msg=f"{kind} output {i}")
    moved = np.abs(outs_j[1][-1] - outs_j[1][0]).max()
    assert moved > 0, f"{kind}: the calibration did not move"


def _jax_stream(params_kw, seed, calib_dt=0.0):
    """A JAX simulator stream of the calibration tests (the JAX package's
    staging, handed to both packages): (start state, frames, gt_p)."""
    from open_vins_tpu.models import runner as jrun
    from open_vins_tpu.sim import simulator

    params = simulator.SimParams(**params_kw)
    sim = simulator.build(params, seed=seed, calib_dt=calib_dt)
    run = jrun.stage_run(sim, params)
    jc = JCfg()
    st = jman.initialize_from_gt(
        jc, run.gt_q[0], run.gt_p[0], run.gt_v[0], sim.bias_g_traj[0],
        sim.bias_a_traj[0], 0.0, jax.vmap(jlie.rot_2_quat)(sim.cam_R_ItoC),
        sim.cam_p_IinC, sim.cam_intr)
    return st, run.frames, np.asarray(run.gt_p)[1:]


@pytest.mark.slow
@pytest.mark.parametrize("kind,seed,duration,calib_dt", [
    ("extrinsics", 44, 12.0, 0.0), ("time_offset", 17, 12.0, 0.008),
    ("imu_intrinsics", 77, 15.0, 0.0)])
def test_calibration_loop_full_length_matches_jax(kind, seed, duration,
                                                  calib_dt):
    """The JAX tests' own streams and lengths: the calibration's end values
    within 2e-3 of JAX's, the position RMSE within 0.01 m of JAX's."""
    params = dict(imu_rate=200.0, cam_rate=20.0, num_cams=1, num_pts=40,
                  map_size=1024, duration=duration, sigma_pix=1.0)
    st, frames, gt_p = _jax_stream(params, seed, calib_dt)
    base = dict(max_clones=11, max_slam=0, num_cams=1,
                max_msckf_in_update=30)
    n = frames.t_new.shape[0]
    outs_j, outs_t = _loops(kind, st, frames, base, n, 256)
    for i in range(1, len(outs_j)):
        np.testing.assert_allclose(outs_t[i][-1], outs_j[i][-1], rtol=0,
                                   atol=2e-3, err_msg=f"{kind} output {i}")
    rmse_j = np.sqrt(((outs_j[0] - gt_p) ** 2).sum(1).mean())
    rmse_t = np.sqrt(((outs_t[0] - gt_p) ** 2).sum(1).mean())
    assert abs(rmse_t - rmse_j) <= 0.01, (rmse_t, rmse_j)
