"""The port's simulator against the JAX package, at small sizes.

* `bspline`: `fit`, `pose`, `velocity`, `acceleration`, `imu_measurement`
  on the sine trajectory and on the in-repo V1_02 groundtruth file.  The
  port takes the derivatives in closed form where JAX differentiates
  forward through the pose: rotations agree within 2e-6, positions within
  2e-5 m (from a few metres), ω and v within 1e-4 and ω̇, a and a_m within
  2e-3 of 1 + their largest entry (the second derivative in f32 through
  three SE(3) exponentials; tests/test_sim.py holds the reference to 1e-3
  and 5e-3 of finite differences);
* `trajectories`: `load_trajectory_file`, `load_trajectory_padded`,
  `motion_skip` on `results/suite/truths/V1_02_medium.txt`;
* `undistort` (radtan, equidistant) and the new `lie` functions;
* `build`, `get_imu`, `get_cam`, `get_state`, `perturb_calib` and
  `stage_run` with the JAX simulator's own draws injected: one camera,
  and (marked slow) two equidistant cameras and `distance_threshold > 0`.  Ids and masks are
  exact, except in a (frame, camera) that holds a map point whose
  noise-free pixel lies within 1e-3 px of the image border or whose depth
  lies within 1e-6 m of `min_view_depth` (an f32 rounding can flip its
  visibility); the test shows that every difference is in such a place.
  Floats: times 1e-6 s, map points 1e-5 m, IMU ω 1e-5 rad/s and a
  1e-4 m/s², pixels
  1e-3 px where both are valid, normalized coordinates 1e-5, groundtruth
  1e-5;
* the port's copies of `eval/alignment.py` and `eval/metrics.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.eval import metrics as jmetrics
from open_vins_tpu.models import runner as jrun
from open_vins_tpu.ops import cameras as jcam
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu.sim import bspline as jbs
from open_vins_tpu.sim import simulator as jsim
from open_vins_tpu.sim import trajectories as jtraj
from open_vins_tpu_torch import convert
from open_vins_tpu_torch.eval import metrics as tmetrics
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.ops import cameras as tcam
from open_vins_tpu_torch.ops import lie as tlie
from open_vins_tpu_torch.sim import bspline as tbs
from open_vins_tpu_torch.sim import simulator as tsim
from open_vins_tpu_torch.sim import trajectories as ttraj
from torch_port_helpers import (jax_calib_draws, jax_sim_draws, np_of, t)

V102 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "results", "suite", "truths", "V1_02_medium.txt")
CPU = "cpu"


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def _rel(got, want, rel, what=""):
    want = np.asarray(want)
    _close(got, want, rel * (1.0 + np.abs(want).max()), what)


# both sources give 300 control points, so one compiled JAX evaluation
# serves both
N_CTRL = 300
SINE_DURATION = (N_CTRL - 8) * 0.1


@jax.jit
def _jax_spline_outputs(sp, ts):
    g = jnp.asarray([0.0, 0.0, 9.81])
    return (jax.vmap(lambda x: jbs.pose(sp, x))(ts)
            + jax.vmap(lambda x: jbs.velocity(sp, x))(ts)
            + jax.vmap(lambda x: jbs.acceleration(sp, x))(ts)
            + jax.vmap(lambda x: jbs.imu_measurement(sp, x, g))(ts))


@pytest.mark.parametrize("source", ["sine", "v102"])
def test_bspline_matches_jax(source):
    if source == "sine":
        traj_j = jsim.sine_trajectory(SINE_DURATION)
        traj_t = tsim.sine_trajectory(SINE_DURATION, device=CPU)
    else:
        traj_j, _ = jtraj.load_trajectory_padded(V102, N_CTRL)
        traj_t, _ = ttraj.load_trajectory_padded(V102, N_CTRL, device=CPU)
    assert traj_j[0].shape == (N_CTRL,)
    for a, b in zip(traj_t, traj_j):
        _close(a, b, 1e-6, "trajectory")
    sp_j, sp_t = jbs.fit(*traj_j), tbs.fit(*traj_t)
    for k in ("ctrl_R", "ctrl_p", "omegas", "dt", "t0"):
        _close(getattr(sp_t, k), getattr(sp_j, k), 2e-6, k)
    span = float(traj_j[0][-1])
    ts = np.random.default_rng(1).uniform(0.2, span - 0.2, 64).astype(
        np.float32)
    want = _jax_spline_outputs(sp_j, ts)
    tt = t(ts)
    got = (tbs.pose(sp_t, tt) + tbs.velocity(sp_t, tt)
           + tbs.acceleration(sp_t, tt)
           + tbs.imu_measurement(sp_t, tt, t([0.0, 0.0, 9.81])))
    _close(got[0], want[0], 2e-6, "R")
    _close(got[1], want[1], 2e-5, "p")
    for g, w, rel, what in zip(
            got[2:], want[2:],
            (1e-4, 1e-4, 1e-4, 2e-3, 1e-4, 2e-3, 1e-4, 2e-3),
            ("w", "v", "w", "wdot", "v", "a", "w_m", "a_m")):
        _rel(g, w, rel, what)


def test_trajectories_match_jax():
    t_j, R_j, p_j = jtraj.load_trajectory_file(V102)
    t_t, R_t, p_t = ttraj.load_trajectory_file(V102, device=CPU)
    for a, b in ((t_t, t_j), (R_t, R_j), (p_t, p_j)):
        _close(a, b, 1e-6)
    (traj_j, valid_j) = jtraj.load_trajectory_padded(V102, 920, t_skip=2.0)
    (traj_t, valid_t) = ttraj.load_trajectory_padded(V102, 920, t_skip=2.0,
                                                     device=CPU)
    assert valid_t == valid_j
    for a, b in zip(traj_t, traj_j):
        _close(a, b, 1e-6)
    for skip, off in ((0.0, 3.0), (5.0, 1.0)):
        assert (ttraj.motion_skip(V102, skip, off)
                == jtraj.motion_skip(V102, skip, off))
    assert ttraj.EUROC_START_SKIP == jtraj.EUROC_START_SKIP


def test_undistort_and_lie_match_jax():
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 752, 200), rng.uniform(0, 480, 200)],
                  -1).astype(np.float32)
    radtan = np.asarray([458.654, 457.296, 367.215, 248.375, -0.2834,
                         0.0739, 2e-4, 1.76e-5], np.float32)
    equi = np.asarray([380.0, 381.0, 370.0, 240.0, -0.01, 0.02, -0.003,
                       0.001], np.float32)
    for model, zeta in ((tcam.RADTAN, radtan), (tcam.EQUI, equi)):
        _close(tcam.undistort(model, t(zeta), t(uv)),
               jcam.undistort(model, jnp.asarray(zeta), jnp.asarray(uv)),
               1e-5, model)
    v = (rng.normal(size=(32, 6)) * [1, 1, 1, 2, 2, 2]).astype(np.float32)
    v[:4, :3] *= 1e-5  # the small-angle branches
    T = jax.vmap(jlie.exp_se3)(v)
    _close(tlie.exp_se3(t(v)), T, 1e-5, "exp_se3")
    _close(tlie.log_se3(t(T)), jax.vmap(jlie.log_se3)(T), 5e-5, "log_se3")
    _close(tlie.hat_se3(t(v)), jax.vmap(jlie.hat_se3)(v), 0, "hat_se3")
    _close(tlie.inv_se3(t(T)), jax.vmap(jlie.inv_se3)(T), 1e-5, "inv_se3")
    _close(tlie.Jl_so3_inv(t(v[:, :3])), jax.vmap(jlie.Jl_so3_inv)(v[:, :3]),
           1e-5, "Jl_so3_inv")
    M = jax.vmap(jlie.skew)(v[:, :3])
    _close(tlie.unskew(t(M)), jax.vmap(jlie.unskew)(M), 0, "unskew")
    q = rng.normal(size=(8, 4)).astype(np.float32)
    _close(tlie.quat_inv(t(q)), jax.vmap(jlie.quat_inv)(q), 0, "quat_inv")


SIM = dict(imu_rate=200.0, cam_rate=20.0, num_pts=50, map_size=256,
           duration=2.0, start_offset=3.0)
# one camera (the main path's) in the default run; the other two cases
# each cost a JAX simulator compile (about 15-20 s on a CPU) and are slow
CASES = [
    pytest.param("one_cam", dict(num_cams=1), id="one_cam"),
    pytest.param("two_equi_cams", dict(num_cams=2, cam_model="equi"),
                 id="two_equi_cams", marks=pytest.mark.slow),
    pytest.param("distance_threshold",
                 dict(num_cams=1, distance_threshold=0.5),
                 id="distance_threshold", marks=pytest.mark.slow),
]


def _calib(params):
    """The default calibration; equidistant coefficients for equi."""
    intr, R, p = jsim.default_calib(params)
    if params.cam_model == "equi":
        intr = intr.at[:, 4:].set(jnp.asarray([-0.01, 0.02, -0.003, 0.001]))
    return intr, R, p


def _near_gate(sim, params, k, c):
    """Camera c at frame k sees a map point within 1e-3 px of the image
    border or within 1e-6 m of min_view_depth."""
    edge, depth = tsim.view_margins(sim, params, k, c)
    return bool(((edge < 1e-3) | (depth < 1e-6)).any())


@pytest.mark.parametrize("case,extra", CASES)
def test_simulator_matches_jax(case, extra):
    """build, get_imu, get_cam, get_state and stage_run (which calls the
    other three over every step and frame) with JAX's draws."""
    kw = dict(SIM, **extra)
    pj, pt = jsim.SimParams(**kw), tsim.SimParams(**kw)
    calib = _calib(pj)
    if pj.distance_threshold > 0:  # a host loop: not traceable
        sim_j = jsim.build(pj, seed=0, calib=calib)
    else:
        sim_j = jax.jit(lambda c: jsim.build(pj, seed=0, calib=c))(calib)
    run_j = jax.jit(lambda s: jrun.stage_run(s, pj))(sim_j)
    sim_t = tsim.build(pt, calib=tuple(t(x) for x in calib),
                       draws=jax_sim_draws(pj, 0), device=CPU)
    run_t = trun.stage_run(sim_t, pt)

    assert float(sim_t.t_start) == float(sim_j.t_start)
    if case == "distance_threshold":
        assert float(sim_t.t_start) > float(sim_t.spline.t0) + pt.start_offset
    _close(sim_t.map_pts, sim_j.map_pts, 1e-5, "map_pts")
    for k in ("bias_g_traj", "bias_a_traj"):
        _close(getattr(sim_t, k), getattr(sim_j, k), 1e-7, k)

    ft, fj = run_t.frames, run_j.frames
    # times to 1e-6 s: XLA's fused program rounds t_start + n·dt − t_start
    # up to 2 ulp differently from the reference's own eager run
    _close(ft.t_new, fj.t_new, 1e-6, "t_new")
    _close(ft.win.t, fj.win.t, 1e-6, "win.t")
    _close(ft.win.w, fj.win.w, 1e-5, "win.w")
    _close(ft.win.a, fj.win.a, 1e-4, "win.a")
    ids_t, ids_j = np_of(ft.ids), np.asarray(fj.ids)
    m_t, m_j = np_of(ft.mask), np.asarray(fj.mask)
    assert ids_t.dtype == ids_j.dtype and m_t.dtype == m_j.dtype
    assert m_j.sum(-1).min() >= 10, "too few visible points per frame"
    differ = ((ids_t != ids_j).any(-1) | (m_t != m_j).any(-1))  # [K-1, C]
    for k, c in zip(*np.nonzero(differ)):
        assert _near_gate(sim_t, pt, k + 1, c), \
            f"frame {k + 1} camera {c}: ids differ away from the gates"
    # the margins agree with the port's own visibility at one frame: every
    # valid selected point is in front of the gate, inside the image
    edge, _ = tsim.view_margins(sim_t, pt, 1, 0)
    sel = ids_t[0, 0][m_t[0, 0]]
    assert len(sel) and np.isfinite(np_of(edge)[sel]).all()
    same = ~differ[..., None] & m_t & m_j
    _close(np_of(ft.uv)[same], np.asarray(fj.uv)[same], 1e-3, "uv")
    _close(np_of(ft.uvn)[same], np.asarray(fj.uvn)[same], 1e-5, "uvn")
    for k in ("gt_q", "gt_p", "gt_v"):
        _close(getattr(run_t, k), getattr(run_j, k), 1e-5, k)

    # the true biases at the nearest IMU step of arbitrary relative times
    tr = np.asarray([0.0, 0.333, 1.0, 1.999], np.float32)
    step = np.clip(np.round(tr * pj.imu_rate).astype(np.int32), 0,
                   jsim.n_imu_steps(pj))
    _, _, _, bg, ba = tsim.get_state(sim_t, pt, t(tr))
    _close(bg, np.asarray(sim_j.bias_g_traj)[step], 1e-7, "bg")
    _close(ba, np.asarray(sim_j.bias_a_traj)[step], 1e-7, "ba")
    cal = trun.sim_calib(sim_t)
    _close(cal.bias_g0, sim_j.bias_g_traj[0], 0, "sim_calib")


def test_perturb_calib_matches_jax():
    params = jsim.SimParams(num_cams=2, duration=4.0)
    calib = jsim.default_calib(params)
    calib_t = tsim.default_calib(tsim.SimParams(num_cams=2, duration=4.0),
                                 device=CPU)
    for a, b in zip(calib_t, calib):
        _close(a, b, 1e-6, "default_calib")
    for kw in (dict(), dict(imu_intrinsics=True, g_sensitivity=True,
                            calib_dt=0.01)):
        want = jax.jit(lambda c: jsim.perturb_calib(3, c, **kw))(calib)
        got = tsim.perturb_calib(3, calib_t, draws=jax_calib_draws(2, 3),
                                 device=CPU, **kw)
        for k in want._fields:
            _close(getattr(got, k), getattr(want, k), 2e-6, k)


def test_port_draws_are_seeded():
    """Same seed, same draws; another seed, others (test_sim_repeat); the
    records survive a trip through numpy."""
    params = tsim.SimParams(num_pts=8, map_size=32, duration=0.5)
    a, b, c = (tsim.draw(params, s) for s in (7, 7, 8))
    a2 = convert.sim_draws_from_numpy(convert.sim_draws_to_numpy(a))
    for k, v in a.items():
        assert torch.equal(v, getattr(b, k)), k
        assert torch.equal(v, getattr(a2, k)) and v.dtype == getattr(a2, k).dtype
    assert not torch.equal(a.pix, c.pix)
    assert a.pix.shape == (10, 1, 8, 2) and a.imu_w.shape == (101, 3)
    d = tsim.draw_calib(2, 7)
    d2 = convert.calib_draws_from_numpy(convert.calib_draws_to_numpy(d))
    for k, v in d.items():
        assert torch.equal(v, getattr(d2, k)), k


def test_eval_copies_match_jax():
    rng = np.random.default_rng(3)
    n = 60
    gt_p = np.cumsum(rng.normal(size=(n, 3)) * 0.3, axis=0)
    est_p = gt_p + rng.normal(size=(n, 3)) * 0.05
    gt_R = np.asarray(jax.vmap(jlie.exp_so3)(rng.normal(size=(n, 3)) * 0.5))
    est_R = np.asarray(jax.vmap(jlie.exp_so3)(
        rng.normal(size=(n, 3)) * 0.01)) @ gt_R
    for method in ("posyaw", "se3", "sim3", "none"):
        for a, b in zip(tmetrics.ate(est_p, est_R, gt_p, gt_R, method),
                        jmetrics.ate(est_p, est_R, gt_p, gt_R, method)):
            np.testing.assert_allclose(list(vars(a).values()),
                                       list(vars(b).values()), rtol=1e-9)
    cov = np.einsum("nij,nkj->nik", *(2 * [rng.normal(size=(n, 6, 6))])) \
        * 1e-3 + 1e-3 * np.eye(6)
    for a, b in zip(tmetrics.nees(est_p, est_R, gt_p, gt_R, cov),
                    jmetrics.nees(est_p, est_R, gt_p, gt_R, cov)):
        # JAX's log map runs in float32, the port's in float64
        np.testing.assert_allclose(list(vars(a).values()),
                                   list(vars(b).values()), rtol=1e-4)
    got = tmetrics.rpe(est_p, est_R, gt_p, gt_R, (2.0, 4.0))
    want = jmetrics.rpe(est_p, est_R, gt_p, gt_R, (2.0, 4.0))
    for L in want:
        for a, b in zip(got[L], want[L]):
            np.testing.assert_allclose(list(vars(a).values()),
                                       list(vars(b).values()), rtol=1e-9)
