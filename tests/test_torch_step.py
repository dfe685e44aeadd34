"""The port's MSCKF-only slice as a whole against the JAX package:

* `step_frame` step for step over all 9 frames of
  `__graft_entry__._build_problem()` (5 clones, 12 points, 10 Hz, 1 s);
* one `step_frame` at the reference widths (11 clones, 200 points, <= 40
  MSCKF features) from the JAX state 15 frames into the staged run, where
  the window is full and the update fires, and from the state 12 frames in,
  the busiest early update (25 features);
* a closed loop at the tests/test_e2e_sim.py size (45 points, 8 s, seed 21;
  marked slow).

Step for step means that at every frame both packages step from the same
(JAX) state and table.  Tolerances: state values 1e-4, covariance
1e-5·‖P‖∞ (the row-sum norm, as the kernel check takes it), the per-frame
MSCKF feature counts equal.  ‖P‖∞ and not max|P_ij|: an update's covariance
is reproducible in f32 only to a few 1e-5 of max|P_ij| when a feature's
triangulation is ill-conditioned, and the reference does not meet the
max|P_ij| reading against itself — JAX jit against JAX eager on the same step
differs by up to 4.7e-5·max|P_ij| on these runs
(tests/torch_step_spread.py prints both gaps per frame).
"""

import jax
import numpy as np
import pytest
import torch

from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import runner as jrun
from open_vins_tpu.models import triangulation as jtri
from open_vins_tpu.sim import simulator
from open_vins_tpu_torch.core import ekf as tekf
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import triangulation as ttri
from open_vins_tpu_torch.models import update_helper as tuh
from torch_port_helpers import (Problem, assert_state_close,
                                assert_table_equal, fixture_problem,
                                graft_problem, jax_frames_to_port,
                                jax_state_to_port, jax_table_to_port, np_of,
                                t)


def near_gate_features(state, table, cfg, tri_opts, rel=1e-3):
    """Table ids of the port's candidate features whose χ² lies within
    `rel` of its gate (a feature the two packages may gate differently on
    rounding alone)."""
    score = np_of(tman.ft.row_obs_counts(table)).astype(np.float32)
    fullw = (tman.ft.full_window_rows(table, state.n_clones, cfg)
             & (state.n_clones >= cfg.max_clones))
    cand = np_of(tman.ft.lost_rows(table) | fullw)
    rows = tman.select_candidates(torch.as_tensor(np.where(cand, score, -1.0)),
                                  cfg.max_msckf_in_update)
    tri_obs, gobs = tman.gather_feature_obs(state, cfg, table, rows)
    p_f, _ = ttri.triangulate_batch(tri_obs, tri_opts)
    ctx = tuh.obs_context(state, cfg, gobs.clone_slot[0], gobs.cam[0])
    H_x, H_f, res, rm = tuh.feature_jacobian_batch(state, cfg, gobs, p_f,
                                                   p_f, ctx)
    H, r = tuh.nullspace_project(H_x, H_f, res)
    sup = cfg.cam_meas_support_ranges
    P_ss = tuh.take_cols(tuh.take_cols(state.cov, sup).T, sup)
    gamma = np_of(tuh.chi2_statistic(P_ss, tuh.take_cols(H, sup), r,
                                     cfg.sigma_pix))
    gate = np_of(tekf.chi2_gate((rm.sum(-1) - 3).clamp(min=1)))
    near = np.abs(gamma - gate) <= rel * gate
    return np_of(table.ids)[np_of(rows)][near].tolist()


def _pre_update(st_t, tb_t, cfg_t, tri_t, frame_t):
    """The port's state and table as `msckf_update` receives them in
    `step_frame` (after marginalization, propagation, cloning, ingest)."""
    seen = {}
    msckf_update = tman.msckf_update

    def record(state, cfg, table, tri_opts):
        seen.update(state=state, table=table)
        return msckf_update(state, cfg, table, tri_opts)

    tman.msckf_update = record
    try:
        tman.step_frame(st_t, tb_t, cfg_t, tri_t, frame_t)
    finally:
        tman.msckf_update = msckf_update
    return seen["state"], seen["table"]


def _check_step(st_j, tb_j, cfg_t, tri_t, frame_t, post_j, where):
    """Step the port from the JAX state (st_j, tb_j) and compare with the
    JAX step's result post_j = (state, table, diag)."""
    st_t, tb_t = jax_state_to_port(st_j), jax_table_to_port(tb_j)
    st_o, tb_o, d_t = tman.step_frame(st_t, tb_t, cfg_t, tri_t, frame_t)
    n_t, n_j = int(d_t.n_msckf), int(post_j[2].n_msckf)
    if n_t != n_j:
        near = near_gate_features(*_pre_update(st_t, tb_t, cfg_t, tri_t,
                                               frame_t), cfg_t, tri_t)
        pytest.fail(f"{where}: n_msckf {n_t} (port) vs {n_j} (JAX); "
                    f"features within 1e-3 of their chi2 gate: {near}")
    assert_state_close(st_o, post_j[0], atol=1e-4, cov_rel=1e-5,
                       where=where, cov_norm="inf")
    assert_table_equal(tb_o, post_j[1], where=where)
    return n_j


def _jax_steps(pb: Problem, n_frames):
    """Yield (k, state and table before frame k, the JAX step's result) for
    the first n_frames frames of a problem."""
    step = jax.jit(lambda s, tb, f: jman.step_frame(s, tb, pb.cfg_jax,
                                                    pb.tri_jax, f))
    state, table = pb.state, pb.table
    for k in range(n_frames):
        post = step(state, table,
                    jax.tree_util.tree_map(lambda a: a[k], pb.frames))
        yield k, state, table, post
        state, table = post[0], post[1]


def test_step_frame_parity_graft_problem():
    """All 9 frames of the `entry()` problem, step for step."""
    pb = graft_problem()
    frames_t = jax_frames_to_port(pb.frames)
    assert frames_t.t_new.shape[0] == 9
    used = sum(
        _check_step(state, table, pb.cfg_port, pb.tri_port,
                    trun.frame_at(frames_t, k), post, f"frame {k}")
        for k, state, table, post in _jax_steps(pb, 9))
    assert used > 0, "the update never fired"


WIDE_FRAMES = (12, 15)


@pytest.fixture(scope="module")
def wide_run():
    """The staged reference-width run stepped by JAX: for each frame k of
    WIDE_FRAMES, (state and table before frame k, JAX step result, port
    frame)."""
    pb = fixture_problem()
    cases = {k: (state, table, post, jax_frames_to_port(
        jax.tree_util.tree_map(lambda a: a[k], pb.frames)))
        for k, state, table, post in _jax_steps(pb, max(WIDE_FRAMES) + 1)
        if k in WIDE_FRAMES}
    return pb, cases


@pytest.mark.parametrize("k", WIDE_FRAMES)
def test_step_frame_parity_reference_widths(wide_run, k):
    """One full-width step from the JAX state k frames into the staged run
    (window full, MSCKF update firing)."""
    pb, cases = wide_run
    state, table, post, frame_t = cases[k]
    assert int(state.n_clones) == pb.cfg_port.max_clones
    n = _check_step(state, table, pb.cfg_port, pb.tri_port, frame_t, post,
                    f"frame {k}")
    assert n > 0, "the update did not fire"


E2E_PARAMS = simulator.SimParams(imu_rate=200.0, cam_rate=20.0, num_cams=1,
                                 num_pts=45, map_size=1024, duration=8.0,
                                 sigma_pix=1.0)
E2E_CFG = dict(max_clones=11, max_slam=0, num_cams=1, max_msckf_in_update=30)


@pytest.mark.slow
def test_closed_loop_e2e_size():
    """Port and JAX closed loops on the same staged frames: both within
    tests/test_e2e_sim.py's gates and within 0.01 m RMSE of each other (the
    chaotic spread between the reference's own update forms).  Slow (about a
    minute, most of it staging the simulator in JAX); `chip_smoke.py` holds
    the full-width 399-frame closed loop to the JAX run on every GPU run."""
    sim = simulator.build(E2E_PARAMS, seed=21)
    run = jrun.stage_run(sim, E2E_PARAMS)
    jc, tc = JCfg(**E2E_CFG), TCfg(**E2E_CFG)
    st_j, outs_j = jax.jit(lambda r: jrun.run_filter(
        jc, jtri.TriangulationOptions(), sim, E2E_PARAMS, r))(run)
    calib = trun.SimCalib(
        bias_g0=t(sim.bias_g_traj[0]), bias_a0=t(sim.bias_a_traj[0]),
        cam_R_ItoC=t(sim.cam_R_ItoC), cam_p_IinC=t(sim.cam_p_IinC),
        cam_intr=t(sim.cam_intr))
    run_t = trun.SimRun(frames=jax_frames_to_port(run.frames),
                        gt_q=t(run.gt_q), gt_p=t(run.gt_p),
                        gt_v=t(run.gt_v))
    st_t, outs_t = trun.run_filter(tc, ttri.TriangulationOptions(), calib,
                                   run_t, device="cpu")
    assert np.isfinite(np_of(st_t.cov)).all()
    assert np.diagonal(np_of(st_t.cov)).min() > -1e-8
    rmse_j, _ = trun.pose_metrics(*(t(outs_j[i]) for i in (0, 1, 3)),
                                  run_t.gt_q, run_t.gt_p)
    rmse_t, _ = trun.pose_metrics(outs_t[0], outs_t[1], outs_t[3],
                                  run_t.gt_q, run_t.gt_p)
    assert rmse_t < 0.10 and rmse_j < 0.10  # test_e2e_sim's position gate
    assert abs(rmse_t - rmse_j) < 0.01, (rmse_t, rmse_j)
    # test_e2e_sim's NEES gate, over the same frames it uses
    nees_t = _e2e_nees(outs_t, run_t)
    assert 0.5 < nees_t < 10.0, nees_t
    assert np_of(outs_t[4].n_msckf)[20:].mean() > 2


def _e2e_nees(outs, run):
    """Mean pose NEES from frame 40 on, as tests/test_e2e_sim.py takes it."""
    from open_vins_tpu_torch.ops import lie

    qs, ps, covs = outs[0], np_of(outs[1]), np_of(outs[3])
    gt_q, gt_p = run.gt_q[1:], np_of(run.gt_p)[1:]
    dth = np_of(-lie.log_so3(lie.quat_2_rot(gt_q)
                             @ lie.quat_2_rot(qs).mT))
    nees = []
    for k in range(40, len(gt_p)):
        e = np.concatenate([dth[k], gt_p[k] - ps[k]])
        nees.append(e @ np.linalg.solve(covs[k] + 1e-12 * np.eye(6), e))
    return float(np.mean(nees))
