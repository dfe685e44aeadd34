"""The port's landmark representations against the JAX package.

* Every `landmark_rep` function for all six representations on a batch of
  random anchors and points (the five three-dof ones are what the SLAM
  updater runs; the 1-dof one has its conversions only), at 1e-5 relative
  to each output's largest entry, 1e-4 where a 3×3 inverse of the inverse
  depth Jacobian is taken (`anchor_change_jacobians`, the reference's LU
  solve against the port's adjugate);
* `change_anchors` from one JAX state with landmarks anchored on the clone
  about to be marginalized;
* `step_frame` step for step over the small SLAM problem
  (`torch_port_helpers.slam_problem`: 5 clones, 4 landmark slots, ACI²,
  the joint "qr" update) in ANCHORED_MSCKF_INVERSE_DEPTH and (marked slow)
  GLOBAL_FULL_INVERSE_DEPTH, with tests/test_torch_slam.py's tolerances;
* `runner.run_filter_from` against JAX's on a short run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import state as jstate
from open_vins_tpu.models import landmark_rep as jrep
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import runner as jrun
from open_vins_tpu.models import updater_slam as jslam
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.models import landmark_rep as trep
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import updater_slam as tslam
from test_torch_slam import (SLAM_EXACT_FIELDS, _check_step, _jax_steps,
                             assert_slam_state_close)
from torch_port_helpers import (FIXTURE, jax_frames_to_port,
                                jax_state_to_port, np_of, slam_problem, t)

ALL_REPS = [trep.GLOBAL_3D, trep.GLOBAL_FULL_INVERSE_DEPTH, trep.ANCHORED_3D,
            trep.ANCHORED_FULL_INVERSE_DEPTH,
            trep.ANCHORED_MSCKF_INVERSE_DEPTH,
            trep.ANCHORED_INVERSE_DEPTH_SINGLE]
N = 16


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (q * np.sign(q[:, 3:4])).astype(np.float32)


@pytest.fixture(scope="module")
def poses():
    """N random (old anchor, new anchor, extrinsic) triples and points
    1.5-8 m in front of the old anchor's camera."""
    rng = np.random.default_rng(0)
    q_o, q_n, q_e = _quats(rng, N), _quats(rng, N), _quats(rng, N)
    p_o = rng.normal(size=(N, 3)).astype(np.float32)
    p_n = (p_o + 0.3 * rng.normal(size=(N, 3))).astype(np.float32)
    p_e = (0.05 * rng.normal(size=(N, 3))).astype(np.float32)
    R_GtoA, p_AinG = jax.vmap(jrep.anchor_frame)(q_o, p_o, q_e, p_e)
    p_A = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                          np.ones((N, 1))], 1) * rng.uniform(1.5, 8, (N, 1))
    p_G = (np.einsum("nji,nj->ni", np.asarray(R_GtoA), p_A)
           + np.asarray(p_AinG)).astype(np.float32)
    return q_o, p_o, q_n, p_n, q_e, p_e, p_G


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np_of(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("rep", ALL_REPS)
def test_landmark_rep_functions_match_jax(rep, poses):
    q_o, p_o, q_n, p_n, q_e, p_e, p_G = poses
    T = [t(a) for a in poses]
    tq_o, tp_o, tq_n, tp_n, tq_e, tp_e, tp_G = T

    def jv(f, *a):
        return jax.vmap(lambda *x: f(rep, *x))(*a)

    lam = jv(jrep.from_global, p_G, q_o, p_o, q_e, p_e)
    _close(trep.from_global(rep, tp_G, tq_o, tp_o, tq_e, tp_e), lam, 1e-5,
           "from_global")
    tlam = t(lam)
    _close(trep.to_global(rep, tlam, tq_o, tp_o, tq_e, tp_e),
           jv(jrep.to_global, lam, q_o, p_o, q_e, p_e), 1e-5, "to_global")
    _close(trep.lam_to_pFinA(rep, tlam), jv(jrep.lam_to_pFinA, lam), 1e-5,
           "lam_to_pFinA")
    p_A = jv(jrep.lam_to_pFinA, lam)
    _close(trep.pFinA_to_lam(rep, t(p_A)), jv(jrep.pFinA_to_lam, p_A), 1e-5,
           "pFinA_to_lam")
    _close(trep.d_pFinG_d_lam(rep, tlam, tq_o, tq_e),
           jv(jrep.d_pFinG_d_lam, lam, q_o, q_e), 1e-5, "d_pFinG_d_lam")
    dth, dp = jv(jrep.d_pFinG_d_anchor, lam, q_o, q_e, p_e)
    tdth, tdp = trep.d_pFinG_d_anchor(rep, tlam, tq_o, tq_e, tp_e)
    _close(tdth, dth, 1e-5, "d_pFinG_d_anchor θ")
    _close(tdp, dp, 1e-5, "d_pFinG_d_anchor p")
    R, pa = jax.vmap(jrep.anchor_frame)(q_o, p_o, q_e, p_e)
    tR, tpa = trep.anchor_frame(tq_o, tp_o, tq_e, tp_e)
    _close(tR, R, 1e-6, "anchor_frame R")
    _close(tpa, pa, 1e-5, "anchor_frame p")
    want = jv(jrep.anchor_change_jacobians, lam, q_o, p_o, q_n, p_n, q_e,
              p_e)
    got = trep.anchor_change_jacobians(rep, tlam, tq_o, tp_o, tq_n, tp_n,
                                       tq_e, tp_e)
    for name, g, w in zip(("lam_new", "J_lam", "J_xold", "J_xnew"), got,
                          want):
        _close(g, w, 1e-4, f"anchor_change_jacobians {name}")
    assert trep.is_anchored(rep) == jrep.is_anchored(rep)
    assert trep.needs_lam_jacobian(rep) == jrep.needs_lam_jacobian(rep)


N_STEP_FRAMES = 16  # landmarks from frame 5, re-anchored from frame 6


@pytest.fixture(scope="module")
def anchored_run():
    """The small SLAM problem in ANCHORED_MSCKF_INVERSE_DEPTH, stepped by
    JAX: (problem, [(state, table, post) per frame])."""
    pb = slam_problem(trep.ANCHORED_MSCKF_INVERSE_DEPTH)
    return pb, [(st, tb, post) for _, st, tb, post
                in _jax_steps(pb, pb.cfg_jax, N_STEP_FRAMES)]


def test_change_anchors_matches_jax(anchored_run):
    """The first frame whose oldest clone anchors landmarks: both packages
    re-anchor them from the same JAX state."""
    pb, steps = anchored_run
    jc = pb.cfg_jax
    for st, _, _ in steps:
        dying = jstate.oldest_slot(st, jc)
        moving = (np.asarray(st.slam_valid)
                  & (np.asarray(st.slam_anchor_slot) == int(dying)))
        if int(st.n_clones) == jc.max_clones and moving.any():
            break
    else:
        pytest.fail("no landmark was anchored on a dying clone")
    want = jax.jit(jslam.change_anchors, static_argnums=1)(st, jc, dying)
    got = tslam.change_anchors(jax_state_to_port(st), pb.cfg_port,
                               t(dying, torch.int32))
    for k in SLAM_EXACT_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert (np.asarray(want.slam_anchor_slot)[moving]
            == int(st.head)).all()
    for k in ("slam_p", "slam_p_fej"):
        _close(getattr(got, k), getattr(want, k), 1e-5, k)
    cov = np.asarray(want.cov)
    np.testing.assert_allclose(np_of(got.cov), cov, rtol=0,
                               atol=1e-5 * np.abs(cov).sum(1).max())


def test_step_frame_parity_anchored_msckf_inverse_depth(anchored_run):
    pb, steps = anchored_run
    frames_t = jax_frames_to_port(pb.frames)
    n_slam = [_check_step(st, tb, pb.cfg_port, pb.tri_port,
                          trun.frame_at(frames_t, k), post, pb.cfg_jax,
                          f"frame {k}")
              for k, (st, tb, post) in enumerate(steps)]
    assert max(n_slam) > 0, "SLAM never engaged"


@pytest.mark.slow  # a second JAX step compile (about 15 s on a CPU)
def test_step_frame_parity_global_full_inverse_depth():
    pb = slam_problem(trep.GLOBAL_FULL_INVERSE_DEPTH)
    frames_t = jax_frames_to_port(pb.frames)
    n_slam = [_check_step(st, tb, pb.cfg_port, pb.tri_port,
                          trun.frame_at(frames_t, k), post, pb.cfg_jax,
                          f"frame {k}")
              for k, st, tb, post in _jax_steps(pb, pb.cfg_jax,
                                                N_STEP_FRAMES)]
    assert max(n_slam) > 0, "SLAM never engaged"


def test_run_filter_from_matches_jax():
    """From the groundtruth state at frame K0, over the first RUN_FROM
    frames of the staged run: the frames before K0 hold the start state
    exactly, and the stepped frames stay within 1e-3 m and 1e-3 of the
    quaternion of JAX's run (a closed loop in f32)."""
    K0, RUN_FROM = 4, 12
    pb = slam_problem(trep.ANCHORED_MSCKF_INVERSE_DEPTH)
    frames = jax.tree_util.tree_map(lambda a: a[:RUN_FROM], pb.frames)
    with np.load(FIXTURE) as z:
        a = {k: z[k] for k in ("gt_q", "gt_p", "gt_v", "bias_g0", "bias_a0",
                               "cam_R_ItoC", "cam_p_IinC", "cam_intr")}
    st0 = jman.initialize_from_gt(
        pb.cfg_jax, jnp.asarray(a["gt_q"][K0]), jnp.asarray(a["gt_p"][K0]),
        jnp.asarray(a["gt_v"][K0]), jnp.asarray(a["bias_g0"]),
        jnp.asarray(a["bias_a0"]), float(frames.t_new[K0 - 1]),
        jax.vmap(jlie.rot_2_quat)(jnp.asarray(a["cam_R_ItoC"])),
        jnp.asarray(a["cam_p_IinC"]), jnp.asarray(a["cam_intr"]))
    run_j = jrun.SimRun(frames=frames, gt_q=a["gt_q"][:RUN_FROM + 1],
                        gt_p=a["gt_p"][:RUN_FROM + 1],
                        gt_v=a["gt_v"][:RUN_FROM + 1])
    st_j, outs_j = jax.jit(lambda s: jrun.run_filter_from(
        pb.cfg_jax, pb.tri_jax, None, None, run_j, s, K0,
        max_tracks=pb.table.ids.shape[0]))(st0)
    run_t = trun.SimRun(frames=jax_frames_to_port(frames),
                        gt_q=t(run_j.gt_q), gt_p=t(run_j.gt_p),
                        gt_v=t(run_j.gt_v))
    st_t, outs_t = trun.run_filter_from(
        pb.cfg_port, pb.tri_port, run_t, jax_state_to_port(st0), K0,
        max_tracks=pb.table.ids.shape[0], device="cpu")
    for name, g, w in zip(("q", "p", "v", "cov6"), outs_t, outs_j):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(np_of(g)[:K0], w[:K0], err_msg=name)
    np.testing.assert_allclose(np_of(outs_t[1]), np.asarray(outs_j[1]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(np_of(outs_t[0]), np.asarray(outs_j[0]),
                               rtol=0, atol=1e-3)
    assert torch.isfinite(st_t.cov).all()
    assert int(st_t.slam_valid.sum()) == int(np.asarray(st_j.slam_valid).sum())

