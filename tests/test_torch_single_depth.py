"""The port's 1-dof ANCHORED_INVERSE_DEPTH_SINGLE landmarks against the JAX
package: `ekf.initialize_landmark_single`, the single-depth branches of
the joint delayed init, the sequential oracle, `build_update` and
`change_anchors`, and `step_frame` step for step in the joint "qr" update
and in the reference-exact sequential ordering.

The problem is `torch_port_helpers.slam_problem` (the
`__graft_entry__._build_problem` widths: 5 clones, <= 8 MSCKF features; 4
landmark slots, ACI², on the staged frames of the fixture), where
landmarks enter from frame 5 and are re-anchored from frame 6.  The
tolerances are the SLAM step rule of tests/test_torch_slam.py: values
3e-4, the covariance 5e-5·‖P‖∞, a new landmark's block 2e-3 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import updater_slam as jslam
from open_vins_tpu_torch.core import ekf as tekf
from open_vins_tpu_torch.models import landmark_rep as trep
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import updater_slam as tslam
from test_torch_slam import (SLAM_EXACT_FIELDS, _check_step, _jax_steps,
                             assert_slam_state_close)
from torch_port_helpers import (assert_table_equal, jax_frames_to_port,
                                jax_pre_update, jax_state_to_port,
                                jax_table_to_port, np_of, slam_problem, t)

SINGLE = trep.ANCHORED_INVERSE_DEPTH_SINGLE
N_STEP_FRAMES = 16  # landmarks from frame 5, re-anchored from frame 6


@pytest.fixture(scope="module")
def single_run():
    """The small SLAM problem in the single-depth representation, stepped
    by JAX: (problem, [(state, table, post) per frame])."""
    pb = slam_problem(SINGLE)
    return pb, [(st, tb, post) for _, st, tb, post
                in _jax_steps(pb, pb.cfg_jax, N_STEP_FRAMES)]


def test_step_frame_parity_single_depth(single_run):
    pb, steps = single_run
    frames_t = jax_frames_to_port(pb.frames)
    n_slam = [_check_step(st, tb, pb.cfg_port, pb.tri_port,
                          trun.frame_at(frames_t, k), post, pb.cfg_jax,
                          f"frame {k}")
              for k, (st, tb, post) in enumerate(steps)]
    assert max(n_slam) > 0, "SLAM never engaged"


def test_step_frame_parity_single_depth_sequential():
    """The reference-exact ordering: the MSCKF update, the single-depth
    landmark update and delayed init with its own leftover update."""
    pb = slam_problem(SINGLE)
    pb = pb._replace(cfg_jax=pb.cfg_jax._replace(joint_vision_update=False),
                     cfg_port=pb.cfg_port._replace(joint_vision_update=False))
    frames_t = jax_frames_to_port(pb.frames)
    n_slam = [_check_step(st, tb, pb.cfg_port, pb.tri_port,
                          trun.frame_at(frames_t, k), post, pb.cfg_jax,
                          f"frame {k}")
              for k, st, tb, post in _jax_steps(pb, pb.cfg_jax,
                                                N_STEP_FRAMES)]
    assert max(n_slam) > 0, "SLAM never engaged"


def test_initialize_landmark_single_matches_jax():
    """The 1-dof insertion on a random system: the ρ row, column and
    corner, the value and FEJ, the leftover rows."""
    pb = slam_problem(SINGLE)
    jc, tc = pb.cfg_jax, pb.cfg_port
    rng = np.random.default_rng(4)
    D, m = jc.state_dim, 2 * jc.max_clones
    A = rng.normal(size=(D, D)).astype(np.float32)
    cov = (A @ A.T / D + np.eye(D)).astype(np.float32)
    st = pb.state._replace(cov=jnp.asarray(cov))
    H_x = rng.normal(size=(m, D)).astype(np.float32)
    h_f = rng.normal(size=(m, 1)).astype(np.float32)
    res = rng.normal(size=(m,)).astype(np.float32) * 1e-3
    mask = np.arange(m) < m - 2
    lam0 = np.array([0.3, 0.1, -0.2], np.float32)
    want = jekf.initialize_landmark_single(
        st, jc, 2, jnp.asarray(17), jnp.asarray(lam0), jnp.asarray(H_x),
        jnp.asarray(h_f), jnp.asarray(res), 0.01, jnp.asarray(mask))
    got = tekf.initialize_landmark_single(
        jax_state_to_port(st), tc, torch.tensor(2), torch.tensor(17),
        t(lam0), t(H_x), t(h_f), t(res), 0.01, torch.as_tensor(mask))
    for k in ("slam_id", "slam_valid"):
        np.testing.assert_array_equal(np_of(getattr(got[0], k)),
                                      np.asarray(getattr(want[0], k)))
    for k in ("slam_p", "slam_p_fej"):
        np.testing.assert_allclose(np_of(getattr(got[0], k)),
                                   np.asarray(getattr(want[0], k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    cov_j = np.asarray(want[0].cov)
    np.testing.assert_allclose(np_of(got[0].cov), cov_j, rtol=0,
                               atol=1e-5 * np.abs(cov_j).sum(1).max())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=0,
                                   atol=1e-5 * max(np.abs(np.asarray(w)).max(),
                                                   1e-6))


@pytest.mark.parametrize("collect", [True, False], ids=["joint", "own"])
def test_delayed_init_single_matches_jax(single_run, collect):
    """The joint batched single-depth init from a JAX pre-update state in
    which landmarks are initialized: the ρ-only mean correction, the
    insertion, the leftover rows (returned, or applied by their own
    update)."""
    pb, steps = single_run
    jc, tc = pb.cfg_jax, pb.cfg_port
    for k, (st, tb, post) in enumerate(steps):
        if (np.asarray(post[0].slam_valid) & ~np.asarray(st.slam_valid)).any():
            break
    st_j, tb_j = jax_pre_update(pb, st, tb, k)
    want = jslam.delayed_init(st_j, jc, tb_j, pb.tri_jax,
                              jman.gather_feature_obs, collect=collect)
    got = tslam.delayed_init(jax_state_to_port(st_j), tc,
                             jax_table_to_port(tb_j), pb.tri_port,
                             tman.gather_feature_obs, collect=collect)
    assert int(got[2]) == int(want[2]) > 0
    assert_slam_state_close(got[0], want[0], st_j, jc, "delayed_init")
    assert_table_equal(got[1], want[1])
    if collect:
        H_j, H_t = np.asarray(want[3]), np_of(got[3])
        assert H_t.shape == H_j.shape
        np.testing.assert_allclose(H_t, H_j, rtol=0,
                                   atol=2e-3 * np.abs(H_j).max())


def test_delayed_init_sequential_single_matches_jax(single_run):
    """The one-at-a-time oracle with the single-depth branch (the 1-dof
    `initialize_landmark_single` per candidate at the running state)."""
    pb, steps = single_run
    jc, tc = pb.cfg_jax, pb.cfg_port
    for k, (st, tb, post) in enumerate(steps):
        if (np.asarray(post[0].slam_valid) & ~np.asarray(st.slam_valid)).any():
            break
    st_j, tb_j = jax_pre_update(pb, st, tb, k)
    want = jslam._delayed_init_sequential(st_j, jc, tb_j, pb.tri_jax,
                                          jman.gather_feature_obs)
    got = tslam._delayed_init_sequential(jax_state_to_port(st_j), tc,
                                         jax_table_to_port(tb_j), pb.tri_port,
                                         tman.gather_feature_obs)
    assert int(got[2]) == int(want[2]) > 0
    assert_slam_state_close(got[0], want[0], st_j, jc, "sequential init")
    assert_table_equal(got[1], want[1])


def test_change_anchors_single_matches_jax(single_run):
    """Re-anchoring single-depth landmarks reads their current value as the
    FEJ (the reference's get_xyz(true))."""
    pb, steps = single_run
    jc = pb.cfg_jax
    # the last state with landmarks anchored off the newest clone; their
    # anchor is taken as the dying clone
    for st, _, _ in reversed(steps):
        anchors = np.asarray(st.slam_anchor_slot)[np.asarray(st.slam_valid)]
        anchors = anchors[anchors != int(st.head)]
        if anchors.size:
            break
    else:
        pytest.fail("no landmark anchored off the newest clone")
    dying = jnp.asarray(anchors[0], jnp.int32)
    moving = (np.asarray(st.slam_valid)
              & (np.asarray(st.slam_anchor_slot) == int(dying)))
    want = jax.jit(jslam.change_anchors, static_argnums=1)(st, jc, dying)
    got = tslam.change_anchors(jax_state_to_port(st), pb.cfg_port,
                               t(dying, torch.int32))
    for k in SLAM_EXACT_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    for k in ("slam_p", "slam_p_fej"):
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    cov = np.asarray(want.cov)
    np.testing.assert_allclose(np_of(got.cov), cov, rtol=0,
                               atol=1e-5 * np.abs(cov).sum(1).max())
