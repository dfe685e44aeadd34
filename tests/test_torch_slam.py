"""The port's SLAM slice against the JAX package: landmarks, delayed init,
the joint "qr" vision update and ACI².

* `step_frame` step for step over the first 40 frames of a small SLAM
  configuration on the staged frames (`torch_port_helpers.slam_problem`:
  5 clones, 4 landmark slots, <= 8 MSCKF features, ACI²), in which
  landmarks are initialized, updated and evicted from frame 4 on;
* one `step_frame` at the bench's operating point (bench.py:94-96: 11
  clones, 50 landmark slots, <= 40 MSCKF features, ACI²) from the JAX state
  12 and 30 frames into the staged run, where the window is full, landmarks
  are updated and new ones initialized;
* `promotion_candidates`, `build_update`, `delayed_init(collect=True)` and
  `evict` each from one JAX pre-update state at the operating point.

Step for step means that at every frame both packages step from the same
JAX state and table.  Counts, landmark ids, validity, fail counts and the
feature table must agree exactly.  The numbers need tolerances read off the
reference's own f32 reproducibility (tests/torch_step_spread.py --problem
slam prints, per frame, the port's gap and the gap between JAX's jitted and
eager steps on the same inputs).  On the small problem JAX differs from
itself by up to 6.4e-5 in the state values and landmark positions and by
1.04e-5·‖P‖∞ in the covariance (frame 24, a landmark update right after its
initialization); the port's gaps there are 7.4e-5 and 1.23e-5·‖P‖∞.  So
the values are held to 3e-4 and the covariance to 5e-5·‖P‖∞ (both about
five times the reference's own spread), except the rows and columns of the
landmarks initialized in that step: they are held to 2e-3 of their own
block's max|P_ij| (and their positions to 1e-3 m).  A new landmark's
covariance is σ²·R1⁻¹(…)R1⁻ᵀ from the 3×3 factor of its triangulation
system, whose condition (about 1e3 for a far point seen over a short
baseline) amplifies f32 rounding; JAX jit against JAX eager differs by
7.0e-5·‖P‖∞ on frame 31, which initializes two landmarks, and the port by
7.6e-5·‖P‖∞.  The MSCKF-only steps of tests/test_torch_step.py keep 1e-5·‖P‖∞.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.core import state as jstate
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import feature_table as jft
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import updater_slam as jslam
from open_vins_tpu.models.propagator import propagate as jpropagate
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import updater_slam as tslam
from test_torch_fixture import MAX_TRACKS, OPPOINT_CFG
from torch_port_helpers import (FIXTURE, STATE_EXACT_FIELDS,
                                STATE_VALUE_FIELDS, assert_table_equal,
                                fixture_problem, jax_frames_to_port,
                                jax_state_to_port, jax_table_to_port, np_of,
                                slam_problem)

SLAM_EXACT_FIELDS = ("slam_id", "slam_valid", "slam_fail", "slam_anchor_slot",
                     "slam_anchor_cam")


def _new_landmark_cols(cfg, pre, post):
    """[D] bool: the covariance columns of landmarks initialized this step."""
    new = np.asarray(post.slam_valid) & ~np.asarray(pre.slam_valid)
    m = np.zeros(cfg.state_dim, bool)
    for slot in np.flatnonzero(new):
        m[cfg.slam_off + 3 * slot:cfg.slam_off + 3 * slot + 3] = True
    return new, m


def assert_slam_state_close(port_st, jax_st, jax_pre, cfg, where="",
                            val_tol=3e-4, cov_tol=5e-5):
    """The module docstring's tolerances (values `val_tol`, the covariance
    `cov_tol`·‖P‖∞ outside new landmarks' rows and columns); `jax_pre` is
    the state the step started from (it tells which landmarks are new)."""
    for k in STATE_VALUE_FIELDS:
        np.testing.assert_allclose(np_of(getattr(port_st, k)),
                                   np.asarray(getattr(jax_st, k)),
                                   atol=val_tol, rtol=0,
                                   err_msg=f"{where} {k}")
    for k in STATE_EXACT_FIELDS + SLAM_EXACT_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(port_st, k)),
                                      np.asarray(getattr(jax_st, k)),
                                      err_msg=f"{where} {k}")
    new, cols = _new_landmark_cols(cfg, jax_pre, jax_st)
    lam_tol = np.where(new, 1e-3, val_tol)[:, None]
    lam_gap = np.abs(np_of(port_st.slam_p) - np.asarray(jax_st.slam_p))
    assert (lam_gap <= lam_tol).all(), f"{where} slam_p gap {lam_gap.max()}"
    cov_j, cov_t = np.asarray(jax_st.cov), np_of(port_st.cov)
    gap = np.abs(cov_t - cov_j)
    blk = cols[:, None] | cols[None, :]
    norm_inf = np.abs(cov_j).sum(1).max()
    assert gap[~blk].max() <= cov_tol * norm_inf, \
        f"{where} cov gap {gap[~blk].max() / norm_inf:.2e}·‖P‖∞"
    if cols.any():
        blk_max = np.abs(cov_j[cols][:, cols]).max()
        assert gap[blk].max() <= 2e-3 * blk_max, \
            f"{where} new-landmark cov gap {gap[blk].max() / blk_max:.2e}"


def _check_step(st_j, tb_j, cfg_t, tri_t, frame_t, post_j, cfg_j, where):
    """Step the port from the JAX state and compare with the JAX step."""
    st_o, tb_o, d_t = tman.step_frame(jax_state_to_port(st_j),
                                      jax_table_to_port(tb_j), cfg_t, tri_t,
                                      frame_t)
    for k in ("n_msckf", "n_slam", "n_slam_used"):
        assert int(getattr(d_t, k)) == int(getattr(post_j[2], k)), \
            f"{where} {k}"
    assert_slam_state_close(st_o, post_j[0], st_j, cfg_j, where)
    assert_table_equal(tb_o, post_j[1], where=where)
    return int(d_t.n_slam)


def _jax_steps(pb, cfg_jax, n_frames, state=None, table=None):
    step = jax.jit(lambda s, tb, f: jman.step_frame(s, tb, cfg_jax,
                                                    pb.tri_jax, f))
    state = pb.state if state is None else state
    table = pb.table if table is None else table
    for k in range(n_frames):
        post = step(state, table,
                    jax.tree_util.tree_map(lambda a: a[k], pb.frames))
        yield k, state, table, post
        state, table = post[0], post[1]


def test_step_frame_parity_slam_problem():
    """The first 40 frames of the small SLAM problem, step for step."""
    pb = slam_problem()
    frames_t = jax_frames_to_port(pb.frames)
    n_slam = [_check_step(state, table, pb.cfg_port, pb.tri_port,
                          trun.frame_at(frames_t, k), post, pb.cfg_jax,
                          f"frame {k}")
              for k, state, table, post in _jax_steps(pb, pb.cfg_jax, 40)]
    assert max(n_slam) > 0, "SLAM never engaged"


OP_FRAMES = (12, 30)  # landmarks initialized and updated in both
OP_MODULE_FRAME = 20


def _oppoint_start(jc):
    """The JAX groundtruth start of the staged run at the operating point."""
    with np.load(FIXTURE) as z:
        a = {k: jnp.asarray(z[k]) for k in ("gt_q", "gt_p", "gt_v",
                                             "bias_g0", "bias_a0",
                                             "cam_R_ItoC", "cam_p_IinC",
                                             "cam_intr")}
    state = jman.initialize_from_gt(
        jc, a["gt_q"][0], a["gt_p"][0], a["gt_v"][0], a["bias_g0"],
        a["bias_a0"], 0.0, jax.vmap(jlie.rot_2_quat)(a["cam_R_ItoC"]),
        a["cam_p_IinC"], a["cam_intr"])
    return state, jft.init_table(jc, MAX_TRACKS)


@pytest.fixture(scope="module")
def oppoint():
    """The staged run stepped by JAX at the operating point: per frame k of
    OP_FRAMES and OP_MODULE_FRAME, (state and table before frame k, the JAX
    step's result, the JAX frame)."""
    pb = fixture_problem()
    jc, tc = JCfg(**OPPOINT_CFG), TCfg(**OPPOINT_CFG)
    state, table = _oppoint_start(jc)
    keep = set(OP_FRAMES) | {OP_MODULE_FRAME}
    cases = {k: (st, tb, post,
                 jax.tree_util.tree_map(lambda a: a[k], pb.frames))
             for k, st, tb, post in _jax_steps(pb, jc, max(keep) + 1,
                                               state, table)
             if k in keep}
    return pb, jc, tc, cases


@pytest.mark.parametrize("k", OP_FRAMES)
def test_step_frame_parity_operating_point(oppoint, k):
    pb, jc, tc, cases = oppoint
    state, table, post, frame = cases[k]
    assert int(state.n_clones) == jc.max_clones
    n_slam = _check_step(state, table, tc, pb.tri_port,
                         jax_frames_to_port(frame), post, jc, f"frame {k}")
    assert n_slam > 0 and int(post[2].n_slam_used) > 0
    new, _ = _new_landmark_cols(jc, state, post[0])
    assert new.any(), "no landmark was initialized"


@pytest.fixture(scope="module")
def pre_update(oppoint):
    """The JAX pre-update state and table of frame OP_MODULE_FRAME (steps
    1-3 of the reference's step: marginalize, propagate + clone, ingest)."""
    pb, jc, tc, cases = oppoint
    state, table, _, fr = cases[OP_MODULE_FRAME]

    @jax.jit
    def steps(state, table, fr):
        slot_old = jstate.oldest_slot(state, jc)
        full = state.n_clones >= jc.max_clones
        st_m = jekf.marginalize_clone(
            jslam.change_anchors(state, jc, slot_old), jc, slot_old)
        tb_m = jft.clear_clone_column(table, slot_old)
        state = jax.tree_util.tree_map(lambda a, b: jnp.where(full, a, b),
                                       st_m, state)
        table = jax.tree_util.tree_map(lambda a, b: jnp.where(full, a, b),
                                       tb_m, table)
        state = jpropagate(state, jc, fr.win, fr.t_new)
        state = jekf.augment_clone(state, jc, fr.win.w[-1] - state.bg)
        table = jft.ingest_frame(table, jc, state.head, fr.ids, fr.uv,
                                 fr.uvn, fr.mask)
        return state, table

    state, table = steps(state, table, fr)
    return pb, jc, tc, state, table


def test_promotion_candidates_matches_jax(pre_update):
    _, jc, tc, state, table = pre_update
    want = np.asarray(jslam.promotion_candidates(state, jc, table))
    got = np_of(tslam.promotion_candidates(jax_state_to_port(state), tc,
                                           jax_table_to_port(table)))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_build_update_matches_jax(pre_update):
    _, jc, tc, state, table = pre_update
    st_j, tb_j, H_j, r_j, fail_j, n_j = jax.jit(
        jslam.build_update, static_argnums=1)(state, jc, table)
    st_t, tb_t, H_t, r_t, fail_t, n_t = tslam.build_update(
        jax_state_to_port(state), tc, jax_table_to_port(table))
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_array_equal(np_of(fail_t), np.asarray(fail_j))
    np.testing.assert_array_equal(np_of(st_t.slam_fail),
                                  np.asarray(st_j.slam_fail))
    assert_table_equal(tb_t, tb_j)
    H_j, r_j = np.asarray(H_j), np.asarray(r_j)
    np.testing.assert_allclose(np_of(H_t), H_j, rtol=0,
                               atol=1e-5 * np.abs(H_j).max())
    np.testing.assert_allclose(np_of(r_t), r_j, rtol=0, atol=1e-4)


def test_delayed_init_matches_jax(pre_update):
    _, jc, tc, state, table = pre_update
    pb = fixture_problem()
    st_j, tb_j, n_j, H_j, r_j = jslam.delayed_init(
        state, jc, table, pb.tri_jax, jman.gather_feature_obs, collect=True)
    st_t, tb_t, n_t, H_t, r_t = tslam.delayed_init(
        jax_state_to_port(state), tc, jax_table_to_port(table), pb.tri_port,
        tman.gather_feature_obs)
    assert int(n_t) == int(n_j) > 0
    assert_slam_state_close(st_t, st_j, state, jc)
    assert_table_equal(tb_t, tb_j)
    H_j, r_j = np.asarray(H_j), np.asarray(r_j)
    assert H_t.shape == H_j.shape
    np.testing.assert_allclose(np_of(H_t), H_j, rtol=0,
                               atol=1e-4 * np.abs(H_j).max())
    np.testing.assert_allclose(np_of(r_t), r_j, rtol=0, atol=1e-3)


def test_evict_matches_jax(pre_update):
    """One landmark at the fail limit, one whose track was not seen this
    frame: both packages evict the same landmarks and rows."""
    _, jc, tc, state, table = pre_update
    live = np.flatnonzero(np.asarray(state.slam_valid))
    assert len(live) >= 3
    state = state._replace(slam_fail=state.slam_fail.at[live[0]].set(
        jslam.MAX_FAIL))
    row = int(np.flatnonzero(np.asarray(table.ids)
                             == int(state.slam_id[live[1]]))[0])
    table = table._replace(seen=table.seen.at[row].set(False))
    st_j, tb_j = jslam.evict(state, jc, table)
    st_t, tb_t = tslam.evict(jax_state_to_port(state), tc,
                             jax_table_to_port(table))
    assert not np.asarray(st_j.slam_valid)[live[:2]].any()
    for k in SLAM_EXACT_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(st_t, k)),
                                      np.asarray(getattr(st_j, k)), err_msg=k)
    np.testing.assert_array_equal(np_of(st_t.cov), np.asarray(st_j.cov))
    assert_table_equal(tb_t, tb_j)


ARUCO_KW = dict(num_aruco_tags=64, sigma_pix_aruco=3.0,
                chi2_multiplier_aruco=2.0)


def test_aruco_landmark_mask_matches_jax():
    """The 4·tag + corner id contract, with and without tags."""
    ids = np.array([-1, 0, 4 * 16, 4 * 16 + 1, 500], np.int32)
    for tags in (0, 16):
        np.testing.assert_array_equal(
            np_of(tslam._aruco_landmark_mask(TCfg(num_aruco_tags=tags),
                                             torch.as_tensor(ids))),
            np.asarray(jslam._aruco_landmark_mask(JCfg(num_aruco_tags=tags),
                                                  jnp.asarray(ids))))


@pytest.mark.parametrize("ordering", ["joint", "sequential"])
def test_step_frame_parity_aruco(ordering):
    """The small SLAM problem with ids 0..256 aruco tag corners (64 tags) at
    sigma_pix_aruco 3 and a doubled χ² multiplier: aruco-first promotion,
    whitened rows and the aruco gate, step for step over 16 frames in the
    joint "qr" update and in the sequential ordering."""
    pb = slam_problem()
    kw = dict(ARUCO_KW, joint_vision_update=ordering == "joint")
    pb = pb._replace(cfg_jax=pb.cfg_jax._replace(**kw),
                     cfg_port=pb.cfg_port._replace(**kw))
    frames_t = jax_frames_to_port(pb.frames)
    n_aruco = 0
    for k, st, tb, post in _jax_steps(pb, pb.cfg_jax, 16):
        _check_step(st, tb, pb.cfg_port, pb.tri_port,
                    trun.frame_at(frames_t, k), post, pb.cfg_jax,
                    f"frame {k}")
        ids = np.asarray(post[0].slam_id)[np.asarray(post[0].slam_valid)]
        n_aruco = max(n_aruco, int(((ids >= 0) & (ids <= 256)).sum()))
    assert n_aruco > 0, "no aruco landmark entered the state"
