"""The port's reference-exact sequential SLAM ordering and `fast_compress`
against the JAX package, and its joint delayed init against its sequential
oracle.

* `step_frame` with `joint_vision_update=False` (the MSCKF update, then the
  SLAM-landmark update, then delayed init with its own update of the
  leftover rows) on the small SLAM problem
  (`torch_port_helpers.slam_problem`: 5 clones, 4 landmark slots, ACI²),
  both packages stepping from the same JAX state at every frame over the
  first 10 frames, in which landmarks are initialized and updated, at the
  tolerances of tests/test_torch_slam.py (values 3e-4, the covariance
  5e-5·‖P‖∞, new-landmark blocks 2e-3 of their max); `fast_compress`
  (normal-equation compression, which takes the sequential ordering) over
  its first 10 frames likewise;
* from the JAX pre-update state of the first frame whose delayed init has
  work: `updater_slam.update`, `delayed_init(collect=False)` and the
  one-at-a-time `_delayed_init_sequential` (the reference's oracle, with
  `ekf.initialize_landmark` and the single-feature `feature_jacobian`)
  against the same JAX functions, at the same tolerances;
* the port's joint batched init against its sequential oracle in a closed
  loop (tests/test_slam.py::test_joint_init_matches_sequential on the port,
  24 frames, the χ² gates loosened so both accept the same candidates):
  the same landmarks, positions within 5e-3 m, covariance diagonals within
  5 %.
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
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import updater_slam as tslam
from test_torch_slam import _jax_steps, assert_slam_state_close
from torch_port_helpers import (assert_table_equal, jax_frames_to_port,
                                jax_state_to_port, jax_table_to_port, np_of,
                                slam_problem)

SEQ = dict(joint_vision_update=False)
JOINT_INIT_FRAMES = 24  # landmarks enter from frame 4 on


def _check_steps(pb, kw, n_frames, where):
    """Both packages step from the same JAX state every frame; returns the
    JAX (pre state, pre table, post, frame index) of every frame."""
    jc, tc = JCfg(**kw), TCfg(**kw)
    frames_t = jax_frames_to_port(pb.frames)
    cases = []
    for k, st_j, tb_j, post in _jax_steps(pb, jc, n_frames):
        st_t, tb_t, d_t = tman.step_frame(
            jax_state_to_port(st_j), jax_table_to_port(tb_j), tc,
            pb.tri_port, trun.frame_at(frames_t, k))
        w = f"{where} frame {k}"
        for f in ("n_msckf", "n_slam", "n_slam_used"):
            assert int(getattr(d_t, f)) == int(getattr(post[2], f)), w
        assert_slam_state_close(st_t, post[0], st_j, jc, w)
        assert_table_equal(tb_t, post[1], where=w)
        cases.append((st_j, tb_j, post, k))
    return cases


@pytest.fixture(scope="module")
def sequential_steps():
    pb = slam_problem()
    kw = dict(pb.cfg_jax._asdict(), **SEQ)
    return pb, kw, _check_steps(pb, kw, 10, "sequential")


def test_step_frame_sequential_matches_jax(sequential_steps):
    _, _, cases = sequential_steps
    inits = [int((np.asarray(post[0].slam_valid)
                  & ~np.asarray(st.slam_valid)).sum())
             for st, _, post, _ in cases]
    assert sum(inits) > 0, "no landmark was initialized"
    assert max(int(post[2].n_slam_used) for _, _, post, _ in cases) > 0


def test_step_frame_fast_compress_matches_jax():
    pb = slam_problem()
    kw = dict(pb.cfg_jax._asdict(), fast_compress=True)
    cases = _check_steps(pb, kw, 10, "fast_compress")
    assert max(int(post[2].n_msckf) for _, _, post, _ in cases) > 0


@pytest.fixture(scope="module")
def init_frame(sequential_steps):
    """The JAX pre-update state and table (marginalize, propagate + clone,
    ingest) of the first frame whose delayed init has work."""
    pb, kw, cases = sequential_steps
    jc = JCfg(**kw)
    st, tb, _, k = next(c for c in cases
                        if int(c[2][0].slam_valid.sum())
                        > int(c[0].slam_valid.sum()))
    fr = jax.tree_util.tree_map(lambda a: a[k], pb.frames)

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

    st, tb = steps(st, tb, fr)
    return pb, jc, TCfg(**kw), st, tb


def test_slam_update_matches_jax(init_frame):
    _, jc, tc, st, tb = init_frame
    want = jax.jit(jslam.update, static_argnums=1)(st, jc, tb)
    got = tslam.update(jax_state_to_port(st), tc, jax_table_to_port(tb))
    assert int(got[3]) == int(want[3])
    np.testing.assert_array_equal(np_of(got[2]), np.asarray(want[2]))
    assert_slam_state_close(got[0], want[0], st, jc)
    assert_table_equal(got[1], want[1])


@pytest.mark.parametrize("joint", [True, False])
def test_delayed_init_applied_matches_jax(init_frame, monkeypatch, joint):
    """`delayed_init` with its leftover rows applied (collect=False), by
    the joint batched init or, with _DELAYED_INIT_JOINT off, by the
    sequential oracle, in both packages."""
    pb, jc, tc, st, tb = init_frame
    monkeypatch.setattr(jslam, "_DELAYED_INIT_JOINT", joint)
    monkeypatch.setattr(tslam, "_DELAYED_INIT_JOINT", joint)
    want = jax.jit(lambda s, t: jslam.delayed_init(
        s, jc, t, pb.tri_jax, jman.gather_feature_obs))(st, tb)
    got = tslam.delayed_init(jax_state_to_port(st), tc,
                             jax_table_to_port(tb), pb.tri_port,
                             tman.gather_feature_obs, collect=False)
    assert int(got[2]) == int(want[2]) > 0
    assert_slam_state_close(got[0], want[0], st, jc)
    assert_table_equal(got[1], want[1])


def test_joint_init_matches_sequential(monkeypatch):
    """tests/test_slam.py::test_joint_init_matches_sequential on the port:
    the sequential per-frame updates in both arms, the joint batched init
    against the one-at-a-time loop."""
    pb = slam_problem()
    kw = dict(pb.cfg_jax._asdict(), chi2_multiplier_slam=1e6, **SEQ)
    cfg = TCfg(**kw)
    frames = jax_frames_to_port(pb.frames)
    outs = {}
    for joint in (True, False):
        monkeypatch.setattr(tslam, "_DELAYED_INIT_JOINT", joint)
        st, tb = jax_state_to_port(pb.state), jax_table_to_port(pb.table)
        ps = []
        for k in range(JOINT_INIT_FRAMES):
            st, tb, _ = tman.step_frame(st, tb, cfg, pb.tri_port,
                                        trun.frame_at(frames, k))
            ps.append(st.p)
        outs[joint] = (st, torch.stack(ps))
    (st_j, p_j), (st_s, p_s) = outs[True], outs[False]
    assert torch.equal(st_j.slam_valid, st_s.slam_valid)
    assert int(st_j.slam_valid.sum()) > 0
    assert (set(st_j.slam_id[st_j.slam_valid].tolist())
            == set(st_s.slam_id[st_s.slam_valid].tolist()))
    assert float((p_j - p_s).norm(dim=1).max()) < 5e-3
    d_j, d_s = torch.diagonal(st_j.cov), torch.diagonal(st_s.cov)
    live = d_s > 1e-10
    rel = (d_j[live] - d_s[live]).abs() / d_s[live].clamp(min=1e-10)
    assert float(rel.max()) < 0.05
