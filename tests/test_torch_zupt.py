"""The port's zero-velocity update (models/updater_zupt.py) against the JAX
package, per function, per step and batched.

* `try_zupt` on tests/test_zupt.py's static IMU windows (stationary,
  moving, rotating, a disparity above the gate, a gyro bias to correct) and
  `try_zupt_explicit` on its states with one clone (stationary, moving, no
  clone): the accepted flag equal, the state values within 1e-5, the
  covariance within 1e-5·‖P‖∞ (both forms are one push-through solve on
  9 columns or a 9-row update, f32 rounding only); `build_system` (with a
  zero-length step, whose rows are zero) and `frame_disparity` (on two
  ingested frames of the staged run, and on an empty window) likewise;
* `step_frame` with ZUPT on the small SLAM problem
  (`torch_port_helpers.slam_problem`), both packages stepping from the same
  JAX state every frame, with the χ² gate off and the velocity and
  disparity gates open: the direct and the explicit form, whose first frame
  has no previous observation or clone (rejected: the normal step) and
  whose later frames are ZUPT frames;
* the vmapped step (`batched=True`, what `runner.run_ensemble` runs) in
  the "newton" joint form with ZUPT at 3 streams, one of which may not
  take a ZUPT (`zupt_only_at_beginning` with its `moved` flag set): each
  stream against its own single-stream step from the same state, with
  vmap's per-example fallback turned into an error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.core import state as jstate
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import feature_table as jft
from open_vins_tpu.models import updater_zupt as jzupt
from open_vins_tpu.models.propagator import ImuWindow as JWin
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import updater_zupt as tzupt
from open_vins_tpu_torch.models.propagator import ImuWindow as TWin
from test_torch_ensemble import assert_same_stream, at, vmap_fallbacks
from test_torch_slam import _jax_steps, assert_slam_state_close
from torch_port_helpers import (STATE_EXACT_FIELDS, STATE_VALUE_FIELDS,
                                assert_state_close, assert_table_equal,
                                ensemble_problem, fixture_problem,
                                jax_frames_to_port, jax_state_to_port,
                                jax_table_to_port, np_of, slam_problem, t)

KW = dict(max_clones=5, max_slam=0, num_cams=1, use_zupt=True)
JC, TC = JCfg(**KW), TCfg(**KW)


def _static_window(n=11, dt=0.005, bg=None, ba=None, dw=0.0):
    """tests/test_zupt.py's window of a stationary platform (level), with
    an added constant rate `dw` about x; numpy arrays."""
    w = np.zeros((n, 3)) + (0.0 if bg is None else bg)
    w[:, 0] += dw
    a = np.tile([0.0, 0.0, 9.81], (n, 1)) + (0.0 if ba is None else ba)
    return dict(t=(np.arange(n) * dt).astype(np.float32),
                w=w.astype(np.float32), a=a.astype(np.float32))


def _windows(win):
    return (JWin(**{k: jnp.asarray(v) for k, v in win.items()}),
            TWin(**{k: torch.as_tensor(v) for k, v in win.items()}))


def _make_state(v=0.0, clone=False):
    """tests/test_zupt.py's state (diagonal IMU prior), with one clone for
    the explicit form."""
    st = jstate.init_state(JC)._replace(v=jnp.asarray([v, 0.0, 0.0]))
    diag = jnp.zeros(JC.state_dim).at[:15].set(jnp.concatenate([
        jnp.full(3, 1e-3), jnp.full(3, 1e-4), jnp.full(3, 1e-2),
        jnp.full(3, 1e-3), jnp.full(3, 1e-2)]))
    st = jekf.set_initial_covariance(st, JC, diag)
    if clone:
        st = jekf.augment_clone(st, JC._replace(zupt_explicit_motion=True),
                                jnp.zeros(3))
    return st


def _check(got, want, where):
    """(state, accepted) of both packages."""
    assert bool(got[1]) == bool(want[1]), f"{where} accepted"
    assert_state_close(got[0], want[0], atol=1e-5, cov_rel=1e-5,
                       cov_norm="inf", where=where)
    for k in ("t", "moved", "bg", "ba"):
        np.testing.assert_allclose(np_of(getattr(got[0], k)),
                                   np.asarray(getattr(want[0], k)),
                                   rtol=0, atol=1e-6, err_msg=f"{where} {k}")


DIRECT = {"stationary": (dict(), 0.0, True),
          "moving": (dict(), 0.0, False),
          "rotating": (dict(dw=0.5), 0.0, False),
          "disparity": (dict(), 5.0, False),
          "bias": (dict(bg=np.asarray([0.02, -0.01, 0.015])), 0.0, True)}


@pytest.mark.parametrize("case", list(DIRECT))
def test_try_zupt_matches_jax(case):
    win_kw, disparity, accepted = DIRECT[case]
    st = _make_state(v=1.0 if case == "moving" else 0.0)
    win_j, win_t = _windows(_static_window(**win_kw))
    want = jax.jit(jzupt.try_zupt, static_argnums=1)(
        st, JC, win_j, 0.05, jnp.asarray(disparity))
    got = tzupt.try_zupt(jax_state_to_port(st), TC, win_t, 0.05,
                         torch.tensor(disparity))
    assert bool(want[1]) == accepted
    _check(got, want, case)


EXPLICIT = {"stationary": (0.05, True, True), "moving": (1.0, True, False),
            "no_clone": (0.0, False, False)}


@pytest.mark.parametrize("case", list(EXPLICIT))
def test_try_zupt_explicit_matches_jax(case):
    v, clone, accepted = EXPLICIT[case]
    jc, tc = (JC._replace(zupt_explicit_motion=True),
              TC._replace(zupt_explicit_motion=True))
    st = _make_state(v=v, clone=clone)
    win_j, win_t = _windows(_static_window())
    want = jax.jit(jzupt.try_zupt_explicit, static_argnums=1)(
        st, jc, win_j, 0.05, jnp.asarray(0.0))
    got = tzupt.try_zupt_explicit(jax_state_to_port(st), tc, win_t, 0.05,
                                  torch.tensor(0.0))
    assert bool(want[1]) == accepted
    _check(got, want, case)


def test_build_system_matches_jax():
    win = _static_window(bg=np.asarray([0.01, 0.0, -0.02]))
    win["t"][4] = win["t"][3]  # a zero-length step: its 6 rows are zero
    st = _make_state(v=0.1)
    win_j, win_t = _windows(win)
    want = jzupt.build_system(st, JC, win_j)
    got = tzupt.build_system(jax_state_to_port(st), TC, win_t)
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(np_of(g), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
    assert not np.asarray(want[2])[18:24].any()


def test_frame_disparity_matches_jax():
    """Two frames of the staged run ingested at clone slots 0 and 1, then
    the third frame's disparity to slot 1; and an empty window (head −1)."""
    pb = fixture_problem()
    jc, tc = pb.cfg_jax, pb.cfg_port
    fr = [jax.tree_util.tree_map(lambda a: a[k], pb.frames) for k in range(3)]
    table = pb.table
    for slot in (0, 1):
        f = fr[slot]
        table = jft.ingest_frame(table, jc, jnp.asarray(slot), f.ids, f.uv,
                                 f.uvn, f.mask)
    for head, tb in ((1, table), (-1, pb.table)):
        want = float(jzupt.frame_disparity(tb, jc, jnp.asarray(head),
                                           fr[2].ids, fr[2].uv, fr[2].mask))
        got = float(tzupt.frame_disparity(
            jax_table_to_port(tb), tc, torch.tensor(head),
            torch.as_tensor(np.array(fr[2].ids)), t(fr[2].uv),
            torch.as_tensor(np.array(fr[2].mask))))
        assert got == pytest.approx(want, rel=1e-5)
        assert (want == 1e9) == (head < 0)


# the gates open (χ² off, velocity and disparity gates far away): every
# frame with a clone to pin to is a ZUPT frame
OPEN = dict(use_zupt=True, zupt_chi2_multiplier=0.0, zupt_max_velocity=1e3,
            zupt_max_disparity=1e9)
STEP_CONFIGS = {"direct": dict(OPEN),
                "explicit": dict(OPEN, zupt_explicit_motion=True)}


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_step_frame_zupt_matches_jax(name):
    pb = slam_problem()
    kw = dict(pb.cfg_jax._asdict(), **STEP_CONFIGS[name])
    jc, tc = JCfg(**kw), TCfg(**kw)
    frames_t = jax_frames_to_port(pb.frames)
    n_zupt = 0
    for k, st_j, tb_j, post in _jax_steps(pb, jc, 5):
        st_t, tb_t, d_t = tman.step_frame(
            jax_state_to_port(st_j), jax_table_to_port(tb_j), tc,
            pb.tri_port, trun.frame_at(frames_t, k))
        where = f"{name} frame {k}"
        for f in ("n_msckf", "n_tracks", "n_slam", "n_slam_used"):
            assert int(getattr(d_t, f)) == int(getattr(post[2], f)), where
        assert_slam_state_close(st_t, post[0], st_j, jc, where)
        assert_table_equal(tb_t, post[1], where=where)
        np.testing.assert_allclose(float(st_t.t), float(post[0].t), atol=1e-6)
        # a ZUPT frame keeps the clone window
        n_zupt += int(post[0].n_clones) == int(st_j.n_clones)
    assert n_zupt >= 4


# The newton form's 14 Newton sweeps and its polish amplify the rounding of
# the batched products by one to two orders of magnitude over the "qr"
# form: the largest batched-vs-single gaps seen over 9 frames are 4.9e-5 in
# the values and 1.2e-4 in a landmark position (both in a step that
# initializes landmarks) and 2.3e-5·‖P‖∞ in the covariance, against at
# most 2.9e-6 and 1.1e-6·‖P‖∞ in "qr".  The reference's own jit and eager
# steps in this form differ by up to 4.2e-4 in the values and
# 9.6e-5·‖P‖∞ (tests/torch_step_spread.py --problem slam --set
# joint_update_form=newton --set newton_iters=14).  So the batched newton
# step is held to tests/test_torch_ensemble.py's tolerances times 50: the
# covariance to 5e-5·‖P‖∞, the repo's tolerance of a SLAM step against JAX.
NEWTON_SCALE = 50.0


def test_batched_newton_zupt_step_matches_single_streams():
    """3 streams, the newton joint form with ZUPT (direct, gates open but
    `zupt_only_at_beginning`): streams 0 and 2 take a ZUPT every frame
    after the first, stream 1 (`moved`) runs the normal newton step; each stream against its
    own single-stream step at tests/test_torch_ensemble.py's tolerances,
    over 6 frames, with no vmap fallback."""
    pb = ensemble_problem(4, "analytical", joint_update_form="newton",
                          newton_iters=14, zupt_only_at_beginning=True,
                          **OPEN)
    cfg = pb.cfg_port
    step = trun.ensemble_step(cfg, pb.tri_port)
    frames = jax_frames_to_port(pb.frames)
    state, table = jax_state_to_port(pb.state), jax_table_to_port(pb.table)
    state = state.replace(moved=torch.tensor([False, True, False]))
    for k in range(6):
        frame = pytree.tree_map(lambda a: a[:, k], frames)
        with vmap_fallbacks() as fallbacks:
            post = step(state, table, frame)
        assert fallbacks == []
        for b in range(3):
            one = tman.step_frame(at(state, b), at(table, b), cfg,
                                  pb.tri_port, at(frame, b))
            assert_same_stream(at(post, b), one, at(state, b), cfg,
                               f"frame {k} stream {b}", scale=NEWTON_SCALE)
            # the solve's residual is f32 noise (1e-7 to 3e-6 here): both
            # under the polish tolerance, and zero on the same frames
            r_b, r_1 = float(post[2].newton_resid[b]), float(
                one[2].newton_resid)
            assert r_b < 1e-3 and r_1 < 1e-3 and (r_b == 0) == (r_1 == 0)
        state, table = post[0], post[1]
    assert int(state.n_clones[1]) == cfg.max_clones
    # the first frame has no previous observations (disparity 1e9, not
    # under the gate): streams 0 and 2 cloned once, then took ZUPTs
    assert int(state.n_clones[0]) == int(state.n_clones[2]) == 1
