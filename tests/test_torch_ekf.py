"""Parity of the port's EKF core (core/ekf.py, core/state.py) with the JAX
package on the same seeded states: covariances to 1e-5 of ‖P‖ (f32
rounding of differently-ordered products), ring bookkeeping exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.core import state as jstate
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu_torch.core import ekf as tekf
from open_vins_tpu_torch.core import state as tstate
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from torch_port_helpers import assert_state_close, jax_state_to_port, np_of, t

KW = dict(max_clones=5, max_slam=0, num_cams=1, max_msckf_in_update=8)
JC, TC = JCfg(**KW), TCfg(**KW)


def _spd(D, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) * scale
    return (A @ A.T + scale * np.eye(D)).astype(np.float32)


def _jax_state(seed=0, n_clones=3):
    rng = np.random.default_rng(seed)
    st = jstate.init_state(JC)
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q) * np.sign(q[3])
    st = st._replace(q=jnp.asarray(q, jnp.float32),
                     p=jnp.asarray(rng.normal(size=3), jnp.float32),
                     v=jnp.asarray(rng.normal(size=3), jnp.float32),
                     cov=jnp.asarray(_spd(JC.state_dim, seed + 1)))
    for _ in range(n_clones):
        st = jekf.augment_clone(st, JC, jnp.zeros(3))
    return st


def test_layout_offsets_identical():
    for cfg_kw in (KW, dict(max_clones=11, max_slam=0), dict(max_slam=50)):
        j, p = JCfg(**cfg_kw), TCfg(**cfg_kw)
        assert j._fields == p._fields and tuple(j) == tuple(p)
        for name in ("state_dim", "clones_off", "slam_off", "calib_dt_off",
                     "calib_ext_off", "calib_intr_off", "imu_dw_off",
                     "cam_meas_support_ranges", "slam_meas_support_ranges"):
            assert getattr(j, name) == getattr(p, name), name
    assert TCfg(max_clones=11, max_slam=0).state_dim == 120


def test_chi2_gate_table():
    dof = np.array([0, 1, 5, 19, 300, 5000], np.int32)
    np.testing.assert_array_equal(
        np_of(tekf.chi2_gate(torch.as_tensor(dof))),
        np.asarray(jekf.chi2_gate(jnp.asarray(dof))))


def test_propagate_covariance():
    rng = np.random.default_rng(3)
    cov = _spd(JC.state_dim, 4)
    Phi = (np.eye(15) + 0.1 * rng.normal(size=(15, 15))).astype(np.float32)
    Qd = _spd(15, 5, 1e-3)
    B = (0.1 * rng.normal(size=(15, 24))).astype(np.float32)
    for b in (None, B):
        want = np.asarray(jekf.propagate_covariance(
            jnp.asarray(cov), jnp.asarray(Phi), jnp.asarray(Qd), JC,
            B=None if b is None else jnp.asarray(b)))
        got = np_of(tekf.propagate_covariance(
            t(cov), t(Phi), t(Qd), TC, B=None if b is None else t(b)))
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0)


def test_augment_and_marginalize_ring():
    st_j = _jax_state(seed=1, n_clones=0)
    st_t = jax_state_to_port(st_j)
    w = np.array([0.1, -0.2, 0.05], np.float32)
    for i in range(2 * JC.max_clones):
        full_j = int(st_j.n_clones) >= JC.max_clones
        if full_j:
            slot = jstate.oldest_slot(st_j, JC)
            st_j = jekf.marginalize_clone(st_j, JC, slot)
            st_t = tekf.marginalize_clone(
                st_t, TC, tstate.oldest_slot(st_t, TC))
            assert_state_close(st_t, st_j, atol=0, cov_rel=0,
                               where=f"marg {i}")
        st_j = jekf.augment_clone(st_j, JC, jnp.asarray(w))
        st_t = tekf.augment_clone(st_t, TC, t(w))
        assert_state_close(st_t, st_j, atol=0, cov_rel=0, where=f"aug {i}")


def test_boxplus():
    st_j = _jax_state(seed=2)
    dx = (np.random.default_rng(9).normal(size=JC.state_dim) * 0.01
          ).astype(np.float32)
    want = jstate.boxplus(st_j, JC, jnp.asarray(dx))
    got = tstate.boxplus(jax_state_to_port(st_j), TC, t(dx))
    assert_state_close(got, want, atol=1e-6, cov_rel=0)


def _support_system(seed, m=12):
    """H with rows exactly zero outside the camera support columns."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, JC.state_dim), np.float32)
    for a, b in JC.cam_meas_support_ranges:
        H[:, a:b] = rng.normal(size=(m, b - a)) * 0.5
    res = (rng.normal(size=m) * 0.1).astype(np.float32)
    return H, res, np.full(m, 0.04, np.float32)


@pytest.mark.parametrize("ranges", [None, "support"])
def test_kalman_update_math(ranges):
    rg = JC.cam_meas_support_ranges if ranges else None
    cov = np.asarray(_jax_state(seed=3).cov)
    H, res, r = _support_system(4)
    dx_j, cov_j = jekf.kalman_update_math(jnp.asarray(cov), jnp.asarray(H),
                                          jnp.asarray(res), jnp.asarray(r),
                                          ranges=rg)
    dx_t, cov_t = tekf.kalman_update_math(t(cov), t(H), t(res), t(r),
                                          ranges=rg)
    scale = np.abs(np.asarray(cov_j)).max()
    np.testing.assert_allclose(np_of(cov_t), np.asarray(cov_j),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(np_of(dx_t), np.asarray(dx_j),
                               atol=1e-5 * max(1.0, np.abs(dx_j).max()),
                               rtol=0)
    assert np.array_equal(np_of(cov_t), np_of(cov_t).T)


def test_kalman_update_non_finite_is_noop():
    """An indefinite S (negative measurement noise) must leave the state
    exactly as it was, in both packages."""
    cov = np.asarray(_jax_state(seed=5).cov)
    H, res, _ = _support_system(6)
    r = np.full(H.shape[0], -10.0, np.float32)
    dx_j, cov_j = jekf.kalman_update_math(jnp.asarray(cov), jnp.asarray(H),
                                          jnp.asarray(res), jnp.asarray(r))
    dx_t, cov_t = tekf.kalman_update_math(t(cov), t(H), t(res), t(r))
    assert not np.asarray(dx_j).any() and not np_of(dx_t).any()
    np.testing.assert_array_equal(np.asarray(cov_j), cov)
    np.testing.assert_array_equal(np_of(cov_t), cov)


def test_ekf_update_state():
    st_j = _jax_state(seed=7)
    H, res, r = _support_system(8)
    rg = JC.cam_meas_support_ranges
    want = jekf.ekf_update(st_j, JC, jnp.asarray(H), jnp.asarray(res),
                           jnp.asarray(r), ranges=rg)
    got = tekf.ekf_update(jax_state_to_port(st_j), TC, t(H), t(res), t(r),
                          ranges=rg)
    assert_state_close(got, want, atol=1e-6, cov_rel=1e-5)


def test_set_initial_covariance():
    st_j = _jax_state(seed=8, n_clones=2)
    diag = np.arange(1, JC.state_dim + 1, dtype=np.float32) * 1e-3
    want = jekf.set_initial_covariance(st_j, JC, jnp.asarray(diag))
    got = tekf.set_initial_covariance(jax_state_to_port(st_j), TC, t(diag))
    np.testing.assert_array_equal(np_of(got.cov), np.asarray(want.cov))
