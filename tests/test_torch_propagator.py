"""Parity of the port's IMU propagation with the JAX package over one camera
window of the staged reference-width run (11 samples at 200 Hz): mean and
covariance to 1e-5 (covariance relative to ‖P‖)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import state as jstate
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import propagator as jprop
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import propagator as tprop
from torch_port_helpers import (FIXTURE, assert_state_close,
                                jax_state_to_port, t)


def _window_and_state(cfg, frame=5, pad=0, seed=0):
    with np.load(FIXTURE) as z:
        win = [z[k][frame] for k in ("win_t", "win_w", "win_a")]
        q, p, v = z["gt_q"][frame], z["gt_p"][frame], z["gt_v"][frame]
        bg, ba = z["bias_g0"], z["bias_a0"]
    if pad:  # the padding convention: repeat the last sample (dt = 0)
        win = [np.concatenate([a, np.repeat(a[-1:], pad, 0)]) for a in win]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(cfg.state_dim, cfg.state_dim)) * 1e-2
    q_fej = q + 1e-3 * rng.normal(size=4)
    st = jstate.init_state(cfg)._replace(
        q=jnp.asarray(q), p=jnp.asarray(p), v=jnp.asarray(v),
        bg=jnp.asarray(bg), ba=jnp.asarray(ba),
        q_fej=jnp.asarray(q_fej / np.linalg.norm(q_fej), jnp.float32),
        p_fej=jnp.asarray(p + 1e-3), v_fej=jnp.asarray(v - 1e-3),
        cov=jnp.asarray(A @ A.T + 1e-4 * np.eye(cfg.state_dim), jnp.float32))
    if cfg.calib_imu_intrinsics:
        st = st._replace(
            imu_dw=st.imu_dw + jnp.asarray([1e-3, 2e-3, -1e-3, 0, 1e-3, 0]),
            imu_tg=jnp.asarray(rng.normal(size=9) * 1e-3, jnp.float32))
    return st, [np.asarray(a, np.float32) for a in win]


@pytest.mark.parametrize("kw,pad", [
    (dict(integration="rk4"), 0),
    (dict(integration="rk4"), 3),
    (dict(integration="discrete"), 0),
    (dict(integration="rk4", calib_imu_intrinsics=True,
          calib_imu_g_sensitivity=True), 0),
])
def test_propagate_matches_jax(kw, pad):
    base = dict(max_clones=11, max_slam=0, num_cams=1)
    jc, tc = JCfg(**base, **kw), TCfg(**base, **kw)
    st, (wt, ww, wa) = _window_and_state(jc, pad=pad)
    t_new = float(wt[-1])
    want = jax.jit(jprop.propagate, static_argnums=1)(st, jc, jprop.ImuWindow(
        t=jnp.asarray(wt), w=jnp.asarray(ww), a=jnp.asarray(wa)), t_new)
    got = tprop.propagate(jax_state_to_port(st), tc, tprop.ImuWindow(
        t=t(wt), w=t(ww), a=t(wa)), t_new)
    assert_state_close(got, want, atol=1e-5, cov_rel=1e-5)
    for k in ("q_fej", "p_fej", "v_fej", "t"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5)


def test_analytical_integration_is_a_later_slice():
    cfg = TCfg(max_clones=11, max_slam=0, integration="analytical")
    st, (wt, ww, wa) = _window_and_state(JCfg(max_clones=11, max_slam=0))
    with pytest.raises(NotImplementedError, match="second slice"):
        tprop.propagate(jax_state_to_port(st), cfg,
                        tprop.ImuWindow(t=t(wt), w=t(ww), a=t(wa)),
                        torch.tensor(float(wt[-1])))
