"""Parity of the port's small ops (lie, smallmat, cameras) with the JAX
package: the same seeded numpy inputs through both, atol 1e-6 for values
and 1e-5 for Jacobians (f32 rounding of differently-ordered sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_vins_tpu.ops import cameras as jcam
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu.ops import smallmat as jsm
from open_vins_tpu_torch.ops import cameras as tcam
from open_vins_tpu_torch.ops import lie as tlie
from open_vins_tpu_torch.ops import smallmat as tsm
from torch_port_helpers import np_of, t

RNG_SEED = 7


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 3] < 0] *= -1
    return q.astype(np.float32)


def _rotvecs(rng, n):
    # include tiny angles (Taylor branches) and angles near pi
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(1e-6, 3.1, n - 4),
                          [1e-9, 1e-5, 3.13, 0.0]])
    return (w * ang[:, None]).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_2_rot", "quat_norm", "skew",
                                  "exp_so3", "Jr_so3", "Omega",
                                  "axis_angle_2_quat"])
def test_lie_unary(name):
    rng = np.random.default_rng(RNG_SEED)
    x = _quats(rng, 64) if name in ("quat_2_rot", "quat_norm") else \
        _rotvecs(rng, 64)
    want = np.asarray(jax.vmap(getattr(jlie, name))(jnp.asarray(x)))
    got = np_of(getattr(tlie, name)(t(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_rot_2_quat_and_log_so3():
    rng = np.random.default_rng(RNG_SEED + 1)
    R = np.asarray(jax.vmap(jlie.exp_so3)(jnp.asarray(_rotvecs(rng, 64))))
    np.testing.assert_allclose(np_of(tlie.rot_2_quat(t(R))),
                               np.asarray(jax.vmap(jlie.rot_2_quat)(R)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_of(tlie.log_so3(t(R))),
                               np.asarray(jax.vmap(jlie.log_so3)(R)),
                               atol=1e-5, rtol=0)


def test_quat_multiply():
    rng = np.random.default_rng(RNG_SEED + 2)
    q, p = _quats(rng, 64), _quats(rng, 64)
    want = np.asarray(jax.vmap(jlie.quat_multiply)(q, p))
    np.testing.assert_allclose(np_of(tlie.quat_multiply(t(q), t(p))), want,
                               atol=1e-6, rtol=0)


def test_smallmat_solve3_and_eigvalsh3():
    rng = np.random.default_rng(RNG_SEED + 3)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    S = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(np_of(tsm.solve3(t(S), t(b))),
                               np.asarray(jsm.solve3(S, b)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_of(tsm.eigvalsh3(t(S))),
                               np.asarray(jsm.eigvalsh3(S)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [5, 19])
def test_chi2_quadform(m):
    rng = np.random.default_rng(RNG_SEED + m)
    A = rng.normal(size=(40, m, m)).astype(np.float32)
    S = (A @ A.transpose(0, 2, 1) / m + np.eye(m)).astype(np.float32)
    b = rng.normal(size=(40, m)).astype(np.float32)
    want = np.asarray(jsm.chi2_quadform(jnp.asarray(S), jnp.asarray(b)))
    got = np_of(tsm.chi2_quadform(t(S), t(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


ZETA = {
    "radtan": np.array([458.65, 457.30, 367.2, 248.4, -0.2834, 0.0739,
                        1.9e-4, 1.8e-5], np.float32),
    "equi": np.array([190.97, 190.97, 254.93, 256.90, 2.9e-3, 3.8e-4,
                      -1.1e-3, 2.0e-4], np.float32),
}


@pytest.mark.parametrize("model", ["radtan", "equi"])
def test_distort_and_jacobians(model):
    rng = np.random.default_rng(RNG_SEED + 11)
    xy = rng.uniform(-0.6, 0.6, size=(128, 2)).astype(np.float32)
    xy[0] = 0.0  # the r -> 0 branch of the equidistant model
    zeta = ZETA[model]
    np.testing.assert_allclose(
        np_of(tcam.distort(model, t(zeta), t(xy))),
        np.asarray(jcam.distort(model, jnp.asarray(zeta), jnp.asarray(xy))),
        atol=1e-4, rtol=1e-6)  # pixels: 1e-6 relative of ~500
    zc = np.repeat(zeta[:, None], xy.shape[0], axis=1)
    want = jcam.distort_jacobians_soa(model, jnp.asarray(zc),
                                      jnp.asarray(xy[:, 0]),
                                      jnp.asarray(xy[:, 1]))
    got = tcam.distort_jacobians_soa(model, t(zc), t(xy[:, 0]), t(xy[:, 1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # and the analytic Jacobians agree with the reference's autodiff ones
    J_pt, J_zeta = jcam.distort_jacobians(model, jnp.asarray(zeta),
                                          jnp.asarray(xy))
    np.testing.assert_allclose(np_of(got[1]).transpose(2, 0, 1),
                               np.asarray(J_pt), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np_of(got[2]).transpose(2, 0, 1),
                               np.asarray(J_zeta), rtol=1e-4, atol=1e-3)
