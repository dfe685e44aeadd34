"""Parity of the port's batched triangulation (linear solve, damped
Gauss-Newton, depth and condition gates) with the JAX package on seeded
scenes.  Positions to 1e-4 m at 3-8 m depth: the Gauss-Newton iterations
carry f32 rounding of differently-ordered sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_vins_tpu.models import triangulation as jtri
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.models import triangulation as ttri
from torch_port_helpers import np_of, t


def scene(seed, F=40, O=11, noise=1e-3):
    """F features seen by O cameras on a short arc, with seeded masks
    (some features with < 2 observations, some behind the minimum depth)."""
    rng = np.random.default_rng(seed)
    rotvec = rng.normal(size=(O, 3)) * 0.05
    R_GtoC = np.asarray(jax.vmap(jlie.exp_so3)(jnp.asarray(rotvec)))
    p_CinG = np.stack([np.linspace(0, 1.0, O), 0.1 * rng.normal(size=O),
                       0.1 * rng.normal(size=O)], 1)
    depth = rng.uniform(3.0, 8.0, size=F)
    depth[:2] = [-1.0, -2.0]  # behind the cameras: fail the depth gate
    p_f = np.stack([rng.uniform(-2, 2, F), rng.uniform(-1.5, 1.5, F), depth],
                   1) + np.array([0.5, 0, 0])
    p_C = np.einsum("oij,foj->foi", R_GtoC, p_f[:, None] - p_CinG[None])
    uvn = p_C[..., :2] / p_C[..., 2:3] + noise * rng.normal(size=(F, O, 2))
    mask = rng.uniform(size=(F, O)) > 0.3
    mask[2, :] = False
    mask[3, :] = np.arange(O) == 4  # a single observation
    f32 = np.float32
    return dict(R_GtoC=np.broadcast_to(R_GtoC, (F, O, 3, 3)).astype(f32),
                p_CinG=np.broadcast_to(p_CinG, (F, O, 3)).astype(f32),
                uvn=uvn.astype(f32), mask=mask)


@pytest.mark.parametrize("opts,rtol", [
    (jtri.TriangulationOptions(), 0.0),
    (jtri.TriangulationOptions(max_runs=2), 0.0),
    (jtri.TriangulationOptions(refine=False), 0.0),
    # from the 1-dof initial guess five GN steps have not converged, so the
    # iterate still carries the rounding of each step: 1e-4 relative
    (jtri.TriangulationOptions(triangulate_1d=True), 1e-4),
])
def test_triangulate_batch_matches_jax(opts, rtol):
    sc = scene(5)
    p_j, ok_j = jtri.triangulate_batch(
        jtri.FeatureObs(**{k: jnp.asarray(v) for k, v in sc.items()}), opts)
    p_t, ok_t = ttri.triangulate_batch(
        ttri.FeatureObs(R_GtoC=t(sc["R_GtoC"]), p_CinG=t(sc["p_CinG"]),
                        uvn=t(sc["uvn"]), mask=t(sc["mask"], bool)),
        ttri.TriangulationOptions(*opts))
    ok_j, ok_t = np.asarray(ok_j), np_of(ok_t)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.sum() > 20 and not ok_j[:4].any()
    np.testing.assert_allclose(np_of(p_t)[ok_j], np.asarray(p_j)[ok_j],
                               atol=1e-4, rtol=rtol)


def test_gauss_newton_costs_match_jax():
    sc = scene(6)
    obs_j = jtri.FeatureObs(**{k: jnp.asarray(v) for k, v in sc.items()})
    obs_t = ttri.FeatureObs(R_GtoC=t(sc["R_GtoC"]), p_CinG=t(sc["p_CinG"]),
                            uvn=t(sc["uvn"]), mask=t(sc["mask"], bool))
    opts = jtri.TriangulationOptions()
    _, valid, p_A, a = jax.vmap(jtri.triangulate_linear, (0, None))(obs_j,
                                                                    opts)
    want = jax.vmap(jtri.refine_gauss_newton, (0, 0, 0, None))(
        obs_j, p_A, a, opts)
    got = ttri.refine_gauss_newton(obs_t, t(p_A), t(a, None).long(),
                                   ttri.TriangulationOptions())
    v = np.asarray(valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g)[v], np.asarray(w)[v], rtol=1e-3,
                                   atol=1e-6)
