"""The port's row-sharded EKF update (`parallel/sharded_ekf.py`) against the
JAX package's dense update.

The JAX package runs `core.ekf.kalman_update_math(..., fuse_downdate=False)`
under GSPMD with the covariance row-sharded; the port splits the same math
over gloo ranks with explicit collectives (one all_reduce of S, one
all_gather of Y₁'s column blocks, one all_to_all_single for the
symmetrization).  Here it runs on 2 and 4 CPU ranks spawned by
`torch.multiprocessing` (one spawn per world size, every case of the file
in it) and is held against JAX's dense `kalman_update_math(...,
fuse_downdate=False)` followed by `boxplus`, at tests/test_sharded_ekf.py's
tolerances: atol 1e-5 on p, 1e-4 on the covariance (2e-4 at the large
map's D = 1434); the padded rows and columns must stay exactly zero.
Cases: the graft problem's filter (5 clones, MSCKF only, D = 84, which
divides), tests/test_sharded_ekf.py's (11 clones, 25 landmarks, D = 195,
padded to 196) and the large map on 2 ranks.  The restored plain downdate
of the port's `kalman_update_math(fuse_downdate=False)` is held against
JAX's on one rank.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.core.state import boxplus as jboxplus
from open_vins_tpu.core.state import init_state as jinit_state
from open_vins_tpu_torch.core import ekf as tekf
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.parallel import dryrun, sharded_ekf
from torch_port_helpers import np_of, t, tree_to_numpy

CFGS = {
    "graft": dict(max_clones=5, max_slam=0, num_cams=1, max_msckf_in_update=8),
    "test_sharded_ekf": dict(max_clones=11, max_slam=25, num_cams=1),
    "large_map": dict(max_clones=30, max_slam=400, num_cams=1,
                      max_obs_per_feature=30),
}
COV_TOL = {"graft": 1e-4, "test_sharded_ekf": 1e-4, "large_map": 2e-4}
P_TOL = 1e-5
CASES = {2: ("graft", "test_sharded_ekf", "large_map"),
         4: ("graft", "test_sharded_ekf")}


def make_system(name, seed=0):
    """tests/test_sharded_ekf.py's `make_state` and system at the named
    configuration: a full window and full landmark slots, P = A Aᵀ +
    0.05 I.  Returns (JAX state, H, res, r_diag)."""
    cfg = JCfg(**CFGS[name])
    D = cfg.state_dim
    rng = np.random.default_rng(seed)
    scale, m = (0.05, 256) if name == "large_map" else (0.1, 64)
    A = rng.normal(size=(D, D)) * scale
    st = jinit_state(cfg)._replace(
        cov=jnp.asarray(A @ A.T + 0.05 * np.eye(D), jnp.float32),
        clone_valid=jnp.ones(cfg.max_clones, bool),
        slam_valid=jnp.ones(cfg.max_slam, bool),
        n_clones=jnp.asarray(cfg.max_clones, jnp.int32),
        head=jnp.asarray(cfg.max_clones - 1, jnp.int32))
    H = (rng.normal(size=(m, D)) * (0.1 if name == "large_map" else 0.2)
         ).astype(np.float32)
    res = (rng.normal(size=m) * 0.02).astype(np.float32)
    return st, H, res, np.full((m,), 0.01, np.float32)


def jax_dense(name, st, H, res, r):
    """JAX's dense update in the plain downdate form: the new state."""
    cfg = JCfg(**CFGS[name])
    dx, cov = jekf.kalman_update_math(st.cov, jnp.asarray(H),
                                      jnp.asarray(res), jnp.asarray(r),
                                      fuse_downdate=False)
    return jboxplus(st, cfg, dx)._replace(cov=cov)


@pytest.fixture(scope="module")
def systems():
    return {name: make_system(name) for name in CFGS}


@pytest.fixture(scope="module")
def ranks(systems):
    """Every case of a world size, stepped on that many gloo ranks in one
    spawn (at the first case of the world size): {world size: {name: the
    port's state as numpy}}."""
    done = {}

    def of(n):
        if n not in done:
            tasks = [dryrun.sharded_task(tree_to_numpy(systems[name][0]),
                                         *systems[name][1:],
                                         TCfg(**CFGS[name]))
                     for name in CASES[n]]
            out = dryrun.run_tasks(n, "gloo", tasks, device="cpu")
            done[n] = dict(zip(CASES[n], out))
        return done[n]

    return of


@pytest.mark.parametrize("n,name", [(n, name) for n in sorted(CASES)
                                    for name in CASES[n]])
def test_sharded_matches_jax_dense(ranks, systems, n, name):
    got = ranks(n)
    st, H, res, r = systems[name]
    want = jax_dense(name, st, H, res, r)
    D = JCfg(**CFGS[name]).state_dim
    Dp = sharded_ekf._padded_dim(D, n)
    cov = got[name]["cov"]
    assert cov.shape == (Dp, Dp)
    np.testing.assert_allclose(got[name]["p"], np.asarray(want.p),
                               atol=P_TOL, rtol=0)
    np.testing.assert_allclose(got[name]["q"], np.asarray(want.q),
                               atol=P_TOL, rtol=0)
    np.testing.assert_allclose(cov[:D, :D], np.asarray(want.cov),
                               atol=COV_TOL[name], rtol=0)
    assert not cov[D:].any() and not cov[:, D:].any()
    np.testing.assert_array_equal(cov, cov.T)  # symmetrized exactly


def test_fuse_downdate_false_matches_jax():
    """The restored plain downdate, one rank: the port's
    kalman_update_math(fuse_downdate=False) against JAX's, and against the
    port's default (the kernel's plain version on the CPU), which computes
    the same sym(P − Y₁ᵀY₁)."""
    st, H, res, r = make_system("test_sharded_ekf", seed=5)
    dx_j, cov_j = jekf.kalman_update_math(st.cov, jnp.asarray(H),
                                          jnp.asarray(res), jnp.asarray(r),
                                          fuse_downdate=False)
    dx_t, cov_t = tekf.kalman_update_math(t(st.cov), t(H), t(res), t(r),
                                          fuse_downdate=False)
    scale = np.abs(np.asarray(cov_j)).max()
    np.testing.assert_allclose(np_of(cov_t), np.asarray(cov_j),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(np_of(dx_t), np.asarray(dx_j),
                               atol=1e-5 * max(1.0, np.abs(dx_j).max()),
                               rtol=0)
    assert torch.equal(cov_t, cov_t.T)
    dx_k, cov_k = tekf.kalman_update_math(t(st.cov), t(H), t(res), t(r))
    torch.testing.assert_close(cov_k, cov_t, atol=1e-6 * scale, rtol=0)
    torch.testing.assert_close(dx_k, dx_t, atol=0, rtol=0)


def test_single_rank_is_dense():
    """No process group: the sharded update is the dense plain update, the
    covariance unpadded."""
    name = "test_sharded_ekf"
    st, H, res, r = make_system(name, seed=2)
    from open_vins_tpu_torch import convert

    tst = sharded_ekf.shard_state(
        convert.state_from_numpy(tree_to_numpy(st), "cpu"), device="cpu")
    out = sharded_ekf.sharded_ekf_update(None, TCfg(**CFGS[name]))(
        tst, t(H), t(res), t(r))
    want = jax_dense(name, st, H, res, r)
    np.testing.assert_allclose(np_of(out.p), np.asarray(want.p), atol=P_TOL)
    np.testing.assert_allclose(np_of(out.cov), np.asarray(want.cov),
                               atol=COV_TOL[name])


def test_pad_cov_and_row_blocks():
    cov = torch.arange(25.0).reshape(5, 5)
    padded = sharded_ekf.pad_cov(cov, 4)
    assert padded.shape == (8, 8)
    assert torch.equal(padded[:5, :5], cov) and not padded[5:].any()
    assert sharded_ekf.pad_cov(cov, 5) is cov
    assert [sharded_ekf.row_block(8, r, 4) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
