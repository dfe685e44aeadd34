"""Parity of the port's measurement linearization with the JAX package:
feature Jacobians (with a feature inside 5 cm of a clone camera), nullspace
projection, the χ² statistic, CholeskyQR2 compression (R to 1e-4) and the
tie-breaking of the top-F candidate selection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import state as jstate
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import update_helper as juh
from open_vins_tpu.ops import cameras as jcam
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import update_helper as tuh
from torch_port_helpers import jax_state_to_port, np_of, t

ZETA = np.array([458.65, 457.30, 367.2, 248.4, -0.2834, 0.0739, 1.9e-4,
                 1.8e-5], np.float32)


def _problem(cfg, seed=0, F=12):
    """A JAX state with a full clone window (FEJ values slightly off the
    current ones) and F features observed from it; feature 0 sits 3 cm in
    front of the camera of clone slot 2."""
    rng = np.random.default_rng(seed)
    C = cfg.max_clones
    st = jstate.init_state(cfg)
    rv = rng.normal(size=(C, 3)) * 0.1
    q = np.asarray(jax.vmap(jlie.rot_2_quat)(jax.vmap(jlie.exp_so3)(
        jnp.asarray(rv, jnp.float32))))
    q_fej = np.asarray(jax.vmap(jlie.rot_2_quat)(jax.vmap(jlie.exp_so3)(
        jnp.asarray(rv + 1e-3 * rng.normal(size=(C, 3)), jnp.float32))))
    p = np.stack([np.linspace(0, 1, C), 0.1 * rng.normal(size=C),
                  0.1 * rng.normal(size=C)], 1).astype(np.float32)
    cov = rng.normal(size=(cfg.state_dim, cfg.state_dim)) * 1e-2
    st = st._replace(
        clones_q=jnp.asarray(q), clones_q_fej=jnp.asarray(q_fej),
        clones_p=jnp.asarray(p), clones_p_fej=jnp.asarray(p + 1e-3),
        clone_valid=jnp.ones(C, bool), n_clones=jnp.asarray(C, jnp.int32),
        head=jnp.asarray(C - 1, jnp.int32),
        calib_ext_q=jnp.asarray([[0.01, -0.02, 0.005, 1.0]]) /
        np.linalg.norm([0.01, -0.02, 0.005, 1.0]),
        calib_ext_p=jnp.asarray([[0.05, -0.01, 0.02]], jnp.float32),
        calib_intr=jnp.asarray(ZETA[None]),
        cov=jnp.asarray(cov @ cov.T + 1e-4 * np.eye(cfg.state_dim),
                        jnp.float32))
    O = C
    slot_idx = jnp.arange(C, dtype=jnp.int32)
    cam_idx = jnp.zeros(C, jnp.int32)
    ctx = juh.obs_context(st, cfg, slot_idx, cam_idx)
    R_GtoC = np.asarray(ctx.R_ItoC @ ctx.R_GtoI)
    p_CinG = np.asarray(ctx.p_c) - np.einsum(
        "oji,ojk,ok->oi", np.asarray(ctx.R_GtoI), np.asarray(ctx.R_ItoC),
        np.asarray(ctx.p_IinC))
    p_f = np.stack([rng.uniform(-2, 2, F), rng.uniform(-1.5, 1.5, F),
                    rng.uniform(3, 8, F)], 1) + np.array([0.5, 0, 0])
    p_f[0] = p_CinG[2] + R_GtoC[2].T @ np.array([0.0, 0.0, 0.03])
    p_f = p_f.astype(np.float32)
    p_C = np.einsum("oij,foj->foi", R_GtoC, p_f[:, None] - p_CinG[None])
    uvn = p_C[..., :2] / p_C[..., 2:3]
    uv = np.asarray(jcam.distort("radtan", jnp.asarray(ZETA),
                                 jnp.asarray(uvn, jnp.float32)))
    uv = (uv + rng.normal(size=uv.shape)).astype(np.float32)
    mask = rng.uniform(size=(F, O)) > 0.15
    mask[0] = True
    gobs = juh.GatheredObs(
        clone_slot=jnp.broadcast_to(slot_idx, (F, O)),
        cam=jnp.broadcast_to(cam_idx, (F, O)),
        uv=jnp.asarray(uv), uvn=jnp.asarray(uvn, jnp.float32),
        mask=jnp.asarray(mask))
    return st, gobs, ctx, p_f


def _port_gobs(gobs):
    return tuh.GatheredObs(
        clone_slot=t(gobs.clone_slot, torch.int64),
        cam=t(gobs.cam, torch.int64), uv=t(gobs.uv), uvn=t(gobs.uvn),
        mask=t(gobs.mask, torch.bool))


@pytest.mark.parametrize("calib", [False, True])
def test_feature_jacobian_projection_and_chi2(calib):
    kw = dict(max_clones=5, max_slam=0, num_cams=1,
              calib_cam_extrinsics=calib, calib_cam_intrinsics=calib)
    jc, tc = JCfg(**kw), TCfg(**kw)
    st, gobs, ctx, p_f = _problem(jc, seed=1 + calib)
    want = juh.feature_jacobian_batch(st, jc, gobs, jnp.asarray(p_f),
                                      jnp.asarray(p_f), ctx)
    st_t = jax_state_to_port(st)
    g_t = _port_gobs(gobs)
    ctx_t = tuh.obs_context(st_t, tc, g_t.clone_slot[0], g_t.cam[0])
    got = tuh.feature_jacobian_batch(st_t, tc, g_t, t(p_f), t(p_f), ctx_t)
    for name, g, w in zip(("H_x", "H_f", "res", "row_mask"), got, want):
        w = np.asarray(w)
        tol = 0 if w.dtype == bool else 1e-5 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(np_of(g), w, atol=tol, rtol=0,
                                   err_msg=name)
    # the 5 cm gate dropped the observation at clone slot 2 of feature 0
    rm = np_of(got[3])
    assert not rm[0, 4:6].any() and rm[1:].any()
    assert not np_of(got[0])[0, 4:6].any()

    H_j, r_j = jax.vmap(juh.nullspace_project)(*want[:3])
    H_t, r_t = tuh.nullspace_project(*got[:3])
    scale = np.abs(np.asarray(H_j)).max()
    np.testing.assert_allclose(np_of(H_t), np.asarray(H_j),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(np_of(r_t), np.asarray(r_j),
                               atol=1e-5 * max(1.0, np.abs(r_j).max()),
                               rtol=0)

    sup = jc.cam_meas_support_ranges
    P_ss = juh.take_cols(juh.take_cols(st.cov, sup).T, sup)
    g_j = jax.vmap(lambda H, r: juh.chi2_statistic(
        P_ss, juh.take_cols(H, sup), r, jc.sigma_pix))(H_j, r_j)
    g_t = tuh.chi2_statistic(t(P_ss), tuh.take_cols(H_t, sup), r_t,
                             tc.sigma_pix)
    np.testing.assert_allclose(np_of(g_t), np.asarray(g_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("m", [60, 400])
def test_compress_system_ranges(m):
    cfg = JCfg(max_clones=11, max_slam=0)
    D, ranges = cfg.state_dim, cfg.cam_meas_support_ranges
    rng = np.random.default_rng(m)
    H = np.zeros((m, D), np.float32)
    for a, b in ranges:
        H[:, a:b] = rng.normal(size=(m, b - a))
    H[:, ranges[1][0]] = 0.0  # a structurally zero column (uncalibrated dt)
    res = rng.normal(size=m).astype(np.float32)
    Hc_j, rc_j = juh.compress_system_ranges(jnp.asarray(H), jnp.asarray(res),
                                            ranges, D)
    Hc_t, rc_t = tuh.compress_system_ranges(t(H), t(res), ranges, D)
    np.testing.assert_allclose(np_of(Hc_t), np.asarray(Hc_j), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(np_of(rc_t), np.asarray(rc_j), atol=1e-4,
                               rtol=0)
    # the compressed system keeps the information: H_cᵀH_c = HᵀH
    Hc = np_of(Hc_t).astype(np.float64)
    np.testing.assert_allclose(Hc.T @ Hc, H.T.astype(np.float64) @ H,
                               atol=2e-3 * m, rtol=0)


def test_candidate_selection_breaks_ties_like_top_k():
    rng = np.random.default_rng(4)
    for T, F in ((384, 40), (64, 8)):
        score = np.where(rng.uniform(size=T) > 0.4,
                         rng.integers(3, 7, size=T), -1).astype(np.float32)
        _, want = jax.lax.top_k(jnp.asarray(score), F)
        got = tman.select_candidates(torch.as_tensor(score), F)
        np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_chi2_statistic_singular_system_is_gated():
    """A singular S above the 32-row unrolled path (41 rows: a stereo
    landmark's delayed-init leftovers, 2 × 11 observations − 3) gives a
    non-finite γ in both packages, which the `isfinite(γ)` gates drop,
    instead of raising in the port; beside it a regular 41-row system gives
    the same γ (1e-4 relative)."""
    rng = np.random.default_rng(3)
    k, m = 12, 41
    A = rng.normal(size=(k, k))
    P = (A @ A.T / k + 0.1 * np.eye(k)).astype(np.float32)
    H = rng.normal(size=(m, k)).astype(np.float32)
    H[25:] = 0.0  # zero rows and σ = 0: S has exact zero rows and columns
    res = rng.normal(size=(m,)).astype(np.float32)
    for sigma, singular in ((0.0, True), (0.5, False)):
        want = float(juh.chi2_statistic(jnp.asarray(P), jnp.asarray(H),
                                        jnp.asarray(res), sigma))
        got = float(tuh.chi2_statistic(t(P), t(H), t(res), sigma))
        assert np.isfinite(want) != singular
        if singular:
            assert not np.isfinite(got)
        else:
            assert got == pytest.approx(want, rel=1e-4)
        gate = 1e3
        assert (np.isfinite(got) and got < gate) == (np.isfinite(want)
                                                     and want < gate)
