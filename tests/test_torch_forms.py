"""The port's push-through update forms and landmark insertion against the
JAX package (core/ekf.py, update_helper.py), per function and per step.

Per function, on the same seeded numpy inputs in both packages (the
configuration of tests/test_ekf.py: 4 clones, 3 landmark slots, D = 87, the
camera support of k = 39 columns), in the three covariance cases of
tests/test_ekf.py:131-436: a healthy P, a P whose support is half dead
(exact zero rows) and the f32 residue of repeated downdates on the dead
dims.  The forms are the same algebra in f32 with the factorizations of
another library (LAPACK against torch's), so dx is held to
2e-5·max(1, max|dx|) and the covariance to 2e-5·max|P_ij|, except where a
test says otherwise:

* `kalman_update_math_info` (with γ), `kalman_update_math_spd`,
  `kalman_update_math_newton` plain and Joseph, with and without a gauge
  basis (its residual too), and the newton form beyond the fixed
  iteration's regime, where the polish sweeps run (the port masks them on
  the device instead of exiting a loop) and on a non-finite input (an exact
  no-op with an infinite residual);
* `chi2_gamma_info`, `newton_inverse`, `gauge_null_basis_support`,
  `initialize_landmark`, `marginalize_slam_slot`, `feature_jacobian` and
  `compress_system_cholesky`.

Per step: `step_frame` in the "woodbury", "spd" and "newton" forms (and
newton with the Joseph form and the gauge deflation) on the small SLAM
problem (`torch_port_helpers.slam_problem`), both packages stepping from
the same JAX state at every frame over the first 10 frames, in which
landmarks are initialized and updated.  The tolerances are those of
tests/test_torch_slam.py (values 3e-4, the covariance at 5e-5·‖P‖∞,
new-landmark blocks at 2e-3 of their max) for "woodbury" and "spd".  The
newton form is less reproducible in f32: its 14 Newton sweeps and polish
amplify rounding, and the reference's own jit and eager steps differ by up
to 4.2e-4 in the values and 8.8e-5·‖P‖∞ (9.6e-5 with Joseph and the
gauge deflation) on these frames (tests/torch_step_spread.py --problem
slam --frames 16 --set joint_update_form=newton --set newton_iters=14),
where the port's gap reaches 1.8e-4 and 7.4e-5·‖P‖∞.  So the newton steps
are held to 1e-3 in the values and 2e-4·‖P‖∞ (about twice the reference's
own spread), and the newton residual to 1e-3 (both are under the polish
tolerance, 1e-3, on these frames).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.core import ekf as jekf
from open_vins_tpu.core import state as jstate
from open_vins_tpu.core.layout import FilterConfig as JCfg
from open_vins_tpu.models import manager as jman
from open_vins_tpu.models import update_helper as juh
from open_vins_tpu.ops import lie as jlie
from open_vins_tpu_torch.core import ekf as tekf
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import update_helper as tuh
from test_torch_slam import (SLAM_EXACT_FIELDS, _jax_steps,
                             assert_slam_state_close)
from torch_port_helpers import (assert_table_equal, jax_frames_to_port,
                                jax_state_to_port, jax_table_to_port, np_of,
                                slam_problem, t)

KW = dict(max_clones=4, max_slam=3, num_cams=1)
JC, TC = JCfg(**KW), TCfg(**KW)
D = JC.state_dim
RANGES = JC.cam_meas_support_ranges
K_SUP = sum(b - a for a, b in RANGES)
CASES = ("healthy", "singular", "residue")


def _spd(n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) * scale
    return A @ A.T + 0.01 * np.eye(n)


def _dead():
    a0, b0 = RANGES[0]
    return np.arange(a0 + (b0 - a0) // 2, b0)


def _cov(case, seed):
    """tests/test_ekf.py's three covariances, float32 [D, D]."""
    P = _spd(D, seed)
    if case == "healthy":
        return P.astype(np.float32)
    dead = _dead()
    mask = np.ones(D, bool)
    mask[dead] = False
    P = P * np.outer(mask, mask)
    if case == "residue":
        rng = np.random.default_rng(seed + 100)
        a0, b0 = RANGES[0]
        P[dead, dead] = rng.uniform(-1e-12, 1e-12, size=dead.size)
        for i in dead[::2]:
            j = (i - a0 + 3) % (b0 - a0) + a0
            P[i, j] = P[j, i] = 1e-9 * rng.normal()
    return P.astype(np.float32)


def _system(case, seed, m=4 * K_SUP, h_scale=0.5):
    """A tall whitened stack on the support (dead columns zero)."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, D))
    for a, b in RANGES:
        H[:, a:b] = rng.normal(size=(m, b - a)) * h_scale
    if case != "healthy":
        H[:, _dead()] = 0.0
    res = rng.normal(size=(m,)) * 0.05
    return H.astype(np.float32), res.astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    """fn_j on the JAX arrays and fn_t on the torch tensors of `arrays`;
    numpy results."""
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(t(a) for a in arrays), **kw)
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return ([np.asarray(o) for o in out_j], [np_of(o) for o in out_t])


def _close_update(got, want, P, dx_rel=2e-5, cov_rel=2e-5):
    (dx_t, cov_t), (dx_j, cov_j) = got[:2], want[:2]
    np.testing.assert_allclose(dx_t, dx_j, rtol=0,
                               atol=dx_rel * max(1.0, np.abs(dx_j).max()))
    np.testing.assert_allclose(cov_t, cov_j, rtol=0,
                               atol=cov_rel * np.abs(P).max())
    assert np.isfinite(cov_t).all() and (cov_t == cov_t.T).all()


@pytest.mark.parametrize("case", CASES)
def test_info_form_matches_jax(case):
    P = _cov(case, 11)
    H, res = _system(case, 12)
    want, got = _both(jekf.kalman_update_math_info,
                      tekf.kalman_update_math_info, P, H, res,
                      ranges=RANGES, return_gamma=True)
    _close_update(got, want, P)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_spd_form_matches_jax(case):
    P = _cov(case, 21)
    H, res = _system(case, 22)
    want, got = _both(jekf.kalman_update_math_spd,
                      tekf.kalman_update_math_spd, P, H, res, ranges=RANGES)
    _close_update(got, want, P)


def _gauge_basis(seed):
    """An orthonormal [k, 4] basis on the support."""
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.normal(size=(K_SUP, 4)))[0].astype(np.float32)


@pytest.mark.parametrize("basis", [False, True])
@pytest.mark.parametrize("joseph", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_newton_form_matches_jax(case, joseph, basis):
    P = _cov(case, 41)
    H, res = _system(case, 42)
    N = _gauge_basis(43) if basis else None
    want = jekf.kalman_update_math_newton(
        jnp.asarray(P), jnp.asarray(H), jnp.asarray(res), RANGES,
        return_gamma=True, return_resid=True, joseph=joseph,
        null_basis=None if N is None else jnp.asarray(N))
    got = tekf.kalman_update_math_newton(
        t(P), t(H), t(res), RANGES, return_gamma=True, return_resid=True,
        joseph=joseph, null_basis=None if N is None else t(N))
    want, got = [np.asarray(w) for w in want], [np_of(g) for g in got]
    _close_update(got, want, P)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    assert got[3] < 1e-3 and want[3] < 1e-3


def test_newton_polish_beyond_regime_matches_jax():
    """σ = ‖A‖_F beyond the fixed iteration's 2.6e5 (tests/test_ekf.py
    case (a)): the polish sweeps run, and the port's masked sweeps give the
    reference's while loop's solve; a NaN in H is an exact no-op with an
    infinite residual (case (c))."""
    P = _cov("healthy", 77) * 200.0
    H, res = _system("healthy", 78, h_scale=2.5)
    H_s = juh.take_cols(jnp.asarray(H), RANGES)
    P_ss = juh.take_cols(juh.take_cols(jnp.asarray(P), RANGES).T, RANGES)
    A = np.eye(K_SUP) + np.asarray(H_s.T @ H_s @ P_ss)
    assert np.sqrt((A * A).sum()) > 2.6e5
    want, got = _both(jekf.kalman_update_math_newton,
                      tekf.kalman_update_math_newton, P, H, res,
                      ranges=RANGES, return_resid=True)
    assert 1e-7 < want[2] < 5e-2 and got[2] < 5e-2
    scale = np.abs(want[1]).max()
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=2e-4 * np.abs(want[0]).max())
    np.testing.assert_allclose(got[1] / scale, want[1] / scale, rtol=0,
                               atol=1e-4)

    H[0, RANGES[0][0]] = np.nan
    want, got = _both(jekf.kalman_update_math_newton,
                      tekf.kalman_update_math_newton, _cov("healthy", 79), H,
                      res, ranges=RANGES, return_resid=True)
    for w in (want, got):
        assert not np.isfinite(w[2])
        np.testing.assert_array_equal(w[0], np.zeros(D))
    np.testing.assert_array_equal(got[1], _cov("healthy", 79))


@pytest.mark.parametrize("case", CASES)
def test_chi2_gamma_info_matches_jax(case):
    P = _cov(case, 51)
    H, res = _system(case, 52)
    want, got = _both(jekf.chi2_gamma_info, tekf.chi2_gamma_info, P, H, res,
                      ranges=RANGES)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def _spectra(k=231, lmaxes=(10.0, 1e3, 1e4)):
    """tests/test_ekf.py:245-261's matrices: SPD with spectrum [1, lmax],
    drawn in turn from one generator (float64, and the lmax of each)."""
    rng = np.random.default_rng(7)
    for lmax in lmaxes:
        Q, _ = np.linalg.qr(rng.normal(size=(k, k)))
        lam = np.concatenate([[1.0, lmax], np.exp(
            rng.uniform(0, np.log(lmax), size=k - 2))])
        yield (Q * lam) @ Q.T, lmax


@pytest.mark.parametrize("which", range(3))
def test_newton_inverse_matches_jax(which):
    """tests/test_ekf.py's spectra at k = 231: the inverses agree to 1e-4
    of max|X|, and the port's residual ‖XA − I‖max stays within 1.5 times
    the reference's own (or tests/test_ekf.py's bound).  At λmax = 1e4 the
    residual is f32 resolution: the reference reaches 9.9e-3 of its bound
    1.1e-2, the port 1.22e-2 with another library's f32 matmul."""
    A64, lmax = list(_spectra())[which]
    A = A64.astype(np.float32)
    want, got = _both(jekf.newton_inverse, tekf.newton_inverse, A)
    resid = [np.abs(X @ A64 - np.eye(A.shape[0])).max()
             for X in (want[0], got[0])]
    bound = 1e-2 * lmax * 1e-4 + 1e-3
    assert resid[0] < bound
    assert resid[1] < max(bound, 1.5 * resid[0])
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=1e-4 * np.abs(want[0]).max())


def _landmark_state(rep, seed=5):
    """A JAX state with 4 clones (one invalid), 2 of 3 landmarks valid,
    random FEJ values and a random covariance."""
    rng = np.random.default_rng(seed)
    cfg = JCfg(**KW, feat_rep_slam=rep)
    st = jstate.init_state(cfg)
    q = rng.normal(size=(cfg.max_clones, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    f32 = np.float32
    st = st._replace(
        clones_q_fej=jnp.asarray(q, f32), clones_q=jnp.asarray(q, f32),
        clones_p_fej=jnp.asarray(rng.normal(size=(4, 3)), f32),
        clones_p=jnp.asarray(rng.normal(size=(4, 3)), f32),
        clone_valid=jnp.asarray([True, True, False, True]),
        n_clones=jnp.asarray(3, jnp.int32), head=jnp.asarray(3, jnp.int32),
        slam_p_fej=jnp.asarray(rng.normal(size=(3, 3)) * 3, f32),
        slam_p=jnp.asarray(rng.normal(size=(3, 3)) * 3, f32),
        slam_valid=jnp.asarray([True, False, True]),
        slam_id=jnp.asarray([7, -1, 9], jnp.int32),
        cov=jnp.asarray(_spd(D, seed + 1), f32))
    return cfg, st


@pytest.mark.parametrize("rep", ["GLOBAL_3D", "ANCHORED_MSCKF_INVERSE_DEPTH"])
def test_gauge_null_basis_matches_jax(rep):
    cfg, st = _landmark_state(rep)
    ranges = cfg.slam_meas_support_ranges
    want = np.asarray(jekf.gauge_null_basis_support(st, cfg, ranges))
    got = np_of(tekf.gauge_null_basis_support(jax_state_to_port(st),
                                              TCfg(*cfg), ranges))
    assert tekf.gauge_deflation_supported(TCfg(*cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.T @ got, np.eye(4), atol=1e-5)


def test_marginalize_slam_slot_matches_jax():
    cfg, st = _landmark_state("GLOBAL_3D")
    want = jekf.marginalize_slam_slot(st, cfg, jnp.asarray(2))
    got = tekf.marginalize_slam_slot(jax_state_to_port(st), TCfg(*cfg),
                                     torch.tensor(2))
    for k in ("cov", "slam_valid", "slam_id"):
        np.testing.assert_array_equal(np_of(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)


def _feature_obs(cfg, st, seed):
    """A landmark seen from the 3 valid clones (one observation masked), as
    the JAX and the port GatheredObs [O = 4]."""
    rng = np.random.default_rng(seed)
    p_f = np.asarray([0.3, -0.2, 4.0], np.float32)
    O = cfg.max_clones
    uv = (rng.normal(size=(O, 2)) * 5 + 300).astype(np.float32)
    mask = np.asarray([True, True, False, True])
    arrays = dict(clone_slot=np.arange(O, dtype=np.int32),
                  cam=np.zeros(O, np.int32), uv=uv,
                  uvn=(uv - 300) / 400, mask=mask)
    obs_j = juh.GatheredObs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    obs_t = tuh.GatheredObs(**{k: torch.as_tensor(v)
                               for k, v in arrays.items()})
    return p_f, obs_j, obs_t


def _camera_state(st, seed):
    """st with clones looking down +z at the origin from about 4 m, and a
    calibrated pinhole camera."""
    rng = np.random.default_rng(seed)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (4, 1)) + rng.normal(size=(4, 4)) * 0.02
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    p = (rng.normal(size=(4, 3)) * 0.2).astype(np.float32)
    intr = np.asarray([[400, 400, 300, 300, 0.01, -0.01, 1e-3, -1e-3]],
                      np.float32)
    return st._replace(clones_q=jnp.asarray(q), clones_q_fej=jnp.asarray(q),
                       clones_p=jnp.asarray(p),
                       clones_p_fej=jnp.asarray(p + 1e-3),
                       calib_intr=jnp.asarray(intr))


def test_feature_jacobian_matches_jax():
    cfg, st = _landmark_state("GLOBAL_3D")
    st = _camera_state(st, 6)
    p_f, obs_j, obs_t = _feature_obs(cfg, st, 7)
    want = jax.jit(juh.feature_jacobian, static_argnums=1)(
        st, cfg, obs_j, jnp.asarray(p_f), jnp.asarray(p_f + 0.01))
    got = tuh.feature_jacobian(jax_state_to_port(st), TCfg(*cfg), obs_t,
                               t(p_f), t(p_f + 0.01))
    for w, g, name in zip(want, got, ("H_x", "H_f", "res", "row_mask")):
        w, g = np.asarray(w), np_of(g)
        if name == "row_mask":
            np.testing.assert_array_equal(g, w)
            assert w.sum() == 6
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * max(1, np.abs(w).max()),
                                       err_msg=name)


def test_initialize_landmark_matches_jax():
    """One landmark into free slot 1 from a feature system of 3
    observations (tests/test_ekf.py's delayed init): the state, the
    landmark's covariance blocks and the leftover rows."""
    cfg, st = _landmark_state("GLOBAL_3D", seed=8)
    st = _camera_state(st, 9)
    p_f, obs_j, _ = _feature_obs(cfg, st, 10)
    H_x, H_f, res, row_mask = juh.feature_jacobian(
        st, cfg, obs_j, jnp.asarray(p_f), jnp.asarray(p_f))
    # the free slot's rows are zero, as after marginalize_slam_slot
    st = jekf.marginalize_slam_slot(st, cfg, jnp.asarray(1))
    sigma = 1.0 / 400
    want = jekf.initialize_landmark(st, cfg, jnp.asarray(1), jnp.asarray(42),
                                    jnp.asarray(p_f), H_x, H_f, res, sigma,
                                    row_mask)
    got = tekf.initialize_landmark(
        jax_state_to_port(st), TCfg(*cfg), torch.tensor(1), torch.tensor(42),
        t(p_f), t(H_x), t(H_f), t(res), sigma,
        torch.as_tensor(np.array(row_mask)))
    st_j, st_t = want[0], got[0]
    for k in ("slam_valid", "slam_id"):
        np.testing.assert_array_equal(np_of(getattr(st_t, k)),
                                      np.asarray(getattr(st_j, k)))
    for k in ("slam_p", "slam_p_fej"):
        np.testing.assert_allclose(np_of(getattr(st_t, k)),
                                   np.asarray(getattr(st_j, k)), rtol=0,
                                   atol=1e-4, err_msg=k)
    cov_j = np.asarray(st_j.cov)
    np.testing.assert_allclose(np_of(st_t.cov), cov_j, rtol=0,
                               atol=1e-4 * np.abs(cov_j).max())
    off = cfg.slam_off + 3
    assert np.abs(cov_j[off:off + 3]).max() > 0
    for w, g in zip(want[1:], got[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(np_of(g), w, rtol=0,
                                   atol=1e-5 * max(1, np.abs(w).max()))


@pytest.mark.parametrize("out_rows", [D, D + 5])
def test_compress_system_cholesky_matches_jax(out_rows):
    H, res = _system("healthy", 61, m=3 * D)
    want, got = _both(juh.compress_system_cholesky,
                      tuh.compress_system_cholesky, H, res,
                      out_rows=out_rows)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


# form -> (configuration, value tolerance, covariance tolerance ·‖P‖∞)
FORMS = {"woodbury": (dict(joint_update_form="woodbury"), 3e-4, 5e-5),
         "spd": (dict(joint_update_form="spd"), 3e-4, 5e-5),
         "newton": (dict(joint_update_form="newton", newton_iters=14), 1e-3,
                    2e-4),
         "newton_joseph_gauge": (dict(joint_update_form="newton",
                                      newton_iters=14, newton_joseph=True,
                                      gauge_deflation=True), 1e-3, 2e-4)}
STEP_FRAMES = 10


@pytest.mark.parametrize("form", list(FORMS))
def test_step_frame_form_matches_jax(form):
    pb = slam_problem()
    form_kw, val_tol, cov_tol = FORMS[form]
    kw = dict(pb.cfg_jax._asdict(), **form_kw)
    jc, tc = JCfg(**kw), TCfg(**kw)
    frames_t = jax_frames_to_port(pb.frames)
    n_init = 0
    for k, st_j, tb_j, post in _jax_steps(pb, jc, STEP_FRAMES):
        st_t, tb_t, d_t = tman.step_frame(
            jax_state_to_port(st_j), jax_table_to_port(tb_j), tc,
            pb.tri_port, trun.frame_at(frames_t, k))
        where = f"{form} frame {k}"
        for f in ("n_msckf", "n_slam", "n_slam_used"):
            assert int(getattr(d_t, f)) == int(getattr(post[2], f)), where
        assert_slam_state_close(st_t, post[0], st_j, jc, where, val_tol,
                                cov_tol)
        assert_table_equal(tb_t, post[1], where=where)
        np.testing.assert_allclose(float(d_t.newton_resid),
                                   float(post[2].newton_resid), rtol=0,
                                   atol=1e-3, err_msg=where)
        n_init += int((np.asarray(post[0].slam_valid)
                       & ~np.asarray(st_j.slam_valid)).sum())
    assert n_init > 0, "no landmark was initialized"
