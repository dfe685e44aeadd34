"""The port's symmetric_downdate: its plain version against the TPU kernel
(Pallas, interpret mode) and the reference's jnp form, the wrapper's checks
and launch count.  The CUDA kernel against the plain version is in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.ops import pallas_kernels as pk
from open_vins_tpu_torch.ops import kernels
from torch_port_helpers import downdate_inputs, imu_window_inputs, np_of

# the oracle shapes of tests/test_pallas_kernels.py plus the MSCKF-only
# main path's (D = 120, support m = 81)
SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81)]


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", SHAPES)
def test_plain_version_matches_tpu_kernel(D, m, same):
    P, K, PHt = downdate_inputs(D, m, same)
    got = np_of(kernels.symmetric_downdate(torch.from_numpy(P),
                                           torch.from_numpy(K),
                                           torch.from_numpy(PHt)))
    pallas = np.asarray(pk.symmetric_downdate_pallas(
        jnp.asarray(P), jnp.asarray(K), jnp.asarray(PHt), interpret=True))
    dense = np.asarray(pk._symmetric_downdate_jnp(
        jnp.asarray(P), jnp.asarray(K), jnp.asarray(PHt)))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, got.T)  # exact symmetry


def test_cpu_call_counts_no_launch():
    P, K, PHt = (torch.from_numpy(a) for a in downdate_inputs(120, 81, True))
    before = kernels.symmetric_downdate.launches
    kernels.symmetric_downdate(P, K, K)
    assert kernels.symmetric_downdate.launches == before


def test_same_operand_detection():
    """The wrapper asks the kernel for the single product K·Kᵀ only when K
    and PHt are one tensor: not for an equal copy nor a transposed view."""
    K = torch.from_numpy(downdate_inputs(24, 24, True)[1])
    assert kernels.same_operand(K, K)
    assert kernels.same_operand(K, K.view(24, 24))
    assert not kernels.same_operand(K, K.clone())
    assert not kernels.same_operand(K, K.T)
    assert not kernels.same_operand(K, K[:, :12])


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape"])
def test_wrapper_rejects_bad_arguments(bad):
    P, K, PHt = (torch.from_numpy(a) for a in downdate_inputs(32, 8, False))
    if bad == "dtype":
        P = P.double()
    elif bad == "contiguous":
        K = torch.from_numpy(np.ascontiguousarray(K.numpy().T)).T
    else:
        PHt = PHt[:, :4].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kernels.symmetric_downdate(P, K, PHt)


# ---------------------------------------------------------------------------
# imu_rk4_window: the plain version is the rk4 branch of propagate as it ran
# before the window had a kernel, bit for bit.  The CUDA kernel against the
# plain version is in tests/test_torch_cuda.py.

SIGMAS = (1.6968e-4, 2.0e-3, 1.9393e-5, 3.0e-3)


def _loop_rk4_window(x, mats, t, w, a, cfg):
    """propagate's rk4 branch as it stood with no window kernel (a frozen
    copy): the corrected samples, the Python loop of `_step_mean_rk4`,
    `_phi_qd` at the FEJ point then the mean, `_mask_padded`,
    `_compose_transitions` and the symmetrized Qd."""
    from open_vins_tpu_torch.models import propagator as P

    q, p, v, q_fej, p_fej, v_fej, bg, ba = torch.split(
        x, (4, 3, 3, 4, 3, 3, 3, 3))
    Dw, Da, Tg, R_w, R_a = mats
    gravity = torch.tensor([0.0, 0.0, cfg.gravity_mag], dtype=x.dtype)
    K = t.shape[0]
    dts = torch.clamp(t[1:] - t[:-1], min=0.0)
    u_a = a - ba
    ac = P._matvec(R_a, P._matvec(Da, u_a))
    u_w = w - bg - P._matvec(Tg, ac)
    wc = P._matvec(R_w, P._matvec(Dw, u_w))
    zero3 = torch.zeros(3, dtype=x.dtype)
    outs = []
    for k in range(K - 1):
        q, p, v, w_hat, a_hat = P._step_mean_rk4(
            q, p, v, zero3, zero3, wc[k], ac[k], wc[k + 1], ac[k + 1], dts[k],
            gravity)
        outs.append((q, p, v, w_hat, a_hat))
    q_end, p_end, v_end, w_hats, a_hats = (torch.stack(z) for z in zip(*outs))
    q_lin = torch.cat([q_fej[None], q_end[:-1]])
    p_lin = torch.cat([p_fej[None], p_end[:-1]])
    v_lin = torch.cat([v_fej[None], v_end[:-1]])
    Phis, Bs, Qds = P._phi_qd(
        (q_lin, p_lin, v_lin), (q_end, p_end, v_end), gravity, dts, cfg,
        (Dw, Da, Tg, R_w, R_a, w_hats, a_hats, u_w[:-1], u_a[:-1]))
    Phis, Bs, Qds = P._mask_padded(Phis, Bs, Qds, dts)
    Phi, _, Qd = P._compose_transitions(Phis, Bs, Qds)
    return torch.cat([q, p, v]), Phi, 0.5 * (Qd + Qd.T)


def _rk4_cfg():
    from open_vins_tpu_torch.core.layout import FilterConfig

    return FilterConfig(max_clones=11, max_slam=0, sigma_w=SIGMAS[0],
                        sigma_a=SIGMAS[1], sigma_wb=SIGMAS[2],
                        sigma_ab=SIGMAS[3])


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("pad", [0, 3])
def test_rk4_window_plain_version_is_the_loop(pad, identity, batched):
    """imu_rk4_window_ref, and the wrapper on CPU tensors (under vmap too),
    equal the loop exactly, on the fixture's windows padded by 0 and 3
    repeated samples with a FEJ point off the estimate."""
    cfg = _rk4_cfg()
    ops = [torch.from_numpy(z) for z in imu_window_inputs(3, pad, seed=pad,
                                                          identity=identity)]

    def loop(x, mats, t, w, a):
        return _loop_rk4_window(x, mats.unbind(0), t, w, a, cfg)

    def ref(x, mats, t, w, a):
        return kernels.imu_rk4_window_ref(x, mats, t, w, a, cfg.gravity_mag,
                                          *SIGMAS)

    def wrapped(x, mats, t, w, a):
        return kernels.imu_rk4_window(x, mats, t, w, a, cfg.gravity_mag,
                                      *SIGMAS)

    if batched:
        want = torch.func.vmap(loop)(*ops)
        gots = [torch.func.vmap(ref)(*ops), torch.func.vmap(wrapped)(*ops)]
    else:
        want = loop(*(o[0] for o in ops))
        gots = [fn(*(o[0] for o in ops)) for fn in (ref, wrapped)]
    for got in gots:
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


def test_rk4_window_cpu_call_counts_no_launch():
    ops = [torch.from_numpy(z) for z in imu_window_inputs(2)]
    before = kernels.imu_rk4_window.launches
    kernels.imu_rk4_window(*(o[0] for o in ops), 9.81, *SIGMAS)
    torch.func.vmap(lambda *a: kernels.imu_rk4_window(*a, 9.81, *SIGMAS))(
        *ops)
    assert kernels.imu_rk4_window.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rank", "short", "device"])
def test_rk4_window_rejects_bad_arguments(bad):
    x, mats, t, w, a = (torch.from_numpy(z[0]) for z in imu_window_inputs(1))
    if bad == "dtype":
        w = w.double()
    elif bad == "rank":
        x = x[None]
    elif bad == "short":  # one sample: no interval
        t, w, a = t[:1], w[:1], a[:1]
    else:
        mats = torch.empty(mats.shape, device="meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.imu_rk4_window(x, mats, t, w, a, 9.81, *SIGMAS)


@pytest.mark.parametrize("kw,fused", [
    (dict(integration="rk4"), True),
    (dict(integration="discrete"), False),
    (dict(integration="analytical"), False),
    (dict(integration="rk4", calib_imu_intrinsics=True), False),
    (dict(integration="rk4", calib_imu_g_sensitivity=True), False),
])
def test_propagate_routes_rk4_window(kw, fused, monkeypatch):
    """propagate calls imu_rk4_window for rk4 without online IMU-intrinsic
    calibration and only then; the others keep the loop."""
    from open_vins_tpu_torch.core import state as tstate
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import propagator

    cfg = FilterConfig(max_clones=11, max_slam=0, **kw)
    assert propagator.fused_rk4(cfg) == fused
    calls = []
    real = kernels.imu_rk4_window
    monkeypatch.setattr(kernels, "imu_rk4_window",
                        lambda *a: calls.append(1) or real(*a))
    _, _, t_, w, a = (torch.from_numpy(z[0]) for z in imu_window_inputs(1))
    st = tstate.init_state(cfg, "cpu")
    out = propagator.propagate(st, cfg, propagator.ImuWindow(t=t_, w=w, a=a),
                               float(t_[-1]))
    assert len(calls) == (1 if fused else 0)
    assert bool(torch.isfinite(out.cov).all())
