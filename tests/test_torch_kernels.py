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
from torch_port_helpers import (LINEARIZE_CASES, downdate_inputs,
                                imu_window_inputs, linearize_inputs, np_of)

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



# ---------------------------------------------------------------------------
# msckf_linearize: on CPU tensors the wrapper is its plain version,
# `msckf_linearize_ref` (the composition msckf_build ran before the stage had
# a kernel, which the JAX parity tests hold), bit for bit and with no launch.
# The CUDA kernel against the plain version is in tests/test_torch_cuda.py.


def _assert_same(got, want, rtol=0.0, atol=0.0):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True)


@pytest.mark.parametrize("layout,kw", LINEARIZE_CASES)
def test_msckf_linearize_plain_version_is_the_three_calls(layout, kw):
    """msckf_linearize on CPU tensors is msckf_linearize_ref, bit for bit,
    and counts no launch, on both cells' layouts, with online calibration,
    two cameras (m = 41, chi2_statistic's solve), the equidistant model and
    FEJ off; the inputs hold masked and depth-gated observations and the
    point that msckf_build puts in place of a non-finite triangulation."""
    cfg, st, gobs, p_f = linearize_inputs(layout, **kw)
    want = kernels.msckf_linearize_ref(st, cfg, gobs, p_f)
    before = kernels.msckf_linearize.launches
    _assert_same(kernels.msckf_linearize(st, cfg, gobs, p_f), want)
    assert kernels.msckf_linearize.launches == before
    H, res, n_rows, gamma = want
    O = cfg.max_clones * cfg.num_cams
    assert H.shape == (8, 2 * O - 3, cfg.state_dim)
    assert int(n_rows[0]) == 2 * O and int(n_rows[1]) < int(n_rows[2])
    assert (n_rows[3:] < 2 * O).any()  # masked observations
    assert bool(torch.isfinite(gamma).all())


def test_msckf_linearize_vmap_matches_loop():
    """Under torch.func.vmap (the ensemble's step) the CPU call gives the
    per-stream loop's results, to float32 rounding (the batched products
    may sum in another order)."""
    cfg, st, gobs, p_f = linearize_inputs("msckf", streams=3)
    got = torch.func.vmap(
        lambda s, g, p: kernels.msckf_linearize(s, cfg, g, p))(st, gobs, p_f)
    for b in range(3):
        one = kernels.msckf_linearize(
            type(st)(**{k: v[b] for k, v in st.items()}), cfg,
            type(gobs)(**{k: v[b] for k, v in gobs.items()}), p_f[b])
        _assert_same([o[b] for o in got], one, rtol=1e-5, atol=1e-4)


def test_msckf_linearize_cpu_call_counts_no_launch():
    cfg, st, gobs, p_f = linearize_inputs("msckf", streams=2)
    before = kernels.msckf_linearize.launches
    torch.func.vmap(lambda s, g, p: kernels.msckf_linearize(s, cfg, g, p))(
        st, gobs, p_f)
    kernels.msckf_linearize(type(st)(**{k: v[0] for k, v in st.items()}),
                            cfg, type(gobs)(**{k: v[0] for k, v in
                                               gobs.items()}), p_f[0])
    assert kernels.msckf_linearize.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mask", "rank", "shape", "layout",
                                 "device"])
def test_msckf_linearize_rejects_bad_arguments(bad):
    cfg, st, gobs, p_f = linearize_inputs("msckf")
    if bad == "dtype":
        p_f = p_f.double()
    elif bad == "mask":
        gobs = gobs.replace(mask=gobs.mask.to(torch.uint8))
    elif bad == "rank":
        gobs = gobs.replace(uv=gobs.uv[None])
    elif bad == "shape":
        st = st.replace(cov=st.cov[:-1, :-1].contiguous())
    elif bad == "layout":  # observations not C x N
        gobs = gobs.replace(**{k: v[:, :-1] for k, v in gobs.items()})
    else:
        p_f = torch.empty(p_f.shape, device="meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.msckf_linearize(st, cfg, gobs, p_f)


def test_msckf_build_routes_msckf_linearize(monkeypatch):
    """msckf_build calls msckf_linearize once a call; the landmark rows
    (`updater_slam.build_update`) and delayed init keep their plain
    functions.  Two streams of `sim_slam` cut to 5 clones and 4 landmark
    slots, stepped through promotion and delayed init."""
    import json
    from pathlib import Path

    from open_vins_tpu_torch.models import manager
    from open_vins_tpu_torch.models import updater_slam as slam
    from vio_bench import gen
    from vio_bench.program import Program

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "vio_bench/configs/sim_slam.json").read_text())
    config["filter"].update(max_clones=5, max_slam=4)
    config["sim"]["duration"] = 0.5
    calls = []
    real = kernels.msckf_linearize
    monkeypatch.setattr(kernels, "msckf_linearize",
                        lambda *a: calls.append(1) or real(*a))
    seen = {"msckf_build": [], "build_update": [], "delayed_init": []}

    def counted(name, fn):
        def wrapped(*args, **kw):
            before = len(calls)
            out = fn(*args, **kw)
            seen[name].append(len(calls) - before)
            return out
        return wrapped

    monkeypatch.setattr(manager, "msckf_build",
                        counted("msckf_build", manager.msckf_build))
    monkeypatch.setattr(slam, "build_update",
                        counted("build_update", slam.build_update))
    monkeypatch.setattr(slam, "delayed_init",
                        counted("delayed_init", slam.delayed_init))
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), 2,
                               2 ** 31 + 3, "cpu")
    prog = Program(config)
    calibs, runs = prog.records(streams)
    state, table = prog.start(calibs, runs)
    used = 0
    for k in range(streams.n_frames):
        state, table, diag = prog.step(state, table, runs, k)
        used += int(diag.n_msckf.sum())
    assert seen["msckf_build"] == [1] * streams.n_frames
    assert seen["build_update"] == [0] * streams.n_frames
    assert seen["delayed_init"] == [0] * streams.n_frames
    assert used > 0 and int(diag.n_slam.sum()) > 0
