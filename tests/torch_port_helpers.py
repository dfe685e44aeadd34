"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
hand JAX pytrees to the port as numpy arrays and compare the results."""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from open_vins_tpu_torch import convert

CPU = "cpu"
STACK_ZERO_IMU = 15  # the IMU block: zero columns of every joint stack
FIXTURE = (Path(__file__).resolve().parents[1] / "open_vins_tpu_torch"
           / "data" / "msckf_sim20_seed0.npz")


@pytest.fixture
def one_torch_thread():
    """The test's torch CPU work on one thread: the suite runs several
    workers at once, and eager loops of small operations gain little from
    threads but lose much when the workers' threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_to_numpy(nt) -> dict:
    """A JAX NamedTuple of arrays as a dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def jax_state_to_port(st):
    return convert.state_from_numpy(tree_to_numpy(st), CPU)


def jax_table_to_port(tb):
    return convert.table_from_numpy(tree_to_numpy(tb), CPU)


def jax_frames_to_port(fr):
    """One JAX FrameInput (or a batch of them) as a port FrameInput."""
    arrays = {f"win_{k}": np.asarray(v) for k, v in fr.win._asdict().items()}
    arrays.update({k: np.asarray(getattr(fr, k))
                   for k in ("t_new", "ids", "uv", "uvn", "mask")})
    return convert.frames_from_numpy(arrays, CPU)


def t(a, dtype=torch.float32):
    """numpy/JAX array -> CPU torch tensor (float32 unless told)."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


STATE_VALUE_FIELDS = ("q", "p", "v", "bg", "ba", "clones_q", "clones_p",
                      "clones_q_fej", "clones_p_fej", "calib_ext_q",
                      "calib_ext_p", "calib_intr")
STATE_EXACT_FIELDS = ("clone_valid", "head", "n_clones", "clone_t")


def assert_state_close(port_st, jax_st, atol=1e-4, cov_rel=1e-5, where="",
                       cov_norm="max"):
    """Values within `atol`, bookkeeping exact, covariance within
    cov_rel·‖P‖ of the JAX covariance: ‖P‖ is max|P_ij| (`cov_norm="max"`)
    or the row-sum norm ‖P‖∞ (`cov_norm="inf"`)."""
    for k in STATE_VALUE_FIELDS:
        np.testing.assert_allclose(np_of(getattr(port_st, k)),
                                   np.asarray(getattr(jax_st, k)),
                                   atol=atol, rtol=0, err_msg=f"{where} {k}")
    for k in STATE_EXACT_FIELDS:
        np.testing.assert_array_equal(np_of(getattr(port_st, k)),
                                      np.asarray(getattr(jax_st, k)),
                                      err_msg=f"{where} {k}")
    cov_j = np.asarray(jax_st.cov)
    norm = {"max": np.abs(cov_j).max(), "inf": np.abs(cov_j).sum(1).max()}
    scale = max(norm[cov_norm], 1e-30)
    np.testing.assert_allclose(np_of(port_st.cov), cov_j,
                               atol=cov_rel * scale, rtol=0,
                               err_msg=f"{where} cov")


def assert_table_equal(port_tb, jax_tb, where=""):
    for k in ("ids", "mbits", "seen"):
        np.testing.assert_array_equal(np_of(getattr(port_tb, k)),
                                      np.asarray(getattr(jax_tb, k)),
                                      err_msg=f"{where} table.{k}")
    for k in ("uv", "uvn"):
        np.testing.assert_allclose(np_of(getattr(port_tb, k)),
                                   np.asarray(getattr(jax_tb, k)),
                                   atol=1e-5, rtol=0,
                                   err_msg=f"{where} table.{k}")


class Problem(NamedTuple):
    """A filter problem for both packages: the JAX start state and table,
    the JAX frames (batched over frames), and each package's filter
    configuration and triangulation options."""

    state: object
    table: object
    frames: object
    cfg_jax: object
    cfg_port: object
    tri_jax: object
    tri_port: object


def graft_problem(max_slam=0, integration="rk4", duration=1.0) -> Problem:
    """`__graft_entry__._build_problem()`: 5 clones, 12 points, a 10 Hz
    camera for `duration` s (9 frames at 1 s), <= 8 MSCKF features, two
    Gauss-Newton runs; max_slam=0 and rk4 unless told.  Staging it compiles
    the JAX simulator (about 30 s on a CPU)."""
    import __graft_entry__
    from open_vins_tpu.core.layout import FilterConfig as JCfg
    from open_vins_tpu.models import runner as jrun
    from open_vins_tpu.models import triangulation as jtri
    from open_vins_tpu.sim import simulator
    from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
    from open_vins_tpu_torch.models import triangulation as ttri

    _, (state, table, frame0) = __graft_entry__._build_problem(
        max_slam=max_slam, integration=integration, duration=duration)
    params = simulator.SimParams(imu_rate=100.0, cam_rate=10.0, num_cams=1,
                                 num_pts=12, map_size=128, duration=duration)
    run = jrun.stage_run(simulator.build(params, seed=0), params)
    np.testing.assert_array_equal(np.asarray(run.frames.uv[0]),
                                  np.asarray(frame0.uv))
    kw = dict(max_clones=5, max_slam=max_slam, num_cams=1,
              max_msckf_in_update=8, integration=integration)
    return Problem(state, table, run.frames, JCfg(**kw), TCfg(**kw),
                   jtri.TriangulationOptions(max_runs=2),
                   ttri.TriangulationOptions(max_runs=2))


def fixture_problem() -> Problem:
    """The staged reference-width run of FIXTURE from its groundtruth start
    (11 clones, 200 points, <= 40 MSCKF features, max_tracks 384)."""
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig as JCfg
    from open_vins_tpu.models import manager as jman
    from open_vins_tpu.models import triangulation as jtri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu.ops import lie as jlie
    from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
    from open_vins_tpu_torch.models import triangulation as ttri

    with np.load(FIXTURE) as npz:
        z = {k: npz[k] for k in npz.files}
    meta = json.loads(str(z["meta"]))
    jc = JCfg(**meta["cfg"])
    state = jman.initialize_from_gt(
        jc, jnp.asarray(z["gt_q"][0]), jnp.asarray(z["gt_p"][0]),
        jnp.asarray(z["gt_v"][0]), jnp.asarray(z["bias_g0"]),
        jnp.asarray(z["bias_a0"]), 0.0,
        jax.vmap(jlie.rot_2_quat)(jnp.asarray(z["cam_R_ItoC"])),
        jnp.asarray(z["cam_p_IinC"]), jnp.asarray(z["cam_intr"]))
    frames = jman.FrameInput(
        win=ImuWindow(t=z["win_t"], w=z["win_w"], a=z["win_a"]),
        t_new=z["t_new"], ids=z["ids"], uv=z["uv"], uvn=z["uvn"],
        mask=z["mask"])
    return Problem(state, jman.ft.init_table(jc, meta["max_tracks"]), frames,
                   jc, TCfg(**meta["cfg"]), jtri.TriangulationOptions(),
                   ttri.TriangulationOptions())


def slam_problem(rep="GLOBAL_3D") -> Problem:
    """A small SLAM configuration on the staged frames of FIXTURE (no
    simulator to compile): 5 clones, 4 landmark slots in representation
    `rep`, <= 8 MSCKF features, ACI², the joint "qr" update; landmarks
    enter from frame 5 on."""
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig as JCfg
    from open_vins_tpu.models import manager as jman
    from open_vins_tpu_torch.core.layout import FilterConfig as TCfg

    pb = fixture_problem()
    kw = dict(max_clones=5, max_slam=4, num_cams=1, max_msckf_in_update=8,
              integration="analytical", feat_rep_slam=rep)
    jc = JCfg(**kw)
    st = pb.state
    state = jman.initialize_from_gt(jc, st.q, st.p, st.v, st.bg, st.ba, 0.0,
                                    st.calib_ext_q, st.calib_ext_p,
                                    st.calib_intr)
    table = jman.ft.init_table(jc, pb.table.ids.shape[0])
    return pb._replace(state=state, table=table, cfg_jax=jc,
                       cfg_port=TCfg(**kw))


def downdate_inputs(D, m, same, seed=0):
    """(P, K, PHt) float32 numpy inputs of symmetric_downdate: P SPD,
    K = PHt when `same`."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) * 0.1
    P = (A @ A.T + np.eye(D)).astype(np.float32)
    K = (rng.normal(size=(D, m)) * 0.05).astype(np.float32)
    PHt = K if same else (rng.normal(size=(D, m)) * 0.05).astype(np.float32)
    return P, K, PHt


def oracle_blocks(B, n, g=3, seed=2):
    """tests/test_pallas_kernels.py's QR input: Gaussian [g, B, n] blocks
    with the last 7 rows and the last 5 columns zeroed."""
    A = np.random.default_rng(seed).normal(size=(g, B, n)).astype(np.float32)
    A[:, -7:, :] = 0.0
    A[:, :, -5:] = 0.0
    return A


def stack_blocks(m, n, seed=0):
    """A Gaussian [m, n] stack with the joint stack's zero columns (the IMU
    block and the IMU-intrinsic tail), zero-padded and cut into the row
    blocks of update_helper._tsqr_r (B = 2n rounded up to 32)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A[:, :STACK_ZERO_IMU] = 0.0
    A[:, n - 25:n - 1] = 0.0
    B = -(-2 * n // 32) * 32
    g = -(-m // B)
    A_p = np.zeros((g * B, n), np.float32)
    A_p[:m] = A
    return A_p.reshape(g, B, n)


def check_r_factors(R, A, atol=2e-3, rtol=2e-3):
    """RᵀR = AᵀA per block (in float64) and an exactly-zero strict lower
    triangle."""
    R = R.astype(np.float64)
    for i in range(A.shape[0]):
        Ai = A[i].astype(np.float64)
        np.testing.assert_allclose(R[i].T @ R[i], Ai.T @ Ai, atol=atol,
                                   rtol=rtol)
        assert (np.tril(R[i], -1) == 0.0).all()


def jax_sim_draws(params, seed):
    """The JAX simulator's own random draws for `params` and `seed` (the
    keys of `simulator.build`, `get_imu` and `get_cam`), as the port's
    `SimDraws` of unit draws."""
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.sim import simulator
    from open_vins_tpu_torch import convert

    key = jax.random.PRNGKey(seed)
    k_map, k_bg, k_ba, k_w, k_a, k_pix = jax.random.split(key, 6)
    k1, k2, k3, k4 = jax.random.split(k_map, 4)
    M, C, P = params.map_size, params.num_cams, params.num_pts
    steps = jnp.arange(simulator.n_imu_steps(params) + 1)
    n = steps.shape[0]

    def per_step(k):
        return jax.vmap(lambda s: jax.random.normal(
            jax.random.fold_in(k, s), (3,)))(steps)

    def per_frame(f):
        kf = jax.random.fold_in(k_pix, f)
        return jax.vmap(lambda c: jax.random.normal(
            jax.random.fold_in(kf, c), (P, 2)))(jnp.arange(C))

    arrays = dict(
        map_t=jax.random.uniform(k1, (M,)),
        map_cam=jax.random.randint(k2, (M,), 0, C),
        map_uv=jax.random.uniform(k3, (M, 2)),
        map_depth=jax.random.uniform(k4, (M,)),
        bias_g_inc=jax.random.normal(k_bg, (n, 3)),
        bias_a_inc=jax.random.normal(k_ba, (n, 3)),
        imu_w=per_step(k_w), imu_a=per_step(k_a),
        pix=jax.vmap(per_frame)(jnp.arange(simulator.n_cam_frames(params))))
    return convert.sim_draws_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()})


def jax_calib_draws(num_cams, seed):
    """`simulator.perturb_calib`'s JAX draws as the port's `CalibDraws`."""
    import jax

    from open_vins_tpu_torch import convert

    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    N = num_cams
    arrays = dict(
        dt=jax.random.normal(ks[0], ()), intr=jax.random.normal(ks[1], (N, 8)),
        rot=jax.random.normal(ks[2], (N, 3)),
        pos=jax.random.normal(ks[3], (N, 3)),
        imu_dw=jax.random.normal(ks[4], (6,)),
        imu_da=jax.random.normal(ks[5], (6,)),
        gyro_rot=jax.random.normal(ks[6], (3,)),
        acc_rot=jax.random.normal(jax.random.fold_in(ks[6], 1), (3,)),
        imu_tg=jax.random.normal(ks[7], (9,)))
    return convert.calib_draws_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()})


def ensemble_problem(max_slam=0, integration="rk4", seeds=(0, 1, 2),
                     **cfg_kw) -> Problem:
    """B = len(seeds) streams of `graft_problem`'s sizes (5 clones, 12
    points, a 10 Hz camera for 1 s, <= 8 MSCKF features, two Gauss-Newton
    runs), with `slam_problem`'s landmarks when max_slam > 0 (GLOBAL_3D,
    the joint "qr" update; pass integration="analytical" for its ACI²), one
    seed each; `cfg_kw` sets further fields of the filter configuration.  The port's simulator stages the streams on the CPU (no JAX
    simulator to compile) and each starts from its groundtruth; the
    Problem's state, table and frames are the JAX package's records of the
    streams stacked on a leading axis ([B, frames, ...] for the frames)."""
    import jax.numpy as jnp
    from open_vins_tpu.core.layout import FilterConfig as JCfg
    from open_vins_tpu.core.state import VioState as JState
    from open_vins_tpu.models import feature_table as jft
    from open_vins_tpu.models import manager as jman
    from open_vins_tpu.models import triangulation as jtri
    from open_vins_tpu.models.propagator import ImuWindow as JWin
    from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
    from open_vins_tpu_torch.models import runner as trun
    from open_vins_tpu_torch.models import triangulation as ttri
    from open_vins_tpu_torch.sim import simulator

    params = simulator.SimParams(imu_rate=100.0, cam_rate=10.0, num_cams=1,
                                 num_pts=12, map_size=128, duration=1.0)
    kw = dict(max_clones=5, max_slam=max_slam, num_cams=1,
              max_msckf_in_update=8, integration=integration, **cfg_kw)
    tc = TCfg(**kw)
    calibs, runs = trun.stage_ensemble(params, seeds, CPU)
    state, table = trun.ensemble_start(tc, calibs, runs, 64)

    def to_jax(cls, record):
        return cls(**{k: jnp.asarray(np_of(v)) for k, v in record.items()})

    a = convert.run_to_numpy(runs)
    frames = jman.FrameInput(
        win=JWin(t=a["win_t"], w=a["win_w"], a=a["win_a"]),
        t_new=a["t_new"], ids=a["ids"], uv=a["uv"], uvn=a["uvn"],
        mask=a["mask"])
    return Problem(to_jax(JState, state), to_jax(jft.FeatureTable, table),
                   frames, JCfg(**kw), tc,
                   jtri.TriangulationOptions(max_runs=2),
                   ttri.TriangulationOptions(max_runs=2))


def jax_pre_update(pb, st, tb, k):
    """Steps 1-4 of JAX's step_frame for frame k (marginalize, propagate
    and clone, ingest; the promotions are reserved inside delayed_init)."""
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core import ekf as jekf
    from open_vins_tpu.core import state as jstate
    from open_vins_tpu.models import manager as jman
    from open_vins_tpu.models import updater_slam as jslam

    jc = pb.cfg_jax
    frame = jax.tree_util.tree_map(lambda a: jnp.asarray(a[k]), pb.frames)
    full = st.n_clones >= jc.max_clones
    slot_old = jstate.oldest_slot(st, jc)
    st_m = jekf.marginalize_clone(jslam.change_anchors(st, jc, slot_old), jc,
                                  slot_old)
    st = jax.tree_util.tree_map(lambda a, b: jnp.where(full, a, b), st_m, st)
    tb = jax.tree_util.tree_map(
        lambda a, b: jnp.where(full, a, b),
        jman.ft.clear_clone_column(tb, slot_old), tb)
    st = jman.propagate(st, jc, frame.win, frame.t_new)
    st = jekf.augment_clone(st, jc, frame.win.w[-1] - st.bg)
    tb = jman.ft.ingest_frame(tb, jc, st.head, frame.ids, frame.uv,
                              frame.uvn, frame.mask)
    return st, tb
