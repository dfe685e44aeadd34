"""The port's seed ensemble (bench.py:221-282) against the JAX package.

`runner.run_ensemble` steps B streams as one batched step:
`manager.step_frame` under `torch.func.vmap` with `batched=True`.  Here
B = 3 streams of seeds 0-2 at the graft problem's size
(`torch_port_helpers.ensemble_problem`: 5 clones, 12 points, a 10 Hz
camera for 1 s), once MSCKF-only (rk4) and once with SLAM (4 landmark
slots in GLOBAL_3D, ACI², the joint "qr" update), over all 9 frames, from
the same (JAX) state at every frame:

(a) the batched step against each stream's own port step: counts,
    bookkeeping and the table exactly, values within 1e-6·max(1, |x|) and
    the covariance within 1e-6·‖P‖∞.  The code is the same; only the
    batched products sum in another order.  Landmarks are the exception:
    a new landmark's position and covariance go through the 3×3 factor of
    its triangulation (condition about 1e3, see tests/test_torch_slam.py),
    so landmark positions, and every value in a step that initializes a
    landmark, are held to 1e-5·max(1, |x|), and the rows and columns of a
    landmark initialized in the step to 1e-4 of their block's max|P_ij|.
    The largest gaps seen: values 1.0e-6 in init steps and 5.0e-7 in
    others, landmark positions 2.0e-6, covariance 2.2e-7·‖P‖∞,
    new-landmark blocks 4.9e-6;
(b) the batched step with SLAM (the ensemble's configuration) against
    `jax.jit(jax.vmap(jman.step_frame))` on the same batched inputs, at the
    repo's SLAM step tolerances (tests/test_torch_slam.py: 5e-5·‖P‖∞).
    The MSCKF-only step is held to JAX by tests/test_torch_step.py and to
    itself batched by (a); a second vmapped JAX compile (15 s) would not
    fit this file's time;
(c) delayed init in a batch where one stream has work and one has none:
    each stream gets what its single-stream call gives;
(d) the vmap rules of both custom ops, for every in-dims combination,
    against a loop of single calls;
(e) no operation of the batched step falls back to vmap's per-example loop
    (its performance warning, which is off by default, is turned on and
    collected).

`stage_ensemble`, `run_ensemble` and `ensemble_metrics` are checked
against per-stream staging and `run_filter`.  The CPU rehearsal of the
whole 8 × 399 ensemble against the committed JAX reference
(`open_vins_tpu_torch/data/ensemble8_sim20_ref.npz`) is marked slow.
"""

import contextlib
import itertools
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from open_vins_tpu.models import manager as jman
from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.core.state import init_state as tstate_init
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.models import runner as trun
from open_vins_tpu_torch.models import triangulation as ttri
from open_vins_tpu_torch.models import updater_slam as tslam
from open_vins_tpu_torch.ops import kernels
from open_vins_tpu_torch.sim import simulator
from test_torch_fixture import ENSEMBLE_REF
from test_torch_slam import SLAM_EXACT_FIELDS, assert_slam_state_close
from torch_port_helpers import (STATE_EXACT_FIELDS, STATE_VALUE_FIELDS,
                                assert_table_equal,
                                downdate_inputs, ensemble_problem,
                                jax_frames_to_port, jax_state_to_port,
                                jax_table_to_port, np_of, oracle_blocks)

B = 3
N_FRAMES = 9
CONFIGS = {"msckf": (0, "rk4"), "slam": (4, "analytical")}
DIAG_FIELDS = ("n_msckf", "n_tracks", "n_slam", "n_slam_used")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The problems are tiny: CPU threads only add overhead, the more so
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def vmap_fallbacks():
    """Collect, into the yielded list, the messages of vmap's per-example
    fallback (an operation without a batching rule) raised in the block."""
    found = []
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield found
        found.extend(str(w.message) for w in caught
                     if "batching rule" in str(w.message))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def at(record, b):
    """Stream b of a port record or of a JAX pytree."""
    if isinstance(record, tuple) and not hasattr(record, "_fields"):
        return tuple(at(r, b) for r in record)
    if hasattr(record, "_fields"):
        return jax.tree_util.tree_map(lambda a: a[b], record)
    return trun.record_at(record, b)


@pytest.fixture(scope="module", params=list(CONFIGS))
def port_steps(request):
    """The problem stepped by the port's batched step over all frames.
    Returns (name, problem, [(k, pre state, pre table, frame, post)], vmap
    fallback messages of the steps)."""
    pb = ensemble_problem(*CONFIGS[request.param])
    step = trun.ensemble_step(pb.cfg_port, pb.tri_port)
    frames = jax_frames_to_port(pb.frames)
    state, table = jax_state_to_port(pb.state), jax_table_to_port(pb.table)
    cases = []
    with vmap_fallbacks() as fallbacks:
        for k in range(N_FRAMES):
            frame = pytree.tree_map(lambda a: a[:, k], frames)
            post = step(state, table, frame)
            cases.append((k, state, table, frame, post))
            state, table = post[0], post[1]
    return request.param, pb, cases, fallbacks


@pytest.fixture(scope="module")
def jax_steps():
    """The SLAM problem stepped by JAX's vmapped step over all frames; at
    each frame k the port's batched step from the same state.  Returns
    (problem, [(k, JAX pre state, JAX post, port post)])."""
    pb = ensemble_problem(*CONFIGS["slam"])
    jstep = jax.jit(jax.vmap(lambda s, tb, f: jman.step_frame(
        s, tb, pb.cfg_jax, pb.tri_jax, f)))
    tstep = trun.ensemble_step(pb.cfg_port, pb.tri_port)
    frames_t = jax_frames_to_port(pb.frames)
    state, table = pb.state, pb.table
    cases = []
    for k in range(N_FRAMES):
        post_j = jstep(state, table, jax.tree_util.tree_map(
            lambda a: a[:, k], pb.frames))
        post_t = tstep(jax_state_to_port(state), jax_table_to_port(table),
                       pytree.tree_map(lambda a: a[:, k], frames_t))
        cases.append((k, state, post_j, post_t))
        state, table = post_j[0], post_j[1]
    return pb, cases


def _new_landmark_cols(cfg, pre, post):
    """[D] bool: the covariance columns of landmarks initialized in a
    step."""
    new = np_of(post.slam_valid) & ~np_of(pre.slam_valid)
    cols = np.zeros(cfg.state_dim, bool)
    for slot in np.flatnonzero(new):
        cols[cfg.slam_off + 3 * slot:cfg.slam_off + 3 * slot + 3] = True
    return cols


def assert_same_stream(got, want, pre, cfg, where, scale=1.0):
    """(a)'s tolerances: `got` and `want` are (state, table, diag) of one
    stream, `pre` the state the step started from."""
    for k in DIAG_FIELDS:
        assert int(getattr(got[2], k)) == int(getattr(want[2], k)), \
            f"{where} {k}"
    assert_same_state(got[:2], want[:2], pre, cfg, where, scale)


def assert_same_state(got, want, pre, cfg, where, scale=1.0):
    """(a)'s tolerances on (state, table) of one stream, the value and
    covariance tolerances times `scale`."""
    st_g, tb_g = got
    st_w, tb_w = want
    for k in STATE_EXACT_FIELDS + SLAM_EXACT_FIELDS:
        assert torch.equal(getattr(st_g, k), getattr(st_w, k)), \
            f"{where} {k}"
    for k in ("ids", "mbits", "seen"):
        assert torch.equal(getattr(tb_g, k), getattr(tb_w, k)), \
            f"{where} table.{k}"
    for k in ("uv", "uvn"):
        gap = (getattr(tb_g, k) - getattr(tb_w, k)).abs().max()
        assert gap <= 1e-6, f"{where} table.{k} {gap}"
    cols = torch.as_tensor(_new_landmark_cols(cfg, pre, st_w))
    tol = (1e-5 if cols.any() else 1e-6) * scale
    for k, tol in ([(k, tol) for k in STATE_VALUE_FIELDS]
                   + [("slam_p", 1e-5 * scale)]):
        a, w = getattr(st_g, k), getattr(st_w, k)
        if w.numel():  # no landmark slots without SLAM
            gap = ((a - w).abs() / w.abs().clamp(min=1.0)).max()
            assert gap <= tol, f"{where} {k} {gap:.2e}"
    blk = cols[:, None] | cols[None, :]
    gap = (st_g.cov - st_w.cov).abs()
    norm_inf = st_w.cov.abs().sum(1).max()
    assert gap[~blk].max() <= 1e-6 * scale * norm_inf, \
        f"{where} cov gap {gap[~blk].max() / norm_inf:.2e}·‖P‖∞"
    if cols.any():
        blk_max = st_w.cov[cols][:, cols].abs().max()
        assert gap[blk].max() <= 1e-4 * scale * blk_max, \
            f"{where} new-landmark cov gap {gap[blk].max() / blk_max:.2e}"


def test_batched_step_matches_single_streams(port_steps):
    """(a) every frame, every stream."""
    name, pb, cases, _ = port_steps
    for k, st, tb, fr, post in cases:
        for b in range(B):
            one = tman.step_frame(at(st, b), at(tb, b), pb.cfg_port,
                                  pb.tri_port, at(fr, b))
            assert_same_stream(at(post, b), one, at(st, b), pb.cfg_port,
                               f"{name} frame {k} stream {b}")
    diags = [c[-1][2] for c in cases]
    if name == "slam":
        assert int(diags[-1].n_slam.min()) > 0, "SLAM never engaged"
    assert sum(int(d.n_msckf.sum()) for d in diags) > 0, "no MSCKF update"


def test_batched_step_has_no_vmap_fallback(port_steps):
    """(e) no per-example loop anywhere in the batched step."""
    _, _, _, fallbacks = port_steps
    assert fallbacks == []


def test_batched_step_matches_jax_vmap(jax_steps):
    """(b) every frame, every stream."""
    pb, cases = jax_steps
    for k, pre_j, post_j, post_t in cases:
        for b in range(B):
            where = f"frame {k} stream {b}"
            st_t, tb_t, d_t = at(post_t, b)
            st_j, tb_j, d_j = at(post_j, b)
            for f in DIAG_FIELDS:
                assert int(getattr(d_t, f)) == int(getattr(d_j, f)), \
                    f"{where} {f}"
            assert_slam_state_close(st_t, st_j, at(pre_j, b), pb.cfg_jax,
                                    where)
            assert_table_equal(tb_t, tb_j, where=where)
    assert int(cases[-1][2][2].n_slam.min()) > 0, "SLAM never engaged"


def test_delayed_init_mixed_batch():
    """(c) one stream with delayed-init work, one without: the batched
    call's per-stream select gives each what its own call gives."""
    pb = ensemble_problem(*CONFIGS["slam"])
    cfg, opts = pb.cfg_port, pb.tri_port
    frames = jax_frames_to_port(pb.frames)
    states, tables = jax_state_to_port(pb.state), jax_table_to_port(pb.table)

    def init(st, tb, batched=False):
        return tslam.delayed_init(st, cfg, tb, opts, tman.gather_feature_obs,
                                  batched=batched)

    # stream 0 stepped until delayed init has work; stream 1 at frame 0,
    # before the window is full, has no candidates
    st, tb = at(states, 0), at(tables, 0)
    for k in range(N_FRAMES):
        work = tman.pre_update(st, tb, cfg, at(at(frames, 0), k))[:2]
        if int(init(*work)[2]) > 0:
            break
        st, tb, _ = tman.step_frame(st, tb, cfg, opts, at(at(frames, 0), k))
    none = tman.pre_update(at(states, 1), at(tables, 1), cfg,
                           at(at(frames, 1), 0))[:2]
    singles = [init(*work), init(*none)]
    assert int(singles[0][2]) > 0 and int(singles[1][2]) == 0
    with vmap_fallbacks() as fallbacks:
        batched = torch.func.vmap(lambda s, t: init(s, t, batched=True))(
            trun.stack_records([work[0], none[0]]),
            trun.stack_records([work[1], none[1]]))
    assert fallbacks == []
    # no work: exactly the single call's "nothing"
    for a, w in zip(pytree.tree_leaves(at(batched, 1)),
                    pytree.tree_leaves(singles[1])):
        assert torch.equal(a, w)
    # work: the single call's result up to the order of batched sums
    got, want = at(batched, 0), singles[0]
    assert int(got[2]) == int(want[2])
    assert_same_state(got[:2], want[:2], work[0], cfg, "delayed init")
    for a, w in zip(got[3:], want[3:]):
        assert (a - w).abs().max() <= 1e-6 * w.abs().max().clamp(min=1.0)


def _stack(xs, dim):
    """Per-stream tensors stacked along `dim`, or stream 0's (unbatched)."""
    return xs[0] if dim is None else torch.stack(xs, dim=dim).contiguous()


DIMS3 = [d for d in itertools.product((0, 1, None), repeat=3)
         if d != (None, None, None)]


@pytest.mark.parametrize("dims", DIMS3, ids=str)
def test_downdate_vmap_rule(dims):
    """(d) symmetric_downdate under vmap, every in-dims combination of
    (P, K, PHt), against single calls: 1e-6·max(1, ‖P‖∞), exactly
    symmetric, no launch on the CPU."""
    ins = [downdate_inputs(20, 7, False, seed=b) for b in range(B)]
    P, K, PHt = (_stack([torch.from_numpy(x[i]) for x in ins], d)
                 for i, d in enumerate(dims))
    before = kernels.symmetric_downdate.launches
    out = torch.func.vmap(kernels.symmetric_downdate, in_dims=dims)(P, K, PHt)
    assert kernels.symmetric_downdate.launches == before

    def single(x, d, b):
        return x if d is None else x.select(d, b)

    for b in range(B):
        want = kernels.symmetric_downdate(
            *(single(x, d, b).contiguous() for x, d in zip((P, K, PHt),
                                                            dims)))
        tol = 1e-6 * max(1.0, want.abs().sum(1).max().item())
        assert (out[b] - want).abs().max() <= tol
        assert torch.equal(out[b], out[b].T)


@pytest.mark.parametrize("dims", [(0, 0), (None, 0), (0, 1), (1, None)],
                         ids=str)
def test_downdate_vmap_rule_one_operand(dims, monkeypatch):
    """(d) K passed as PHt under vmap (the EKF update's call) is seen as
    one operand on the unwrapped tensors, and matches single calls."""
    ins = [downdate_inputs(20, 7, True, seed=b) for b in range(B)]
    P, K = (_stack([torch.from_numpy(x[i]) for x in ins], d)
            for i, d in enumerate(dims))
    seen = []
    same_operand = kernels.same_operand
    monkeypatch.setattr(kernels, "same_operand",
                        lambda a, c: seen.append(same_operand(a, c))
                        or seen[-1])
    out = torch.func.vmap(lambda p, k: kernels.symmetric_downdate(p, k, k),
                          in_dims=dims)(P, K)
    assert seen == [True]
    for b in range(B):
        p = P if dims[0] is None else P.select(dims[0], b).contiguous()
        k = K if dims[1] is None else K.select(dims[1], b).contiguous()
        want = kernels.symmetric_downdate_ref(p, k, k)
        assert (out[b] - want).abs().max() <= 1e-6 * max(
            1.0, want.abs().sum(1).max().item())


@pytest.mark.parametrize("dim", [0, 1, 3])
def test_qr_vmap_rule(dim):
    """(d) householder_qr_blocks under vmap folds the streams into its
    block axis: equal to single calls, no launch on the CPU."""
    blocks = [torch.from_numpy(oracle_blocks(40, 15, g=2, seed=b))
              for b in range(B)]
    A = _stack(blocks, dim)
    before = kernels.householder_qr_blocks.launches
    R = torch.func.vmap(kernels.householder_qr_blocks, in_dims=dim)(A)
    assert kernels.householder_qr_blocks.launches == before
    assert R.shape == (B, 2, 15, 15)
    for b in range(B):
        want = kernels.householder_qr_blocks(blocks[b])
        assert (R[b] - want).abs().max() <= 1e-6 * want.abs().max()


GRAFT_PARAMS = simulator.SimParams(imu_rate=100.0, cam_rate=10.0, num_cams=1,
                                   num_pts=12, map_size=128, duration=1.0)


def test_stage_ensemble_stacks_streams():
    """`stage_ensemble` stacks the streams `convert.stage_stream` stages
    one by one (the same draws, bit for bit)."""
    calibs, runs = trun.stage_ensemble(GRAFT_PARAMS, [0, 5], "cpu")
    assert runs.frames.uv.shape[:2] == (2, 9) and calibs.cam_intr.shape[0] == 2
    for b, seed in enumerate([0, 5]):
        sim, _, run = convert.stage_stream(
            {"sim": GRAFT_PARAMS._asdict(), "seed": seed}, "cpu")
        for got, want in zip(pytree.tree_leaves(at(runs, b)),
                             pytree.tree_leaves(run)):
            assert torch.equal(got, want)
        for got, want in zip(pytree.tree_leaves(at(calibs, b)),
                             pytree.tree_leaves(trun.sim_calib(sim))):
            assert torch.equal(got, want)
    dig = convert.ensemble_digest(runs)
    assert dig["gt_p"].shape == (2, 10, 3) and dig["ids"].shape[0] == 2


def test_run_ensemble_matches_run_filter():
    """`run_ensemble` against `run_filter` per stream over the 9 frames of
    the SLAM problem: positions within 1e-4 m (per-step gaps of 1e-6
    compound over the loop), counts exact, outputs [B, frames, ...];
    `ensemble_metrics` against `pose_metrics` per stream."""
    cfg = TCfg(max_clones=5, max_slam=4, num_cams=1, max_msckf_in_update=8,
               integration="analytical")
    opts = ttri.TriangulationOptions(max_runs=2)
    calibs, runs = trun.stage_ensemble(GRAFT_PARAMS, range(B), "cpu")
    with vmap_fallbacks() as fallbacks:
        state, outs = trun.run_ensemble(cfg, opts, calibs, runs,
                                        max_tracks=64, device="cpu")
    assert fallbacks == []
    qs, ps, vs, covs6, diag = outs
    assert ps.shape == (B, 9, 3) and covs6.shape == (B, 9, 6, 6)
    assert diag.n_slam.shape == (B, 9) and state.cov.shape[0] == B
    assert int(diag.n_slam[:, -1].min()) > 0
    metrics = trun.ensemble_metrics(outs, runs)
    for b in range(B):
        st_b, outs_b = trun.run_filter(cfg, opts, at(calibs, b), at(runs, b),
                                       max_tracks=64, device="cpu")
        assert (ps[b] - outs_b[1]).abs().max() <= 1e-4
        for f in DIAG_FIELDS:
            assert torch.equal(getattr(diag, f)[b], getattr(outs_b[4], f))
        rmse, nees = trun.pose_metrics(outs_b[0], outs_b[1], outs_b[3],
                                       runs.gt_q[b], runs.gt_p[b])
        assert abs(metrics["rmse"][b] - rmse) <= 1e-4
        assert abs(metrics["nees"][b] - nees) <= 1e-2 * nees
    assert metrics["nees_seed_mean"] == pytest.approx(metrics["nees"].mean())


@pytest.mark.slow
def test_ensemble8_rehearsal():
    """The whole ensemble on the CPU against the committed JAX reference,
    with chip_smoke.py's gates: each stream's staging digest (ids and masks
    exact, floats to 1e-5), every covariance finite, median RMSE < 0.05 m,
    each stream within 0.01 m RMSE of its JAX run, seed-mean NEES in
    0.2-30 and within 25 % of JAX's.  Several minutes."""
    ref = convert.load_reference(ENSEMBLE_REF)
    meta = ref["meta"]
    calibs, runs = trun.stage_ensemble(simulator.SimParams(**meta["sim"]),
                                       meta["seeds"], "cpu")
    for k, v in convert.ensemble_digest(runs).items():
        want = ref[f"digest_{k}"]
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, rtol=0, atol=1e-5, err_msg=k)
    state, outs = trun.run_ensemble(TCfg(**meta["cfg"]),
                                    ttri.TriangulationOptions(), calibs, runs,
                                    max_tracks=meta["max_tracks"],
                                    device="cpu")
    m = trun.ensemble_metrics(outs, runs)
    assert bool(torch.isfinite(state.cov).all())
    assert m["rmse_median"] < 0.05
    assert np.abs(m["rmse"] - ref["ref_rmse"]).max() <= 0.01, m["rmse"]
    assert 0.2 < m["nees_seed_mean"] < 30.0
    jax_mean = float(ref["ref_nees_seed_mean"])
    assert abs(m["nees_seed_mean"] - jax_mean) <= 0.25 * jax_mean


def test_run_ensemble_anchored_matches_run_filter():
    """`run_ensemble` in ANCHORED_MSCKF_INVERSE_DEPTH past the first
    marginalizations, where `change_anchors` moves landmarks off the dying
    clone (its covariance rows are built from per-stream clone slots): each
    stream within 1e-4 m of its own `run_filter`, counts and anchors exact,
    no vmap fallback."""
    cfg = TCfg(max_clones=5, max_slam=4, num_cams=1, max_msckf_in_update=8,
               integration="analytical",
               feat_rep_slam="ANCHORED_MSCKF_INVERSE_DEPTH")
    opts = ttri.TriangulationOptions(max_runs=2)
    calibs, runs = trun.stage_ensemble(GRAFT_PARAMS, range(B), "cpu")
    with vmap_fallbacks() as fallbacks:
        state, outs = trun.run_ensemble(cfg, opts, calibs, runs,
                                        max_tracks=64, device="cpu")
    assert fallbacks == []
    diag = outs[4]
    assert int(diag.n_slam[:, -1].min()) > 0
    moved = 0
    for b in range(B):
        st_b, outs_b = trun.run_filter(cfg, opts, at(calibs, b), at(runs, b),
                                       max_tracks=64, device="cpu")
        assert (outs[1][b] - outs_b[1]).abs().max() <= 1e-4
        for f in DIAG_FIELDS:
            assert torch.equal(getattr(diag, f)[b], getattr(outs_b[4], f))
        assert torch.equal(state.slam_anchor_slot[b], st_b.slam_anchor_slot)
        live = st_b.slam_valid
        # landmarks now anchored on a clone newer than the one they were
        # initialized on were moved by change_anchors
        moved += int((live & (st_b.slam_anchor_slot != 3)).sum())
    assert moved > 0, "no landmark was re-anchored"


@pytest.mark.parametrize("timeoffset", [False, True])
def test_augment_clone_vmap_matches_single(timeoffset):
    """`ekf.augment_clone` under vmap (with the camera time offset, its dt
    column [ω̂; v] is batched) against one call per stream."""
    from open_vins_tpu_torch.core import ekf as tekf

    cfg = TCfg(max_clones=5, max_slam=2, num_cams=1,
               calib_cam_timeoffset=timeoffset)
    rng = np.random.default_rng(4)
    D = cfg.state_dim
    states = []
    for _ in range(B):
        A = rng.normal(size=(D, D)) * 0.1
        st = tstate_init(cfg, "cpu").replace(
            v=torch.as_tensor(rng.normal(size=3), dtype=torch.float32),
            calib_dt=torch.tensor(0.01),
            cov=torch.as_tensor(A @ A.T + 0.01 * np.eye(D),
                                dtype=torch.float32))
        states.append(st)
    w = torch.as_tensor(rng.normal(size=(B, 3)), dtype=torch.float32)
    with vmap_fallbacks() as fallbacks:
        got = torch.func.vmap(lambda s, w: tekf.augment_clone(s, cfg, w))(
            trun.stack_records(states), w)
    assert fallbacks == []
    for b in range(B):
        want = tekf.augment_clone(states[b], cfg, w[b])
        for (k, a), (_, e) in zip(at(got, b).items(), want.items()):
            assert (a.float() - e.float()).abs().max() <= 1e-6, k


def test_batched_step_timeoffset_matches_single_streams():
    """The batched step with the camera time offset estimated
    (`augment_clone`'s dt column [ω̂; v] is per stream) against each
    stream's own step from the same state, over the SLAM problem's 9
    frames, at (a)'s tolerances; no vmap fallback."""
    pb = ensemble_problem(4, "analytical", calib_cam_timeoffset=True)
    cfg = pb.cfg_port
    step = trun.ensemble_step(cfg, pb.tri_port)
    frames = jax_frames_to_port(pb.frames)
    state, table = jax_state_to_port(pb.state), jax_table_to_port(pb.table)
    for k in range(N_FRAMES):
        frame = pytree.tree_map(lambda a: a[:, k], frames)
        with vmap_fallbacks() as fallbacks:
            post = step(state, table, frame)
        assert fallbacks == []
        for b in range(B):
            one = tman.step_frame(at(state, b), at(table, b), cfg,
                                  pb.tri_port, at(frame, b))
            assert_same_stream(at(post, b), one, at(state, b), cfg,
                               f"frame {k} stream {b}")
        state, table = post[0], post[1]
