"""The joint "qr" update's exact reduction (`update_helper.
reduce_joint_system`) and OpenVINS's SLAM deployment
(`vio_bench/configs/sim_slam.json`) on the port's batched path, on the CPU:

(a) the reduction alone: on two of the deployment's whitened joint stacks
    (1,174 rows, 231 support columns), one with fewer live rows than
    columns and one with more, the reduced rows give the float64 Kalman
    update of the uncompressed stack to float32 rounding, where the MSCKF
    update's shifted CholeskyQR2 (`compress_system_ranges`) does not on
    the short stack;
(b) the vmapped step (`runner.ensemble_step`) against the benchmark's
    plain float64 reference (`vio_bench.reference`), stepped from the
    program's own state, through promotion, delayed init and eviction,
    anchored and global landmarks: the same discrete outcome every frame,
    the gaps within `sim_slam`'s limits;
(c) a stream on which the shifted CholeskyQR2 moved the pose past those
    limits, now within them;
(d) the MSCKF-only update never calls the reduction;
(e) the batched SLAM step dispatches as many ops at 5 streams as at 2:
    nothing in it loops over the streams (delayed init's covariance
    insertion once did, by `block_diag`, `index_add` and an accumulating
    `index_put` under vmap).
"""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.models import manager, runner
from open_vins_tpu_torch.models import update_helper as uh
from vio_bench import check, gen
from vio_bench.program import Program

ROOT = Path(__file__).resolve().parents[1]
ANCHORED = "ANCHORED_MSCKF_INVERSE_DEPTH"
CONFIG = json.loads((ROOT / "vio_bench/configs/sim_slam.json").read_text())
LIMITS = CONFIG["check"]
# the float32 rounding of the exact reduction on the stacks of
# `fault_stream` reads up to 6.9e-5 sigma and 9.0e-6 of the pose
# covariance (frames 4-15); the shifted CholeskyQR2 at frame 5 reads 0.73
# sigma and 0.15: the tolerances lie 14 and 11 times above the one
REDUCE_TOL_SIGMA = 1e-3
REDUCE_TOL_COV = 1e-4
# stream 14 of seed 5551, anchored, D = 270: at frame 5 the joint stack
# holds the 7 rows of one MSCKF feature against 231 columns, at frame 11
# 654 live rows.  `gen.make_streams` draws 32 streams at a time, so the
# stream is the same in any ensemble of 32 or more
FAULT_STREAM, FAULT_SEED, N_STREAMS = 14, 5551, 32
SHORT, LONG = 5, 11
# frame SHORT's stack, written by `PYTHONPATH=. python
# tests/test_torch_slam_joint.py --write` (`write_short_stack`)
SHORT_STACK = ROOT / "open_vins_tpu_torch/data/slam_joint_stack5551_s14_f5.npz"


def _update64(P, H, res, ranges):
    """(dx, P⁺) of the unit-noise Kalman update of (H, res) on the column
    support, float64."""
    P, H, res = P.double(), H.double(), res.double()
    H_s = uh.take_cols(H, ranges)
    PHt = uh.take_cols(P, ranges) @ H_s.T
    S = H_s @ uh.take_cols(PHt.T, ranges).T + torch.eye(H.shape[0],
                                                         dtype=P.dtype)
    K = torch.linalg.solve(S, PHt.T).T
    return K @ res, P - K @ PHt.T


def _gaps(P, stack, reduced, ranges):
    """(largest gap of dx in the exact posterior's sigma, largest pose
    covariance gap ÷ its largest entry) of the reduced rows' update
    against the uncompressed stack's."""
    dx_r, P_r = _update64(P, *stack, ranges)
    dx, P_c = _update64(P, *reduced, ranges)
    act = P_r.diagonal() > 0
    sig = P_r.diagonal().clamp(min=1e-300).sqrt()
    return (float(((dx - dx_r).abs() / sig)[act].max()),
            float((P_c - P_r)[:6, :6].abs().max() / P_r[:6, :6].abs().max()))


def _slam_config(rep, max_slam):
    config = json.loads(json.dumps(CONFIG))
    config["filter"].update(feat_rep_slam=rep, max_slam=max_slam)
    return config


def _stepped(config, streams, prog, last):
    """FAULT_STREAM stepped unbatched by `manager.step_frame` from its start
    to frame `last`: ({frame: (state, table) before it}, {frame: (P, H,
    res, cam_rows) of its joint update} at SHORT and LONG)."""
    cfg = prog.cfg
    calibs, runs = prog.records(streams)
    st, tb = (tree_map(lambda a: a[FAULT_STREAM], r)
              for r in prog.start(calibs, runs))
    pre, stacks = {}, {}
    for k in range(last + 1):
        frame = tree_map(lambda a: a[FAULT_STREAM],
                         runner.ensemble_frame(runs, k))
        pre[k] = (st, tb)
        if k in (SHORT, LONG):
            s1, t1, reserved = manager.pre_update(st, tb, cfg, frame)
            s2, _, H, res, _, _, cam_rows = manager.build_joint_system(
                s1, cfg, t1, prog.tri, reserved)
            stacks[k] = (s2.cov, H, res, cam_rows)
        st, tb, _ = manager.step_frame(st, tb, cfg, prog.tri, frame)
    return pre, stacks


def _fault_problem():
    config = _slam_config(ANCHORED, 50)
    config["sim"]["duration"] = 2.0
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), N_STREAMS,
                               FAULT_SEED, "cpu")
    return config, streams, Program(config)


@pytest.fixture(scope="module")
def fault_stream():
    """(config, streams, prog, pre, stacks) of `_stepped` to frame LONG."""
    config, streams, prog = _fault_problem()
    return (config, streams, prog, *_stepped(config, streams, prog, LONG))


def write_short_stack():
    """Write SHORT_STACK: frame SHORT's P and the live rows of its stack, as
    this tree's program reaches them.  The fault they show sits on float32
    rounding (a Cholesky that breaks down or not), so the stack is kept as
    data, which the code under test does not build again."""
    config, streams, prog = _fault_problem()
    _, stacks = _stepped(config, streams, prog, SHORT)
    P, H, res, cam_rows = stacks[SHORT]
    rows = torch.nonzero(uh.live_rows(H, res))[:, 0]
    np.savez_compressed(SHORT_STACK, P=P.numpy(), rows=rows.numpy(),
                        H=H[rows].numpy(), res=res[rows].numpy(),
                        m=H.shape[0], cam_rows=np.array(cam_rows))


def _short_stack():
    d = np.load(SHORT_STACK)
    H = torch.zeros((int(d["m"]), d["P"].shape[0]))
    res = torch.zeros(int(d["m"]))
    rows = torch.from_numpy(d["rows"])
    H[rows], res[rows] = torch.from_numpy(d["H"]), torch.from_numpy(d["res"])
    cam_rows = tuple(tuple(int(i) for i in span) for span in d["cam_rows"])
    return torch.from_numpy(d["P"]), H, res, cam_rows


@pytest.mark.parametrize("frame", [SHORT, LONG])
def test_reduction_gives_the_exact_update(frame, request):
    """(a): 7 live rows (fewer than the 231 columns; SHORT_STACK) and 654
    (more; the program's stack at frame LONG)."""
    cfg = FilterConfig(**CONFIG["filter"])
    ranges = cfg.slam_meas_support_ranges
    P, H, res, cam_rows = (_short_stack() if frame == SHORT else
                           request.getfixturevalue("fault_stream")[4][frame])
    H_c, res_c, n_live = uh.reduce_joint_system(
        H, res, ranges, cfg.state_dim, cam_rows, cfg.cam_meas_support_ranges)
    assert H_c.shape == (231, cfg.state_dim)
    assert int(n_live) == int(uh.live_rows(H, res).sum())
    assert (int(n_live) < 231) == (frame == SHORT)
    g, c = _gaps(P, (H, res), (H_c, res_c), ranges)
    assert g <= REDUCE_TOL_SIGMA and c <= REDUCE_TOL_COV, (g, c)
    if frame == SHORT:
        # the MSCKF update's shifted CholeskyQR2 on the same stack
        g, c = _gaps(P, (H, res), uh.compress_system_ranges(
            H, res, ranges, cfg.state_dim), ranges)
        assert g > 100 * REDUCE_TOL_SIGMA and c > 100 * REDUCE_TOL_COV


def _small_slam_config(rep):
    """`sim_slam` cut for the CPU: 5 clones and 4 landmark slots (D = 96),
    so the window is full, tracks are promoted and delayed-initialized from
    frame 5, and landmarks are evicted within the first 12 frames."""
    config = _slam_config(rep, 4)
    config["filter"]["max_clones"] = 5
    return config


@pytest.mark.parametrize("rep", [ANCHORED, "GLOBAL_3D"])
def test_vmapped_step_follows_reference(rep):
    """(b) on two 0.6 s streams, frames 4-11 compared."""
    config = _small_slam_config(rep)
    config["sim"]["duration"] = 0.6
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), 2,
                               2 ** 31 + 3, "cpu")
    prog = Program(config)
    calibs, runs = prog.records(streams)
    state, table = prog.start(calibs, runs)
    inits = evictions = rows = 0
    for k in range(streams.n_frames):
        st2, tb2, diag = prog.step(state, table, runs, k)
        if k >= 4:
            for b in range(2):
                one = {n: v[b] for n, v in state.items()}
                r_st, r_tb, r_diag, _ = check.reference_step(
                    config, one, {n: v[b] for n, v in table.items()},
                    check.frame_input(streams, b, k))
                post = {n: v[b] for n, v in st2.items()}
                assert check.same_outcome(
                    post, {n: v[b] for n, v in tb2.items()}, r_st, r_tb), \
                    (k, b)
                gap, cov_gap, counts = check.step_gaps(
                    [x[b] for x in prog.outputs(st2, diag)], r_st, r_diag)
                assert not counts, (k, b)
                assert gap <= LIMITS["state_gap_sigma"], (k, b, gap)
                assert cov_gap <= LIMITS["cov_gap"], (k, b, cov_gap)
                inits += int((post["slam_valid"] & ~one["slam_valid"]).sum())
                evictions += int((one["slam_valid"]
                                  & ~post["slam_valid"]).sum())
            rows = max(rows, int(diag.n_joint_rows.max()))
        state, table = st2, tb2
    assert inits > 0 and evictions > 0 and rows > 0, (inits, evictions)


def test_stream_past_the_limits_with_cholqr2_is_within_them(fault_stream,
                                                            monkeypatch):
    """(c): FAULT_STREAM's frame SHORT, the step against the reference from
    the same state: with the shifted CholeskyQR2 in place of the reduction
    the pose moves by 0.61 sigma of the reference's posterior (limit
    0.01); the exact reduction stays within the limits."""
    config, streams, prog, pre, _ = fault_stream
    st, tb = pre[SHORT]
    frame = tree_map(lambda a: a[FAULT_STREAM],
                     runner.ensemble_frame(prog.records(streams)[1], SHORT))
    r_st, r_tb, r_diag, _ = check.reference_step(
        config, dict(st.items()), dict(tb.items()),
        check.frame_input(streams, FAULT_STREAM, SHORT))

    def gaps():
        st2, tb2, d = manager.step_frame(st, tb, prog.cfg, prog.tri, frame)
        assert check.same_outcome(dict(st2.items()), dict(tb2.items()),
                                  r_st, r_tb)
        return check.step_gaps((st2.q, st2.p, st2.v, st2.cov[:6, :6],
                                d.n_msckf, d.n_slam_used), r_st, r_diag)

    g, c, counts = gaps()
    assert not counts
    assert g <= LIMITS["state_gap_sigma"] and c <= LIMITS["cov_gap"], (g, c)

    def cholqr2(H, res, ranges, D, cam_rows, cam_ranges):
        return (*uh.compress_system_ranges(H, res, ranges, D),
                torch.zeros((), dtype=torch.int32))
    monkeypatch.setattr(uh, "reduce_joint_system", cholqr2)
    g, c, _ = gaps()
    assert g > LIMITS["state_gap_sigma"], g


def test_msckf_update_never_reduces(monkeypatch):
    """(d): the pure-MSCKF cell's step compresses by CholeskyQR2 and never
    reaches the joint reduction."""
    config = json.loads(
        (ROOT / "vio_bench/configs/sim_msckf.json").read_text())
    config["sim"]["duration"] = 0.6
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), 2, 7,
                               "cpu")
    calls = []

    def refuse(*args):
        raise AssertionError("the MSCKF update reached the joint reduction")

    def counted(*args):
        calls.append(1)
        return compress(*args)
    compress = uh.compress_system_ranges
    monkeypatch.setattr(uh, "reduce_joint_system", refuse)
    monkeypatch.setattr(uh, "compress_system_ranges", counted)
    prog = Program(config)
    calibs, runs = prog.records(streams)
    state, table = prog.start(calibs, runs)
    used = 0
    for k in range(streams.n_frames):
        state, table, diag = prog.step(state, table, runs, k)
        used += int(diag.n_msckf.sum())
        assert int(diag.n_joint_rows.abs().sum()) == 0
    assert used > 0 and len(calls) == streams.n_frames


def _dispatched(n_streams, frames=7):
    """aten op name -> calls in the batched step of frame `frames` (delayed
    init at work) of `n_streams` streams of `_small_slam_config`."""
    config = _small_slam_config(ANCHORED)
    config["sim"]["duration"] = (frames + 2) / 20.0
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), n_streams,
                               2 ** 31 + 3, "cpu")
    prog = Program(config)
    calibs, runs = prog.records(streams)
    state, table = prog.start(calibs, runs)
    for k in range(frames):
        state, table, _ = prog.step(state, table, runs, k)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, diag = prog.step(state, table, runs, frames)
    assert int(diag.n_slam.sum()) > 0
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("aten::"))


def test_batched_step_does_not_loop_over_streams():
    """(e): no op is called once per stream; the op counts may differ by a
    few views where the streams' data differ."""
    two, five = _dispatched(2), _dispatched(5)
    for op in ("aten::block_diag", "aten::index_add", "aten::scatter_add_"):
        assert five[op] == two[op], op
    grown = sum(max(five[k] - two[k], 0) for k in five)
    assert grown <= 3 * 10, {k: (two[k], five[k]) for k in five
                             if five[k] > two[k]}


if __name__ == "__main__":
    import sys

    if "--write" in sys.argv:
        write_short_stack()
