"""The reference on OpenVINS's SLAM deployment (CPU): a cell of the SLAM
filter (`max_slam` > 0, the joint "qr" update, landmarks stored in
OpenVINS's EuRoC representation, ANCHORED_MSCKF_INVERSE_DEPTH, or as
global points), added by new files alone, reads `correct` true through the
harness at two streams, and false with the timed path broken underneath
(landmark parameters carried 1e-2 off, the landmark rows dropped from the
joint stack, delayed init collecting nothing); the reference's step
follows the port's unbatched `manager.step_frame`; `check_config` refuses
every other path by name.

    python -m pytest --noconftest vio_bench/tests/test_slam.py -q
"""

import json
import time

import pytest
import torch
from torch.utils._pytree import tree_map

from vio_bench import check, gen, harness
from vio_bench.program import Program
from vio_bench.reference import manager as ref
from vio_bench.reference import updater_slam as ref_slam
from vio_bench.reference.layout import FilterConfig
from vio_bench.tests.tiny import CELL, ROOT, make_tree

# 8 landmark slots (D = 144) on a 1.5 s stream (29 frames): the window is
# full at frame 10, where the first tracks are promoted and initialized;
# the first landmarks are evicted by frame 14, and the first anchors (the
# clone of frame 10) move at frame 21, inside the 24-frame pass
L = 8
DURATION, PASS_FRAMES = 1.5, 24
SEED = 2 ** 31 + 3
ANCHORED = "ANCHORED_MSCKF_INVERSE_DEPTH"
REPS = [ANCHORED, "GLOBAL_3D"]


@pytest.fixture(scope="module", params=REPS)
def tree(request, tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("slam"), DURATION,
                     filter_={"max_slam": L, "feat_rep_slam": request.param},
                     pass_frames=PASS_FRAMES)


def _config(tree):
    return json.loads((tree / "vio_bench/configs/sim_tiny.json").read_text())


def _run(root, seconds=6):
    return harness.run_cell(root, CELL, SEED, seconds, False,
                            torch.device("cpu"), time.perf_counter())


def test_pass_promotes_initializes_and_evicts(tree, monkeypatch):
    """Within the pass frames of both streams, at least one track is
    reserved for promotion, one landmark is delayed-initialized and one is
    evicted, and an anchored landmark moves to a new anchor."""
    config = _config(tree)
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), 2, SEED,
                               "cpu")
    promoted = []
    promote = ref_slam.promotion_candidates

    def counted(*args):
        rows = promote(*args)
        promoted.append(int(rows.sum()))
        return rows
    monkeypatch.setattr(ref_slam, "promotion_candidates", counted)
    inits = evictions = moves = 0
    for b in range(2):
        valid = torch.zeros(L, dtype=torch.bool)
        anchor = torch.zeros(L, dtype=torch.int32)
        for st, *_ in check.reference_pass(config, streams, b,
                                           PASS_FRAMES):
            inits += int((st.slam_valid & ~valid).sum())
            evictions += int((valid & ~st.slam_valid).sum())
            moves += int((valid & st.slam_valid
                          & (st.slam_anchor_slot != anchor)).sum())
            valid, anchor = st.slam_valid, st.slam_anchor_slot
    assert sum(promoted) > 0 and inits > 0 and evictions > 0
    anchored = config["filter"]["feat_rep_slam"] == ANCHORED
    assert (moves > 0) == anchored


def test_slam_cell_is_correct(tree):
    res = _run(tree)
    assert res["correct"] is True and res["failed"] == 0
    for name, c in res["check"].items():
        assert c["value"] <= c["limit"], name


def _landmarks_carried(monkeypatch):
    """Landmark parameters 1e-2 off after each step (1 cm of a global
    point; of an anchored one's bearing and inverse depth): a value the
    next steps read, which no step's output shows."""
    step = Program.step

    def run(self, state, table, runs, k):
        st, tb, diag = step(self, state, table, runs, k)
        return st.replace(slam_p=st.slam_p + 1e-2), tb, diag
    monkeypatch.setattr(Program, "step", run)


def _slam_rows_dropped(monkeypatch):
    """The landmark rows left out of the joint stack."""
    from open_vins_tpu_torch.models import updater_slam

    build = updater_slam.build_update

    def run(*args):
        state, table, H, res, failed, n_used = build(*args)
        return state, table, H * 0.0, res * 0.0, failed, n_used
    monkeypatch.setattr(updater_slam, "build_update", run)


def _init_collects_nothing(monkeypatch):
    """Delayed init inserts its landmarks but collects none of their
    leftover rows."""
    from open_vins_tpu_torch.models import updater_slam

    init = updater_slam.delayed_init

    def run(*args, **kwargs):
        out = init(*args, **kwargs)
        if not kwargs.get("collect", True):
            return out
        state, table, n_init, H, res = out
        return state, table, n_init, H * 0.0, res * 0.0
    monkeypatch.setattr(updater_slam, "delayed_init", run)


@pytest.mark.parametrize("fault", [_landmarks_carried, _slam_rows_dropped,
                                   _init_collects_nothing])
def test_broken_slam_step_is_not_correct(tree, monkeypatch, fault):
    fault(monkeypatch)
    assert _run(tree)["correct"] is False


# The program steps in float32 and the reference in float64 from the same
# state: one step's rounding moved q, p, v by at most 4.1e-4 of the
# reference's posterior sigma and P by 1.4e-3 of its largest entry (the
# landmark block's) with global points, by 4.1e-4 and 9.1e-5 with anchored
# inverse depths, on eight streams of seeds 7, 13, 2**31 + 11 and 5551
# (39 frames each), so the tolerances lie 12 and 7 times above them; the
# departure they are there to see, a float32 compression's, read 0.18
# sigma and 0.13 (anchored: 0.176 and 0.125).
STATE_TOL_SIGMA = 5e-3
COV_TOL = 1e-2


def _exact_compression(monkeypatch):
    """The port's joint stack compressed by a Householder QR in float64 in
    place of its float32 CholeskyQR2: the reference applies the stack
    uncompressed, the same update in exact arithmetic, and the float32
    CholeskyQR2 departs from it on some streams (stream 3 of seed 5551:
    0.18 sigma and 13 % of P in one step), which the benchmark's
    comparison is there to catch."""
    from open_vins_tpu_torch.models import update_helper as uh

    def qr(H, res, ranges, D):
        k = sum(b - a for a, b in ranges)
        A = torch.cat([uh.take_cols(H, ranges), res[:, None]], dim=1)
        R = torch.linalg.qr(A.double(), mode="r").R[:k]
        Hc = H.new_zeros((k, k))
        Hc[:R.shape[0]] = R[:, :k].to(H.dtype)
        rc = H.new_zeros((k,))
        rc[:R.shape[0]] = R[:, k].to(H.dtype)
        return uh.scatter_cols(Hc, ranges, D), rc
    monkeypatch.setattr(uh, "compress_system_ranges", qr)


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("seed, n_streams, b", [
    (7, 2, 0), (7, 2, 1), (2 ** 31 + 11, 2, 0), (5551, 24, 3)])
def test_reference_step_follows_port_step(seed, n_streams, b, rep,
                                          monkeypatch):
    """From the same state, frame by frame over stream b's first 2 s (39
    frames: promotion, delayed init, eviction and, anchored, the anchor
    change), the reference's step and the port's unbatched
    `manager.step_frame` (float32, CPU, its compression exact:
    `_exact_compression`) reach the same discrete outcome, and q, p, v and
    P agree within the tolerances."""
    from open_vins_tpu_torch.models import manager, runner

    _exact_compression(monkeypatch)
    config = json.loads(
        (ROOT / "vio_bench/configs/sim_msckf.json").read_text())
    config["filter"].update(max_slam=50, feat_rep_slam=rep)
    config["sim"]["duration"] = 2.0
    streams = gen.make_streams(gen.Sim.from_dict(config["sim"]), n_streams,
                               seed, "cpu")
    prog = Program(config)
    calibs, runs = prog.records(streams)
    st, tb = (tree_map(lambda a: a[b], r) for r in prog.start(calibs, runs))
    seen = {"init": 0, "evict": 0, "move": 0}
    for k in range(streams.n_frames):
        frame = tree_map(lambda a: a[b], runner.ensemble_frame(runs, k))
        st2, tb2, d2 = manager.step_frame(st, tb, prog.cfg, prog.tri, frame)
        r_st, r_tb, r_d, _ = check.reference_step(
            config, dict(st.items()), dict(tb.items()),
            check.frame_input(streams, b, k))
        out = (st2.q, st2.p, st2.v, st2.cov[:6, :6], d2.n_msckf,
               d2.n_slam_used)
        gap, _, counts = check.step_gaps(out, r_st, r_d)
        assert not counts, k
        assert check.same_outcome(dict(st2.items()), dict(tb2.items()),
                                  r_st, r_tb), k
        assert gap <= STATE_TOL_SIGMA, (k, gap)
        cov_gap = ((st2.cov.double() - r_st.cov).abs().max()
                   / r_st.cov.abs().max())
        assert cov_gap <= COV_TOL, (k, float(cov_gap))
        seen["init"] += int((st2.slam_valid & ~st.slam_valid).sum())
        seen["evict"] += int((st.slam_valid & ~st2.slam_valid).sum())
        seen["move"] += int((st.slam_valid & st2.slam_valid & (
            st.slam_anchor_slot != st2.slam_anchor_slot)).sum())
        st, tb = st2, tb2
    assert seen["init"] > 0 and seen["evict"] > 0
    assert (seen["move"] > 0) == (rep == ANCHORED)


@pytest.mark.parametrize("option, value", [
    ("joint_vision_update", False), ("joint_update_form", "woodbury"),
    ("joint_update_form", "newton"), ("fast_compress", True),
    ("feat_rep_slam", "ANCHORED_INVERSE_DEPTH_SINGLE"),
    ("feat_rep_slam", "ANCHORED_3D"),
    ("feat_rep_msckf", "ANCHORED_MSCKF_INVERSE_DEPTH"),
    ("integration", "analytical"), ("use_zupt", True),
    ("num_aruco_tags", 4), ("calib_cam_extrinsics", True)])
def test_check_config_refuses_other_paths(option, value):
    for rep in REPS:
        ref.check_config(FilterConfig(max_slam=50, feat_rep_slam=rep))
    with pytest.raises(ValueError, match=option):
        ref.check_config(FilterConfig(max_slam=50, **{option: value}))
