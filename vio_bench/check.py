"""The comparison that decides `correct`.

The reference (`vio_bench/reference`, plain PyTorch in float64 on the CPU)
follows the program step by step: for each sampled (stream, window step)
it takes the program's own state and table just before that step, steps
the stream's frame itself, and the program's outputs and state after that
step are judged against it.  A step's discrete outcome (the clone ring,
the landmark slots, the track table, the features and landmarks used) must
be the reference's; where it is not, and some gate of the reference's step
lay within its float32 tolerance of the threshold
(`vio_bench/reference/margin.py`), the sample cannot decide; when as many
samples cannot decide as agree, nothing is checked and the gaps read
infinite.  The start is checked apart: every sampled stream's state and
table at frame 0 against the groundtruth prior and the empty table that the
reference builds from the same streams.

Since the steps follow the program's own state, a fault that the program
carries from step to step without showing it in a step's outputs (a clone
pose, a FEJ value, the track table) would pass them.  So the reference
also runs each sampled stream alone, from its own start, over the first
`check.pass_frames` frames of the pass, and the program's per-frame
outputs of those frames are judged against it.  A stream's pass is
compared up to the first frame at which the number of features or
landmarks used, or the ids in the landmark slots, differ from the
reference's: there a gate fell the other way (delayed init's and
eviction's decisions show in the slots).  Where no gate of the reference's
step at that frame lay within its float32 tolerance, or the landmarks
differ by more than two for each decision that lay within it (one gate
that falls the other way changes one landmark's use and, by eviction or
insertion, its slot), the difference counts as a differing decision.
When as many of the pass's frames go uncompared as are compared, its gaps
read infinite.

The reference follows the configurations that
`reference.manager.check_config` admits: pure MSCKF (`max_slam` 0) and
OpenVINS's SLAM deployment (landmarks in the state, stored as its EuRoC
configuration stores them, ANCHORED_MSCKF_INVERSE_DEPTH, or as global
points; delayed init; the joint "qr" update), both under rk4; the same
numbers and limits judge both.

Numbers compared, each with its limit in the configuration file (`check`
key):

  * `state_gap_sigma`: the largest gap of a posterior θ, p or v component
    between the program and the reference, in units of the reference's
    posterior standard deviation of that component (samples whose
    discrete outcome agrees);
  * `cov_gap`: the largest gap of the 6×6 pose covariance, relative to the
    largest entry of the reference's (the same samples);
  * `decision_gap`: samples, and passes, whose discrete outcome differs
    with no gate of the reference's step near its threshold;
  * `pass_gap_sigma`, `pass_cov_gap`: the same two gaps over the compared
    frames of the streams' passes from the start;
  * `start_gap`: the largest gap of the start's q, p, v or covariance to
    the reference's, infinite where its table is not the empty table
    (exact);
  * `nonfinite`: per-frame outputs of all streams and window steps that
    are not finite.
"""

from __future__ import annotations

import torch

from vio_bench.reference import manager as ref
from vio_bench.reference import margin
from vio_bench.reference.feature_table import FeatureTable, empty_table
from vio_bench.reference.layout import FilterConfig
from vio_bench.reference.propagator import ImuWindow
from vio_bench.reference.state import VioState
from vio_bench.reference.triangulation import TriangulationOptions
from vio_bench.plain import lie

F64 = torch.float64


def _f64(d: dict):
    return {k: v.to("cpu", F64) if v.is_floating_point() else v.to("cpu")
            for k, v in d.items()}


def frame_input(streams, b: int, k: int):
    """The reference's FrameInput of stream b's frame k, float64, CPU."""
    def g(x):
        x = x[b, k].to("cpu")
        return x.to(F64) if x.is_floating_point() else x

    return ref.FrameInput(
        win=ImuWindow(t=g(streams.win_t), w=g(streams.win_w),
                      a=g(streams.win_a)),
        t_new=g(streams.t_new), ids=g(streams.ids), uv=g(streams.uv),
        uvn=g(streams.uvn), mask=g(streams.mask))


def reference_step(config: dict, state: dict, table: dict, frame):
    """One frame of one stream from the program's state and table (plain
    dicts of one stream's fields): the reference's (state, table, diag)
    and the smallest gate margin of its step, in tolerances."""
    cfg = FilterConfig(**config["filter"])
    ref.check_config(cfg)
    opts = TriangulationOptions(**config.get("triangulation", {}))
    margin.reset()
    st, tb, diag = ref.step_frame(VioState(**_f64(state)),
                                  FeatureTable(**_f64(table)), cfg, opts,
                                  frame)
    return st, tb, diag, margin.worst()[0]


def reference_pass(config: dict, streams, b: int, frames: int):
    """Stream b's first `frames` frames stepped by the reference alone from
    its groundtruth start and an empty table, in float64: per frame, the
    reference's (state, diag), the smallest gate margin of its step and
    the number of its decisions that lay within tolerance."""
    cfg = FilterConfig(**config["filter"])
    ref.check_config(cfg)
    opts = TriangulationOptions(**config.get("triangulation", {}))
    st = VioState(**_f64(dict(reference_start(config, streams, b).items())))
    tb = empty_table(cfg, int(config["max_tracks"]))
    out = []
    for k in range(frames):
        margin.reset()
        st, tb, diag = ref.step_frame(st, tb, cfg, opts,
                                      frame_input(streams, b, k))
        out.append((st, diag, margin.worst()[0], margin.near_count()))
    return out


DISCRETE = {"state": ("head", "n_clones", "clone_valid", "slam_id",
                      "slam_valid", "slam_fail", "slam_anchor_slot",
                      "slam_anchor_cam"),
            "table": ("ids", "mbits", "seen")}


def same_outcome(post_state: dict, post_table: dict, st, tb) -> bool:
    """The program's discrete state after the step equals the
    reference's."""
    return (all(torch.equal(post_state[k].cpu(), getattr(st, k))
                for k in DISCRETE["state"])
            and all(torch.equal(post_table[k].cpu(), getattr(tb, k))
                    for k in DISCRETE["table"]))


def reference_start(config: dict, streams, b: int):
    """Stream b's groundtruth start at frame 0, as the reference builds it
    (float32, as the program's)."""
    cfg = FilterConfig(**config["filter"])
    cpu = {k: getattr(streams, k)[b].to("cpu")
           for k in ("gt_q", "gt_p", "gt_v", "bias_g0", "bias_a0",
                     "cam_R_ItoC", "cam_p_IinC", "cam_intr")}
    return ref.initialize_from_gt(
        cfg, cpu["gt_q"][0], cpu["gt_p"][0], cpu["gt_v"][0], cpu["bias_g0"],
        cpu["bias_a0"], 0.0, calib_ext_q=lie.rot_2_quat(cpu["cam_R_ItoC"]),
        calib_ext_p=cpu["cam_p_IinC"], calib_intr=cpu["cam_intr"])


def quat_angle_gap(q_a, q_b):
    """δθ [3] with R(q_a) = exp(−⌊δθ⌋) R(q_b) to first order (JPL)."""
    inv_b = torch.cat([-q_b[..., :3], q_b[..., 3:4]], dim=-1)
    qv, q4 = q_a[..., :3], q_a[..., 3:4]
    pv, p4 = inv_b[..., :3], inv_b[..., 3:4]
    vec = q4 * pv + p4 * qv - torch.linalg.cross(qv, pv, dim=-1)
    sca = q4 * p4 - torch.sum(qv * pv, dim=-1, keepdim=True)
    return 2.0 * torch.where(sca < 0, -vec, vec)


def step_gaps(out, st, diag):
    """(state gap in σ, covariance gap, counts differ) of one sample:
    `out` the program's (q, p, v, cov6, n_msckf, n_slam_used) of the
    stream, `st`/`diag` the reference's."""
    q, p, v, cov6, n_msckf, n_slam_used = (x.to("cpu") for x in out)
    e = torch.cat([quat_angle_gap(q.to(F64), st.q), p.to(F64) - st.p,
                   v.to(F64) - st.v])
    sig = torch.sqrt(torch.clamp(torch.diagonal(st.cov)[:9], min=1e-300))
    ref6 = st.cov[:6, :6]
    cov_gap = ((cov6.to(F64) - ref6).abs().max()
               / ref6.abs().max().clamp(min=1e-300))
    counts = bool((n_msckf != diag.n_msckf) | (n_slam_used
                                                 != diag.n_slam_used))
    return float((e.abs() / sig).max()), float(cov_gap), counts


def landmark_moves(ids, n_slam_used, st, diag) -> int:
    """How far the program's landmarks of one frame lie from the
    reference's: the difference in landmarks used, plus the ids in one
    side's slots and not the other's (1 where the same ids sit in other
    slots).  `ids` [L] are the program's slots' ids."""
    ids = ids.to(st.slam_id.dtype)
    a = set(ids[ids >= 0].tolist())
    b = set(st.slam_id[st.slam_id >= 0].tolist())
    moved = len(a ^ b) or int(not torch.equal(ids, st.slam_id))
    return abs(int(n_slam_used) - int(diag.n_slam_used)) + moved


def start_gap(start: dict, table: dict, ref_state: VioState,
              ref_table: FeatureTable) -> float:
    """Largest gap of the program's start (q, p, v, covariance) to the
    reference's; infinite where the start's table is not the
    reference's."""
    if not all(torch.equal(table[k].to("cpu", getattr(ref_table, k).dtype),
                           getattr(ref_table, k))
               for k, _ in ref_table.items()):
        return float("inf")
    gaps = [(start[k].to("cpu", F64) - getattr(ref_state, k).to(F64))
            .abs().max() for k in ("q", "p", "v", "cov")]
    return float(torch.stack(gaps).max())
