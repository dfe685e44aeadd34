"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds (any failure raises,
so the exit code is not 0):

1. environment: torch / CUDA versions and the card's
   `nvidia-smi --query-gpu=name,power.limit` line;
2. build: every CUDA kernel of the port from the sources in the checkout,
   one nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes it is timed at and at edge shapes (checked only), with the least
   time the card could take and two times of the kernel and of the nearest
   single PyTorch call: `device_ms`, a CUDA graph of 50 calls replayed
   between one event pair (kernel and library call in turns), and
   `call_ms`, one event pair around each eager call, which is what the
   eager main path pays (host dispatch included).  `symmetric_downdate` at
   the reference's oracle shapes, the main paths' (120, 81) and (270, 231)
   and the large map's (1434, 231); `householder_qr_blocks` at the oracle
   shapes and the row blocks of the MSCKF-only stack (760 × 121) and of the
   operating point's joint stack (1174 × 271);
4. the MSCKF-only closed loop (11 clones, 200 points, <= 40 MSCKF features
   per update, 20 Hz camera / 200 Hz IMU, rk4) over the 399 staged frames
   of `open_vins_tpu_torch/data/msckf_sim20_seed0.npz`, after a 40-frame
   warm-up;
5. the TSQR path on real stacks: the operating point stepped frame by frame,
   and at three frames with the window full and landmarks in use the joint
   stack is built from the frame's pre-update state by the manager's own
   functions and compressed by `compress_system` (the Householder TSQR,
   through `householder_qr_blocks`), against `compress_system_ranges`
   (the filter's CholeskyQR2) on the same stack: same information and the
   same EKF update;
   At frame 30 the same phase records the operands of the K ≠ PHt
   downdates that the push-through forms give on the frame's real joint
   stack — (P_cols, Wᵀ) of woodbury and newton, (P_cols·W, P_cols) of spd,
   both at (270, 231) — and of a real ZUPT attempt on the frame's IMU
   window, (P_cols, Wᵀ) at (270, 9); each is checked against the plain
   version and timed beside `torch.addmm` (`k_not_pht` in the kernels
   line);
6. the operating point's closed loop (bench.py:94-96: 11 clones, 50 SLAM
   landmarks, <= 40 MSCKF features, ACI², the joint "qr" update) over the
   same 399 frames, through `runner.run_filter`; then the same frames in
   the woodbury, spd and newton joint forms (`main_path_forms`: one
   downdate launch per frame, the newton solve's residual under its no-op
   gate) and in the reference-exact sequential ordering
   (`main_path_sequential`: the MSCKF, SLAM and init-leftover updates,
   each its own downdate), each against the JAX run of its configuration;
   then the operating point's widths with ZUPT on 20 s of the stop-and-go
   trajectory of tests/test_slam_stack.py (`stop_and_go_trajectory`, a
   numpy copy), staged on the card and held against the CPU staging's
   digest, with at least 3 ZUPT frames after frame 30 and a count within
   20 % of the JAX run's (`main_path_zupt`); each of these loops must also
   land within 25 % of its JAX run's NEES;
7. the port's simulator stages two streams on the card from
   `simulator.draw(params, 0)` (`convert.stage_stream`), each held against
   the digest of the port's CPU staging of the same draws that its
   reference file holds: ids and masks equal but for at most
   STAGING_FLIPS_MAX entries, each in a frame with a map point at the image
   border or the depth gate; pixels within 1e-3 px where both are valid;
   groundtruth within 1e-5;
8. the large map (bench.py:389-402: 30 clones, 400 SLAM landmarks, 400
   points per frame, a map of 4,096 points, 8 s, D = 1434) over its 159
   frames;
9. the V1_02 replay (tests/test_corpus_replay.py:33-48: 40 s of the padded
   in-repo `results/suite/truths/V1_02_medium.txt`, the operating point in
   ANCHORED_MSCKF_INVERSE_DEPTH) over its 799 frames, then
   `runner.run_filter_from` from the groundtruth state at frame 40 over the
   first 200 frames;
10. bench.py's 8-seed ensemble (bench.py:221-282): the operating point on
   8 streams, seeds 0..7, staged on the card by `runner.stage_ensemble`
   (each stream held against its digest in
   `open_vins_tpu_torch/data/ensemble8_sim20_ref.npz`, as phase 7 holds
   one), then `runner.run_ensemble` over all 399 frames after a 40-frame
   warm-up: every frame is one batched step (`manager.step_frame` under
   `torch.func.vmap`) whose covariance downdate is one launch of the
   batched kernel for all 8 streams.  It prints the aggregate frames/s
   (8 × 399 / seconds), each stream's RMSE and NEES and the seed-mean NEES,
   and must pass: every covariance finite, median RMSE < 0.05 m
   (bench.py:266-267), each stream within 0.01 m RMSE of its JAX run, the
   seed-mean NEES in 0.2-30 and within 25 % of the JAX seed-mean, and 399
   downdate launches in 399 frames.  At frame 30 the batch is stepped once
   more from its state and each stream held against its own single-stream
   step (covariance within 1e-5·‖P‖∞, 5e-5 in a step that initializes a
   landmark).  Phase 3 also checks the batched downdate (vmapped, one
   launch per batch) at [8, 270, 231] and [8, 120, 81] (timed beside
   `torch.baddbmm`), batch 1, batch 3 at D = 33, m = 0, batch 32 at
   (100, 7) and a broadcast P, and the QR kernel's vmap rule on 8 streams'
   stacked blocks.  Then the ensemble's streams are stepped 40 frames in
   the newton joint form with ZUPT (`main_path_ensemble8_newton_zupt`):
   two batched downdate launches per batched frame (the ZUPT attempt's at
   m = 9 and the newton update's, both K ≠ PHt), the masked polish sweeps
   on the card, and at frame 30 each stream against its own step
   (NEWTON_STEP_TOL, NEWTON_INIT_STEP_TOL).
11. the image front end on bench.py's rendered stream (bench.py:284-380:
   752x480 stereo, a map of 2,048 points, 8 s on the sine trajectory, the
   stereo calibration of bench.py:292-299), against the JAX references in
   `open_vins_tpu_torch/data/rendered_stereo8_seed0_ref.npz`:
   `sim_staging_rendered` stages the stream on the card (held against the
   CPU staging's digest, as phase 7); `render` renders all 160 frames of
   both cameras in one batched call (`runner.render_frames`), each frame's
   image sum, sum of squares and first moments Σx·I, Σy·I (which a flip,
   a transpose or a misplaced sprite moves) within 1e-4 relative of JAX's
   `render_frame` on the CPU staging, and prints
   `frontend_render_ms_per_frame`; `tracker_staged` runs
   `runner.run_tracker_staged` on the first 120 card-rendered frames with
   bench.py's KltParams (200 features, 20x15 grid, 4 levels, 21x21
   window), must hold more than 150 tracks per frame, within 5 % of JAX's
   mean on the CPU-rendered images and no frame below half of JAX's count,
   and prints `klt_track_frames_per_sec_1chip` and the GPU kernels per
   frame (torch.profiler over 10 frames); `descriptor` runs the
   descriptor tracker on 40 left-eye frames, its mean inherited ids per
   frame within 10 % of JAX's tracker with the port's matched-rows id
   scatter (JAX's own, which scatters every row, is printed beside it);
   `main_path_rendered` runs `runner.run_filter_rendered` (11 clones, 25
   landmark slots, two cameras, <= 40 MSCKF features, ACI², 384 tracks)
   over all 159 frames: finite covariance, RMSE < 0.09 m (bench.py:373-374),
   NEES in 0.2-30, landmarks in use, more than 150 tracks per frame, one
   downdate launch per frame, and an RMSE within max(0.01 m, twice the
   JAX pipeline's own spread) of JAX's run — the spread is the RMSE gap
   between two JAX runs whose trackers differ only in the RANSAC seed, the
   one thing the port cannot reproduce; it prints
   `rendered_pipeline_frames_per_sec_1chip`.  That bar is wide (JAX's two
   seeds lie 0.038 m apart), so `rendered_replay` holds the same pipeline
   to JAX itself: it hands the tracker JAX's own RANSAC sets for the
   first 40 frames, recorded in the reference, and requires the tracker's
   packets (`runner.render_and_track`) to carry JAX's ids and masks
   exactly and its points within 5e-3 px, and `runner.run_filter_rendered`
   over those frames JAX's per-frame MSCKF, landmark and track counts
   exactly and its positions and quaternions within 1e-4.
12. initialization and the rest of the estimator, each against a committed
   JAX result: `static_init` runs `static_init.try_static_init` on
   tests/test_init.py's windows (jerk, no jerk, moving, attitude and
   biases; `static_init_ref.npz`), waiting for the jerk and not: JAX's
   success flags, q and the biases within STATIC_TOL; `dynamic_init` runs
   `dynamic_init.initialize` on tests/test_dynamic_init.py's seed-11
   problem and its degenerate windows (JAX's DynInitInput carried over in
   `dyninit_seed11_ref.npz`): JAX's success flags, the seed-11 outputs
   within DYNINIT_TOL (about five times the reference's own jit-vs-eager
   gap), and host ms and GPU kernels of one attempt; `auto_init_v102` runs
   `runner.auto_init_state` on the V1_02 replay, on the port's CPU staging
   moved to the card (the route and k0 as JAX's `auto_init_state` on the
   same staging, `v102_autoinit_seed0_ref.npz`, the state within
   DYNINIT_TOL) and on the card's own staging of phase 7, both within 1°
   of the groundtruth gravity direction and 0.1 m/s of its speed, then
   `runner.run_filter_from` from the first over the whole replay: posyaw
   ATE < 0.08 m and < 1.5°, within 0.01 m of JAX's run from JAX's init,
   the posyaw-aligned NEES in 0.5-30 (`init_replay_metrics`), more than 10
   landmarks over the last three quarters; `background_init` drives the
   same search through `background.BackgroundInitializer` (the attempt on
   the worker thread, the next 10 camera times queued, `join`) and
   `catch_up`, whose result from JAX's init state must equal JAX's
   `background.catch_up` (1e-5·‖P‖∞); `main_path_single` and
   `main_path_single_sequential` run the operating point's first 200
   frames with ANCHORED_INVERSE_DEPTH_SINGLE landmarks (joint "qr",
   sequential; JAX's RMSE and NEES recomputed over the same frames), and
   `main_path_aruco` tests/test_aruco_sigma.py's stream staged on the card
   with ids 0..256 aruco tag corners: each within 0.01 m RMSE and 25 % NEES
   of its JAX run, with a finite covariance and a downdate launch per
   frame.
13. the host utilities and the parallel layer: `config_oppoint` loads a
   YAML tree written to a temporary directory with `utils.config.load`
   (the operating point's FilterConfig) and runs 40 frames of the
   operating point from it, within 0.01 m of the JAX run's positions;
   `checkpoint_timing_traj_io` steps the operating point's frames 0..59
   with `utils.timing.FrameTimer` writing the timing CSV (60 rows, stages
   within the frame's total), saves a checkpoint after frame 30, loads it
   back onto the card and steps to frame 60 again: the resumed state and
   table must equal the uninterrupted ones (bitwise, else within the
   step-parity tolerance with the gaps printed), and the trajectory goes
   through a TUM file and back within 1e-6; `profiling` traces 3 more
   frames with `utils.profiling.trace`, whose Chrome trace must hold the
   `annotate` labels and a CUDA kernel event of `symmetric_downdate` in
   every frame; `window_refine` runs `parallel.window_refine` on JAX's
   operating-point state and table after 30 frames
   (`window_refine_oppoint30_ref.npz`): JAX's landmark rows and `ok`
   exactly, the refined window within twice the reference's own
   jit-vs-eager spread of JAX's, the RMS not rising; `parallel_nccl_1`
   and `parallel_gloo_2` run the row-sharded EKF update at the large
   map's D (1434) and the distributed Schur BA on one NCCL rank in this
   process and on two gloo ranks spawned on the one card with CUDA
   tensors, each against the port's dense single-device result on the
   card (covariance within 2e-4, poses within 1e-4, landmarks within
   1e-3); `dryrun` runs `parallel.dryrun.run` on two ranks on the card at
   the operating point (each rank's stream through `step_frame`, a
   downdate launch per frame) with the sharded update and the BA, and
   prints the host-bound caveat.

Each closed loop sets the kernels' launch counts to 0 just before its timed
run and reads them just after, and must launch `symmetric_downdate` at
least once per frame.  The simulated loops must pass the health gate
(finite covariance, RMSE < 0.05 m, 0.2 < NEES < 30) and land within 0.01 m
RMSE of the JAX run on the same frames; the replay must pass
tests/test_corpus_replay.py's gates (posyaw ATE < 0.08 m and < 1.5°,
0.5 < NEES < 30, more than 10 landmarks on average over the last three
quarters) and land within 0.01 m posyaw ATE of the JAX run.  The line
before the last lists every kernel's numbers; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "open_vins_tpu_torch", "data")
FIXTURE = os.path.join(DATA, "msckf_sim20_seed0.npz")
OPPOINT_REF = os.path.join(DATA, "oppoint_sim20_seed0_ref.npz")
ENSEMBLE_REF = os.path.join(DATA, "ensemble8_sim20_ref.npz")
LARGEMAP_REF = os.path.join(DATA, "largemap_sim8_seed0_ref.npz")
V102_REF = os.path.join(DATA, "v102_replay40_seed0_ref.npz")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 non-tensor
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

DOWNDATE_SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81),
                   (270, 231), (1434, 231), (1434, 1395)]
DOWNDATE_EDGE_SHAPES = [(1, 5), (1, 0), (33, 20), (33, 0)]  # checked only
OPPOINT_SHAPE = (270, 231)  # D and support width at the operating point
# the batched downdate (n streams, D, m): the ensemble's and the MSCKF-only
# widths at 8 streams (timed), then edge shapes (checked only)
BATCHED_SHAPES = [(8, 270, 231), (8, 120, 81)]
BATCHED_EDGE_SHAPES = [(1, 270, 231), (3, 33, 20), (3, 33, 0), (8, 270, 0),
                       (32, 100, 7)]
ENSEMBLE_SHAPE = (8, 270, 231)
LARGEMAP_SHAPE = (1434, 1395)  # the large map's D and support width
# (label, g, B, n) of the QR blocks: the JAX oracle shapes, then the stacks'
# blocks as update_helper._tsqr_r cuts them (B = 2n rounded up to 32)
QR_SHAPES = [("oracle", 3, 256, 128), ("oracle", 3, 512, 128),
             ("oracle", 3, 384, 256), ("msckf_stack", 760, 256, 121),
             ("oppoint_stack", 1174, 544, 271)]
# checked only: n < 32 (one ragged panel), B = n, g = 1 at the stack's n,
# a block taller than the register panel's 640 rows
QR_EDGE_SHAPES = [("edge", 2, 40, 15), ("edge", 1, 71, 71),
                  ("edge", 1, 544, 271), ("edge", 1, 704, 96)]
QR_ELEMENT_TOL = 1e-5  # × max|R|: the same reflectors, sums in another order
RMSE_GATE_M = 0.05
REF_RMSE_SPREAD_M = 0.01
MSCKF_WARM_FRAMES = 40
TSQR_FRAMES = (20, 30, 40)  # window full, 32-50 landmarks in use
# staging on the card against the CPU staging's digest: an f32 rounding may
# flip a point at the image border or the depth gate in or out of view
STAGING_FLIPS_MAX = 4
STAGING_UV_TOL_PX = 1e-3
STAGING_GT_TOL = 1e-5
GATE_NEAR_PX, GATE_NEAR_M = 1e-3, 1e-6
# tests/test_corpus_replay.py:63-115
REPLAY_ATE_POS_M, REPLAY_ATE_ORI_DEG = 0.08, 1.5
REPLAY_NEES = (0.5, 30.0)
REPLAY_MIN_SLAM = 10.0
RUN_FROM_K0, RUN_FROM_FRAMES, RUN_FROM_RMSE_M = 40, 200, 0.1
ENSEMBLE_WARM_FRAMES = 40
ENSEMBLE_NEES_SPREAD = 0.25  # seed-mean NEES against the JAX seed-mean
ENSEMBLE_CHECK_FRAME = 30  # window full, landmarks in use
FORM_REFS = {form: os.path.join(DATA, f"oppoint_{form}_sim20_seed0_ref.npz")
             for form in ("woodbury", "spd", "newton")}
SEQUENTIAL_REF = os.path.join(DATA, "sequential_sim20_seed0_ref.npz")
ZUPT_REF = os.path.join(DATA, "zupt_stopgo20_seed0_ref.npz")
NEES_SPREAD = 0.25  # a loop's NEES against its JAX run's
NEWTON_NOOP_TOL = 5e-2  # ekf.kalman_update_math_newton's no-op gate
ZUPT_MIN_FRAMES, ZUPT_FIRST_FRAME = 3, 30  # tests/test_slam_stack.py:120-124
ZUPT_COUNT_SPREAD = 0.2  # ZUPT frames against the JAX run's count
FORMS_CAPTURE_FRAME = 30  # the K ≠ PHt operands of the forms and of ZUPT
# the vmapped newton + ZUPT check: 8 streams of the ensemble, this many
# frames, each stream held against its own step at ENSEMBLE_CHECK_FRAME
NEWTON_ZUPT_FRAMES = 40
RENDERED_REF = os.path.join(DATA, "rendered_stereo8_seed0_ref.npz")
RENDER_SUM_RTOL = 1e-4  # per-frame image moments against JAX's render_frame
RENDER_MOMENTS = ("sum", "sumsq", "mx", "my")  # `render_moments`' order
REPLAY_UV_TOL_PX = 5e-3  # packets with JAX's sets: 1.5e-3 port-CPU vs JAX
REPLAY_POSE_TOL = 1e-4  # positions (m) and quaternions with JAX's sets
MIN_TRACKS = 150.0  # bench.py's tracker gate (tracks per stereo frame)
TRACKER_MEAN_SPREAD = 0.05  # mean tracks per frame against JAX's
TRACKER_FRAME_FLOOR = 0.5  # no frame below this share of JAX's count
RENDERED_RMSE_GATE_M = 0.09  # bench.py:373-374
RENDERED_NEES = (0.2, 30.0)
DESC_SPREAD = 0.10  # mean inherited ids per frame against JAX's
TRACKER_PROFILE_FRAMES = 10
# the newton form's batched step against its single-stream step: 5 times
# the "qr" rule (its Newton sweeps amplify the batched products' rounding;
# tests/test_torch_zupt.py)
NEWTON_STEP_TOL, NEWTON_INIT_STEP_TOL = 5e-5, 2.5e-4
# initialization (tests/test_torch_init.py, test_torch_dynamic_init.py,
# test_torch_auto_init.py): the static init's tolerances, the dynamic
# init's outputs relative to each output's max (about five times the
# reference's own jit-vs-eager gap on the seed-11 problem), the init
# state's gates of tests/test_corpus_replay.py:133-143
STATIC_REF = os.path.join(DATA, "static_init_ref.npz")
STATIC_TOL = {"q_GtoI": 2e-6, "bg": 1e-6, "ba": 1e-6}
DYNINIT_REF = os.path.join(DATA, "dyninit_seed11_ref.npz")
DYNINIT_TOL = {"q_GtoI": 2e-4, "p": 5e-3, "v": 5e-3, "bg": 1e-2, "ba": 2e-2,
               "cov15": 1e-2}
V102_AUTOINIT_REF = os.path.join(DATA, "v102_autoinit_seed0_ref.npz")
INIT_GRAVITY_DEG, INIT_SPEED_MPS = 1.0, 0.1
CATCHUP_COV_TOL, CATCHUP_VALUE_TOL = 1e-5, 1e-4
# the single-depth landmarks and aruco landmarks against their JAX runs
SINGLE_REFS = {
    "single": os.path.join(DATA, "oppoint_single_sim20_seed0_ref.npz"),
    "single_sequential": os.path.join(
        DATA, "sequential_single_sim20_seed0_ref.npz")}
ARUCO_REF = os.path.join(DATA, "aruco_sim5_seed3_ref.npz")


WINDOW_REF = os.path.join(DATA, "window_refine_oppoint30_ref.npz")
# the refined window against JAX's: twice the reference's own spread (its
# jitted and eager runs differ by 8.7e-4 in R, 4.2e-4 in p, 1.7e-3 in the
# landmarks, tests/test_torch_window_refine.py)
WINDOW_TOL = {"R": 1.8e-3, "p": 8.5e-4, "landmarks": 3.4e-3,
              "rms_before": 2e-8, "rms_after": 2e-8}
WINDOW_LANDMARKS, WINDOW_ITERS = 64, 3
CONFIG_FRAMES = 40
RESUME_FRAMES, RESUME_SAVE = 60, 30
PROFILE_FRAMES = 3
STEP_COV_TOL = 5e-5  # × ‖P‖∞: the step-parity tolerance (ROADMAP.md)
SHARDED_COV_TOL = 2e-4  # tests/test_sharded_ekf.py at the large map
SHARDED_P_TOL = 1e-5
BA_POSE_TOL, BA_LM_TOL = 1e-4, 1e-3  # tests/test_parallel.py:72-77
PARALLEL_RANKS = 2
# the single-depth loops' depth (of 399 staged frames), cut to keep the run
# within its time budget: they repeat the operating point's cost with no
# landmark update (ROADMAP.md, "Checks still open")
SINGLE_FRAMES = 200


def emit(obj):
    print(json.dumps(obj), flush=True)


def render_moments(img):
    """Per image [..., H, W] (numpy or torch): its sum, sum of squares and
    first moments Σx·I, Σy·I (x the column, y the row), in RENDER_MOMENTS'
    order, in the image's dtype."""
    import numpy as np

    h, w = img.shape[-2:]
    if isinstance(img, np.ndarray):
        xs, ys = np.arange(w, dtype=img.dtype), np.arange(h, dtype=img.dtype)
    else:
        import torch

        xs = torch.arange(w, dtype=img.dtype, device=img.device)
        ys = torch.arange(h, dtype=img.dtype, device=img.device)
    return [img.sum((-2, -1)), (img * img).sum((-2, -1)),
            (img * xs).sum((-2, -1)), (img * ys[:, None]).sum((-2, -1))]


def replayed_sets(sets):
    """A tracker's source of hypothesis sets (`sets_of`) that hands out the
    given sets (numpy [calls, K, 8]) one call after another, on the mask's
    device; `left()` counts the calls not yet served."""
    import torch

    queue = list(sets)

    def sets_of(mask):
        return torch.as_tensor(queue.pop(0), dtype=torch.int64,
                               device=mask.device)

    sets_of.left = lambda: len(queue)
    return sets_of


def stop_and_go_trajectory(duration, dt=0.1):
    """The stop-and-go trajectory of tests/test_slam_stack.py:27-59, in
    numpy: the sine trajectory driven through a time warp whose rate
    1 − cos(1.5 t) reaches zero periodically, so the platform comes to
    real stops.  Returns float32 (times [K], R_ItoG [K, 3, 3], p [K, 3])."""
    import numpy as np

    n = int(duration / dt) + 8
    t = np.arange(n, dtype=np.float32) * np.float32(dt)
    w = 1.5
    s = t - np.sin(w * t) / w
    p = np.stack([2.0 * np.sin(0.6 * s), 2.0 * np.cos(0.6 * s),
                  1.0 + 0.5 * np.sin(0.9 * s)], axis=-1)
    yaw = 0.6 * s + 0.3 * np.sin(0.5 * s)
    pitch = 0.2 * np.sin(0.7 * s)
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    zero, one = np.zeros_like(t), np.ones_like(t)
    Rz = np.stack([np.stack([cy, -sy, zero], -1),
                   np.stack([sy, cy, zero], -1),
                   np.stack([zero, zero, one], -1)], -2)
    Ry = np.stack([np.stack([cp, zero, sp], -1),
                   np.stack([zero, one, zero], -1),
                   np.stack([-sp, zero, cp], -1)], -2)
    return (t, (Rz @ Ry).astype(np.float32), p.astype(np.float32))


def call_ms(fn, n_runs=200, n_warm=20):
    """Median of per-call CUDA-event times of `fn` (ms): one event pair
    around each eager call, so a short kernel reads the host's dispatch."""
    import torch

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fns, n_calls=50, n_rounds=6):
    """Device time per call (ms) of each function of `fns` (name -> fn): the
    function's n_calls calls are captured in one CUDA graph, and the graphs
    are replayed in turns (forward, then backward order) between one event
    pair each; median over n_rounds of replay time / n_calls.  Inputs stay
    in the 50 MB L2 between calls, as they do for the eager caller."""
    import torch

    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n_calls):
                fn()
        graphs[name] = graph
    names = list(graphs)
    for name in names:
        graphs[name].replay()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(n_rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[name].replay()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / n_calls)
    del graphs
    return {name: statistics.median(t) for name, t in times.items()}


def _times(row, kernel, library, plain, n_call=200, n_plain=200):
    """Device and per-call times of a kernel and its library call, the
    plain version's per-call time and the bound's share of the kernel's
    device time, into `row` (which holds bound_ms)."""
    dev = device_ms({"kernel": kernel, "library": library})
    row["device_ms"] = dev["kernel"]
    row["call_ms"] = call_ms(kernel, n_runs=n_call, n_warm=3)
    row["library_device_ms"] = dev["library"]
    row["library_call_ms"] = call_ms(library, n_runs=n_call, n_warm=3)
    row["plain_ms"] = call_ms(plain, n_runs=n_plain, n_warm=1)
    row["bound_share"] = row["bound_ms"] / row["device_ms"]


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build():
    from open_vins_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})


def _bound(n_bytes, n_ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the f32 operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def downdate_bound_ms(D, m, same, n=1):
    """Inputs read once (K = PHt counts once), output written once.  With
    K = PHt the product K·Kᵀ is symmetric and only its D(D+1)/2 upper
    entries are needed: D·(D+1)·m f32 operations; else 2·D²·m.  A batch of
    n problems does n times the work."""
    return _bound(4 * n * (D * D + (1 if same else 2) * D * m + D * D),
                  n * (D * (D + 1.0) if same else 2.0 * D * D) * m)


def qr_bound_ms(g, B, n):
    """A read once, R written once, (2·B·n² − ⅔·n³)·g f32 operations."""
    return _bound(4 * g * (B * n + n * n),
                  g * (2.0 * B * n * n - 2.0 / 3.0 * n ** 3))


def phase_downdate():
    """symmetric_downdate against its plain version at every shape."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for D, m in DOWNDATE_SHAPES + DOWNDATE_EDGE_SHAPES:
        for same in (True, False):
            A = torch.randn(D, D, device="cuda", generator=gen)
            P = (A + A.T) / 2
            K = torch.randn(D, m, device="cuda", generator=gen) / m ** 0.5
            PHt = K if same else (torch.randn(D, m, device="cuda",
                                              generator=gen) / m ** 0.5)
            out = kernels.symmetric_downdate(P, K, PHt)
            ref = kernels.symmetric_downdate_ref(P, K, PHt)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
            symmetric = bool(torch.equal(out, out.T))
            row = {"phase": "kernel", "name": "symmetric_downdate",
                   "D": D, "m": m, "K_is_PHt": same, "max_abs_err": err,
                   "tol": tol, "exactly_symmetric": symmetric}
            if not (err <= tol and symmetric and torch.isfinite(out).all()):
                emit(row)
                raise AssertionError(f"symmetric_downdate disagrees at "
                                     f"D={D}, m={m}, K_is_PHt={same}")
            if (D, m) in DOWNDATE_SHAPES:
                row["bound_ms"], row["bound_by"] = downdate_bound_ms(D, m,
                                                                     same)
                _times(row, lambda: kernels.symmetric_downdate(P, K, PHt),
                       lambda: torch.addmm(P, K, PHt.mT, alpha=-1),
                       lambda: kernels.symmetric_downdate_ref(P, K, PHt))
            emit(row)
            rows[(D, m, same)] = row
    emit({"phase": "kernel_downdate", "seconds": time.perf_counter() - t0})
    return rows


def _check_downdate(row, out, ref, P, launched):
    """The batched downdate's checks, into `row`: each matrix within
    1e-5·max(1, ‖P‖∞) of the plain version, exactly symmetric, finite, one
    launch for the whole batch."""
    import torch

    row.update(max_abs_err=(out - ref).abs().max().item() if out.numel()
               else 0.0,
               tol=1e-5 * max(1.0, P.abs().sum(dim=-1).max().item()),
               exactly_symmetric=bool(torch.equal(out, out.mT)),
               launches_per_call=launched)
    if not (row["max_abs_err"] <= row["tol"] and row["exactly_symmetric"]
            and bool(torch.isfinite(out).all()) and launched == 1):
        emit(row)
        raise AssertionError(f"batched symmetric_downdate disagrees: {row}")


def phase_downdate_batched():
    """symmetric_downdate under torch.func.vmap (the ensemble's batched
    step): one launch per batch, against the plain version at every shape,
    timed at BATCHED_SHAPES beside `torch.baddbmm(P, K, PHtᵀ, alpha=-1)`."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)
    one = torch.func.vmap(lambda p, k: kernels.symmetric_downdate(p, k, k))
    two = torch.func.vmap(kernels.symmetric_downdate)
    rows = {}
    for n, D, m in BATCHED_SHAPES + BATCHED_EDGE_SHAPES:
        for same in (True, False):
            A = torch.randn(n, D, D, device="cuda", generator=gen)
            P = (A + A.mT) / 2
            K = torch.randn(n, D, m, device="cuda", generator=gen) / m ** 0.5
            PHt = K if same else (torch.randn(n, D, m, device="cuda",
                                              generator=gen) / m ** 0.5)

            def fn(P=P, K=K, PHt=PHt, same=same):
                return one(P, K) if same else two(P, K, PHt)

            before = kernels.symmetric_downdate.launches
            out = fn()
            torch.cuda.synchronize()
            row = {"phase": "kernel", "name": "symmetric_downdate_batched",
                   "n": n, "D": D, "m": m, "K_is_PHt": same}
            _check_downdate(row, out,
                            kernels.symmetric_downdate_ref(P, K, PHt), P,
                            kernels.symmetric_downdate.launches - before)
            if (n, D, m) in BATCHED_SHAPES:
                row["bound_ms"], row["bound_by"] = downdate_bound_ms(
                    D, m, same, n)
                _times(row, fn,
                       lambda P=P, K=K, PHt=PHt: torch.baddbmm(
                           P, K, PHt.mT, alpha=-1),
                       lambda P=P, K=K, PHt=PHt:
                       kernels.symmetric_downdate_ref(P, K, PHt))
                rows[(n, D, m, same)] = row
            emit(row)
    # one P for every stream (an unbatched operand broadcast to the batch)
    P = torch.randn(270, 270, device="cuda", generator=gen)
    P = (P + P.T) / 2
    K = torch.randn(8, 270, 231, device="cuda", generator=gen) / 231 ** 0.5
    before = kernels.symmetric_downdate.launches
    out = torch.func.vmap(lambda k: kernels.symmetric_downdate(P, k, k))(K)
    torch.cuda.synchronize()
    row = {"phase": "kernel", "name": "symmetric_downdate_batched",
           "n": 8, "D": 270, "m": 231, "K_is_PHt": True, "P": "broadcast"}
    _check_downdate(row, out, kernels.symmetric_downdate_ref(P, K, K), P,
                    kernels.symmetric_downdate.launches - before)
    emit(row)
    emit({"phase": "kernel_downdate_batched",
          "seconds": time.perf_counter() - t0})
    return rows


def _qr_input(label, g_or_m, B, n, gen):
    """Row blocks [g, B, n]: the oracle's Gaussian blocks with the last 7
    rows and 5 columns zeroed, or a Gaussian stack of m rows with the joint
    stack's zero columns (IMU block, IMU-intrinsic tail) padded with zero
    rows and cut into blocks, as update_helper._tsqr_r does."""
    import torch

    if label in ("oracle", "edge"):
        A = torch.randn(g_or_m, B, n, device="cuda", generator=gen)
        A[:, -7:, :] = 0.0
        A[:, :, -5:] = 0.0
        return A
    m = g_or_m
    g = -(-m // B)
    A = torch.zeros(g * B, n, device="cuda")
    A[:m] = torch.randn(m, n, device="cuda", generator=gen)
    A[:, :15] = 0.0
    A[:, n - 25:n - 1] = 0.0
    return A.reshape(g, B, n).contiguous()


def phase_qr():
    """householder_qr_blocks against its plain version at every shape:
    RᵀR = AᵀA per block (tests/test_pallas_kernels.py's atol = rtol =
    2e-3), an exactly-zero strict lower triangle, and element-wise agreement
    with the plain version at QR_ELEMENT_TOL·max|R|."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, g_or_m, B, n in QR_SHAPES + QR_EDGE_SHAPES:
        A = _qr_input(label, g_or_m, B, n, gen)
        g = A.shape[0]
        R = kernels.householder_qr_blocks(A)
        ref = kernels.householder_qr_blocks_ref(A)
        torch.cuda.synchronize()
        err = (R - ref).abs().max().item()
        tol = QR_ELEMENT_TOL * ref.abs().max().item()
        A64, R64 = A.double(), R.double()
        G, G2 = A64.mT @ A64, R64.mT @ R64
        gram_ok = bool(((G2 - G).abs() <= 2e-3 + 2e-3 * G.abs()).all())
        tril_zero = bool((torch.tril(R, -1) == 0).all())
        row = {"phase": "kernel", "name": "householder_qr_blocks",
               "input": label, "g": g, "B": B, "n": n, "max_abs_err": err,
               "tol": tol, "gram_ok": gram_ok,
               "gram_max_abs_err": (G2 - G).abs().max().item(),
               "strict_lower_zero": tril_zero}
        if not (err <= tol and gram_ok and tril_zero
                and torch.isfinite(R).all()):
            emit(row)
            raise AssertionError(f"householder_qr_blocks disagrees at "
                                 f"{label} [g, B, n] = {[g, B, n]}")
        if label != "edge":
            row["bound_ms"], row["bound_by"] = qr_bound_ms(g, B, n)
            _times(row, lambda: kernels.householder_qr_blocks(A),
                   lambda: torch.linalg.qr(A, mode="r"),
                   lambda: kernels.householder_qr_blocks_ref(A),
                   n_call=20, n_plain=5)
            rows[(label, B, n)] = row
        emit(row)
    # the vmap rule: 8 streams' stacked blocks in one launch, against one
    # launch per stream
    A = torch.stack([_qr_input("oppoint_stack", 1174, 544, 271, gen)
                     for _ in range(8)])
    before = kernels.householder_qr_blocks.launches
    R = torch.func.vmap(kernels.householder_qr_blocks)(A)
    torch.cuda.synchronize()
    launched = kernels.householder_qr_blocks.launches - before
    per = torch.stack([kernels.householder_qr_blocks(a) for a in A])
    row = {"phase": "kernel", "name": "householder_qr_blocks",
           "input": "vmap_8_streams", "shape": list(A.shape),
           "launches_per_call": launched,
           "max_abs_err_to_per_stream": (R - per).abs().max().item(),
           "tol": QR_ELEMENT_TOL * per.abs().max().item(),
           "bit_equal": bool(torch.equal(R, per))}
    emit(row)
    if not (launched == 1 and row["max_abs_err_to_per_stream"] <= row["tol"]):
        raise AssertionError("householder_qr_blocks' vmap rule disagrees "
                             "with per-stream launches")
    emit({"phase": "kernel_qr", "seconds": time.perf_counter() - t0})
    return rows


class _CaptureDowndates:
    """Within the block, record the (P, K, PHt) operands of every
    `symmetric_downdate` that `core.ekf` calls (copies; the call itself
    goes through)."""

    def __enter__(self):
        from open_vins_tpu_torch.core import ekf

        self.calls, self._ekf = [], ekf
        self._fn = ekf.symmetric_downdate

        def record(P, K, PHt):
            self.calls.append((P.clone(), K.clone(), PHt.clone(),
                               K.data_ptr() == PHt.data_ptr()))
            return self._fn(P, K, PHt)

        ekf.symmetric_downdate = record
        return self

    def __exit__(self, *exc):
        self._ekf.symmetric_downdate = self._fn


def _form_operands(state, cfg, H, res, before, frame):
    """The downdate operands of the push-through forms on one real joint
    stack H, res (`state`: the frame's pre-update state), and of a real
    ZUPT attempt on the frame's IMU window from `before`, the state before
    the frame: name -> (P, K, PHt)."""
    from open_vins_tpu_torch.core import ekf
    from open_vins_tpu_torch.models import updater_zupt as zupt

    ranges = cfg.slam_meas_support_ranges
    ops = {}
    with _CaptureDowndates() as cap:
        ekf.ekf_update_info(state, cfg, H, res, ranges)
        ekf.ekf_update_spd(state, cfg, H, res, ranges)
    (P, K, PHt, same), (P2, K2, PHt2, same2) = cap.calls
    assert not same and not same2
    ops["info_newton"] = (P, K, PHt)  # (P_cols, Wᵀ): woodbury and newton
    ops["spd"] = (P2, K2, PHt2)  # (P_cols·W, P_cols)
    with _CaptureDowndates() as cap:
        zupt.try_zupt(before, cfg, frame.win, frame.t_new,
                      before.cov.new_zeros(()))
    P3, K3, PHt3, same3 = cap.calls[0]
    assert not same3
    ops["zupt"] = (P3, K3, PHt3)
    return ops


def phase_downdate_forms(operands):
    """symmetric_downdate with K ≠ PHt on the real operands of the
    woodbury / newton downdate (P_cols, Wᵀ), the spd one (P_cols·W, P_cols)
    and the ZUPT's (P_cols, Wᵀ) at m = 9, against its plain version, timed
    beside `torch.addmm(P, K, PHtᵀ, alpha=-1)`."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    rows = {}
    for name, (P, K, PHt) in operands.items():
        D, m = K.shape
        out = kernels.symmetric_downdate(P, K, PHt)
        ref = kernels.symmetric_downdate_ref(P, K, PHt)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
        row = {"phase": "kernel", "name": "symmetric_downdate",
               "operands": name, "D": D, "m": m, "K_is_PHt": False,
               "max_abs_err": err, "tol": tol,
               "exactly_symmetric": bool(torch.equal(out, out.T))}
        if not (err <= tol and row["exactly_symmetric"]
                and torch.isfinite(out).all()):
            emit(row)
            raise AssertionError(f"symmetric_downdate disagrees on the "
                                 f"{name} operands")
        row["bound_ms"], row["bound_by"] = downdate_bound_ms(D, m, False)
        _times(row, lambda: kernels.symmetric_downdate(P, K, PHt),
               lambda: torch.addmm(P, K, PHt.mT, alpha=-1),
               lambda: kernels.symmetric_downdate_ref(P, K, PHt))
        emit(row)
        rows[name] = row
    emit({"phase": "kernel_downdate_forms",
          "seconds": time.perf_counter() - t0})
    return rows


def _prefix(run, n, streams=False):
    """The first n frames of a staged run (of every stream of a run stacked
    over streams)."""
    import torch.utils._pytree as pytree

    from open_vins_tpu_torch.models import runner

    def cut(a, m):
        return a[:, :m] if streams else a[:m]

    return runner.SimRun(frames=pytree.tree_map(lambda a: cut(a, n),
                                                run.frames),
                         gt_q=cut(run.gt_q, n + 1), gt_p=cut(run.gt_p, n + 1),
                         gt_v=cut(run.gt_v, n + 1))


def _drive(name, cfg, run, calib, ref, max_tracks):
    """One timed `runner.run_filter` pass with the launch counts set to 0
    just before it and read just after: (row of numbers, outputs, final
    state); `symmetric_downdate` must launch at least once per frame."""
    import torch

    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels

    n_frames = run.frames.t_new.shape[0]
    kernels.symmetric_downdate.launches = 0
    kernels.householder_qr_blocks.launches = 0
    t0 = time.perf_counter()
    state, outs = runner.run_filter(cfg, tri.TriangulationOptions(), calib,
                                    run, max_tracks=max_tracks,
                                    device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"symmetric_downdate": kernels.symmetric_downdate.launches,
                "householder_qr_blocks":
                    kernels.householder_qr_blocks.launches}

    qs, ps, _, covs6, diag = outs
    rmse, nees = runner.pose_metrics(qs, ps, covs6, run.gt_q, run.gt_p)
    gap = float((ps.cpu() - torch.as_tensor(ref["ref_p"])).norm(dim=1).max())
    row = {"phase": name, "frames": n_frames, "state_dim": cfg.state_dim,
           "frames_per_s": n_frames / seconds, "seconds": seconds,
           "rmse_m": rmse, "nees": nees,
           "finite": bool(torch.isfinite(state.cov).all().item()),
           "jax_rmse_m": ref["ref_rmse"], "jax_nees": ref["ref_nees"],
           "max_position_gap_to_jax_m": gap,
           "n_msckf_mean": float(diag.n_msckf.float().mean()),
           "n_slam_mean": float(diag.n_slam.float().mean()),
           "n_slam_used_mean": float(diag.n_slam_used.float().mean()),
           "launches": launches}
    if launches["symmetric_downdate"] < n_frames:
        emit(row)
        raise AssertionError(f"{name}: symmetric_downdate launched "
                             f"{launches['symmetric_downdate']} times over "
                             f"{n_frames} frames")
    return row, outs, state


def _closed_loop(name, cfg, run, calib, ref, max_tracks):
    """`_drive`, then the health gate and the JAX check."""
    row, _, _ = _drive(name, cfg, run, calib, ref, max_tracks)
    emit(row)
    rmse, nees = row["rmse_m"], row["nees"]
    if not (row["finite"] and rmse < RMSE_GATE_M and 0.2 < nees < 30.0):
        raise AssertionError(f"{name}: health gate failed")
    if abs(rmse - ref["ref_rmse"]) > REF_RMSE_SPREAD_M:
        raise AssertionError(f"{name}: RMSE {rmse} is more than "
                             f"{REF_RMSE_SPREAD_M} m from the JAX run's "
                             f"{ref['ref_rmse']}")
    return row


def phase_msckf_path(run, calib, ref):
    """The MSCKF-only closed loop, after a short warm-up prefix (cuBLAS /
    cuSOLVER handles, the allocator)."""
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri

    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    t0 = time.perf_counter()
    runner.run_filter(cfg, tri.TriangulationOptions(), calib,
                      _prefix(run, MSCKF_WARM_FRAMES),
                      max_tracks=meta["max_tracks"], device="cuda")
    warm_s = time.perf_counter() - t0
    row = _closed_loop("main_path_msckf", cfg, run, calib, ref,
                       meta["max_tracks"])
    emit({"phase": "main_path_msckf_total",
          "seconds": warm_s + row["seconds"], "warm_up_seconds": warm_s})
    return row


def _tsqr_check(state, cfg, H, res):
    """compress_system (TSQR) against compress_system_ranges on one stack:
    tests/test_compress.py's information check (HᵀH at atol 2e-2, rtol
    1e-3; Hᵀres at atol 5e-3, rtol 1e-3) and update check (ekf_update both
    ways: p within 2e-4, cov within 2e-3).  The information check reads the
    information of the stack with unit-norm columns, G_ij / √(G⁰_ii G⁰_jj)
    with G⁰ = [H | res]ᵀ[H | res] of the raw stack: a real stack's Gram
    entries reach 1e7 (pixel rows over depths of metres), and f32 holds them
    only to about 1e-7 of √(G_ii G_jj); compression commutes with column
    scaling, so the normalized check is the test's own on a well-scaled
    stack.  Returns the row of numbers."""
    import torch

    from open_vins_tpu_torch.core import ekf
    from open_vins_tpu_torch.models import update_helper as uh
    from open_vins_tpu_torch.ops import kernels

    D = cfg.state_dim
    ranges = cfg.slam_meas_support_ranges
    before = kernels.householder_qr_blocks.launches
    Hq, rq = uh.compress_system(H, res, D)
    launches = kernels.householder_qr_blocks.launches - before
    Hr, rr = uh.compress_system_ranges(H, res, ranges, D)
    s_q = ekf.ekf_update(state, cfg, Hq, rq, torch.ones_like(rq))
    s_r = ekf.ekf_update(state, cfg, Hr, rr, torch.ones_like(rr),
                         ranges=ranges)

    A0 = torch.cat([H, res[:, None]], dim=1).double()
    g0 = (A0 * A0).sum(dim=0)
    scale = torch.where(g0 > 0, g0.rsqrt(), 0.0)  # unit-norm columns
    sH, sr = scale[:D], scale[D]

    def info(Hc, rc):
        Hs = Hc.double() * sH
        return Hs.T @ Hs, Hs.T @ (rc.double() * sr)

    (GH_q, Gr_q), (GH_r, Gr_r) = info(Hq, rq), info(Hr, rr)

    def excess(a, b, atol, rtol):
        """max of |a − b| − (atol + rtol·|b|): ≤ 0 passes."""
        return ((a - b).abs() - (atol + rtol * b.abs())).max().item()

    return {
        "rows": H.shape[0], "cols": D + 1, "qr_launches": launches,
        "info_HtH_excess": excess(GH_q, GH_r, 2e-2, 1e-3),
        "info_Htres_excess": excess(Gr_q, Gr_r, 5e-3, 1e-3),
        "info_HtH_max_abs_err": (GH_q - GH_r).abs().max().item(),
        "info_Htres_max_abs_err": (Gr_q - Gr_r).abs().max().item(),
        "update_p_gap": (s_q.p - s_r.p).abs().max().item(),
        "update_cov_gap": (s_q.cov - s_r.cov).abs().max().item(),
        "finite": bool(torch.isfinite(Hq).all() and torch.isfinite(rq).all()),
    }


def phase_tsqr(run, calib, ref):
    """The operating point stepped to the last of TSQR_FRAMES; at each of
    them the joint stack from the frame's pre-update state goes through
    the TSQR compression and is held against compress_system_ranges."""
    import torch

    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import feature_table as ft
    from open_vins_tpu_torch.models import manager, runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels, lie

    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    opts = tri.TriangulationOptions()
    t0 = time.perf_counter()
    state = manager.initialize_from_gt(
        cfg, run.gt_q[0], run.gt_p[0], run.gt_v[0], calib.bias_g0,
        calib.bias_a0, 0.0, calib_ext_q=lie.rot_2_quat(calib.cam_R_ItoC),
        calib_ext_p=calib.cam_p_IinC, calib_intr=calib.cam_intr)
    table = ft.init_table(cfg, meta["max_tracks"], "cuda")
    kernels.householder_qr_blocks.launches = 0
    checks, operands = [], None
    for k in range(max(TSQR_FRAMES) + 1):
        frame = runner.frame_at(run.frames, k)
        if k in TSQR_FRAMES:
            st, tb, reserved = manager.pre_update(state, table, cfg, frame)
            st, _, H, res, _, _ = manager.build_joint_system(
                st, cfg, tb, opts, reserved)
            row = _tsqr_check(st, cfg, H, res)
            row.update(frame=k, n_slam=int(st.slam_valid.sum()))
            checks.append(row)
            emit({"phase": "tsqr_stack", **row})
            if k == FORMS_CAPTURE_FRAME:
                operands = _form_operands(st, cfg, H, res, state, frame)
        state, table, _ = manager.step_frame(state, table, cfg, opts, frame)
    torch.cuda.synchronize()
    launches = kernels.householder_qr_blocks.launches
    emit({"phase": "tsqr", "seconds": time.perf_counter() - t0,
          "frames": TSQR_FRAMES, "launches": launches})
    for row in checks:
        ok = (row["finite"] and row["qr_launches"] == 1
              and row["rows"] >= 4 * row["cols"] and row["n_slam"] > 0
              and row["info_HtH_excess"] <= 0
              and row["info_Htres_excess"] <= 0
              and row["update_p_gap"] <= 2e-4
              and row["update_cov_gap"] <= 2e-3)
        if not ok:
            raise AssertionError(f"TSQR check failed at frame {row['frame']}:"
                                 f" {row}")
    return launches, operands


def phase_oppoint_path(run, calib):
    """The operating point's closed loop (phase_tsqr ran its first frames
    before, so the code path is warm)."""
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig

    ref = convert.load_reference(OPPOINT_REF)
    meta = ref["meta"]
    row = _closed_loop("main_path_oppoint", FilterConfig(**meta["cfg"]), run,
                       calib, ref, meta["max_tracks"])
    if not row["n_slam_mean"] > 0:
        raise AssertionError("SLAM did not engage on the operating point")
    return row


def _check_staging(name, seconds, params, run, want, sim_of):
    """Hold one stream staged on the card against the digest `want` of the
    port's CPU staging of the same draws: ids and masks equal but for at
    most STAGING_FLIPS_MAX entries, each explained by a map point at the
    image border or the depth gate (`sim_of()` gives the stream's
    simulator, for those margins), pixels within STAGING_UV_TOL_PX,
    groundtruth within STAGING_GT_TOL."""
    import numpy as np

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.sim import simulator

    dig = convert.staging_digest(run)
    flips, unexplained, uv_err = 0, [], 0.0
    for i, k in enumerate(want["frames"]):
        for c in range(params.num_cams):
            got_ids = set(dig["ids"][i, c][dig["mask"][i, c]].tolist())
            ref_ids = set(want["ids"][i, c][want["mask"][i, c]].tolist())
            diff = sorted(got_ids ^ ref_ids)
            same = ((dig["ids"][i, c] == want["ids"][i, c])
                    & dig["mask"][i, c] & want["mask"][i, c])
            uv_err = max(uv_err, float(np.abs(
                dig["uv"][i, c][same] - want["uv"][i, c][same]).max(
                    initial=0.0)))
            if not diff:
                continue
            flips += len(diff)
            edge, depth = simulator.view_margins(sim_of(), params, int(k) + 1,
                                                 c)
            at_gate = (edge[diff] < GATE_NEAR_PX) | (depth[diff]
                                                     < GATE_NEAR_M)
            if not bool(at_gate.any()):
                unexplained.append((int(k), c, diff))
    row = {"phase": "sim_staging", "stream": name, "seconds": seconds,
           "frames": int(run.frames.t_new.shape[0]),
           "map_size": params.map_size, "num_pts": params.num_pts,
           "id_flips": flips, "unexplained_flips": unexplained,
           "uv_max_abs_err_px": uv_err,
           "gt_p_max_abs_err_m": float(np.abs(
               dig["gt_p"] - want["gt_p"]).max()),
           "gt_q_max_abs_err": float(np.abs(
               dig["gt_q"] - want["gt_q"]).max())}
    emit(row)
    ok = (flips <= STAGING_FLIPS_MAX and not unexplained
          and uv_err <= STAGING_UV_TOL_PX
          and row["gt_p_max_abs_err_m"] <= STAGING_GT_TOL
          and row["gt_q_max_abs_err"] <= STAGING_GT_TOL)
    if not ok:
        raise AssertionError(f"sim_staging {name}: the card's staging "
                             "disagrees with the CPU staging")


def _digest_of(ref, b=None):
    """The staging digest in a reference (stream b of an ensemble's)."""
    return {k[len("digest_"):]: (v if b is None else v[b])
            for k, v in ref.items() if k.startswith("digest_")}


def phase_sim_staging(refs):
    """Stage each stream on the card and hold it against the digest of the
    port's CPU staging of the same draws.  Returns {name: (sim, params,
    run, calib)}."""
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.models import runner

    staged = {}
    for name, ref in refs.items():
        t0 = time.perf_counter()
        sim, params, run = convert.stage_stream(ref["meta"], "cuda")
        torch.cuda.synchronize()
        _check_staging(name, time.perf_counter() - t0, params, run,
                       _digest_of(ref), lambda sim=sim: sim)
        staged[name] = (sim, params, run, runner.sim_calib(sim))
    return staged


def phase_largemap(staged, ref):
    """bench.py's large-map point through `runner.run_filter`."""
    from open_vins_tpu_torch.core.layout import FilterConfig

    meta = ref["meta"]
    _, _, run, calib = staged
    row = _closed_loop("main_path_largemap", FilterConfig(**meta["cfg"]),
                       run, calib, ref, meta["max_tracks"])
    if not row["n_slam_mean"] > 0:
        raise AssertionError("SLAM did not engage on the large map")
    return row


def _replay_metrics(qs, ps, covs6, n_slam, run):
    """tests/test_corpus_replay.py's numbers with the port's eval copies:
    posyaw ATE (position m, orientation degrees), the mean pose NEES and
    the mean landmark count over the last three quarters."""
    from open_vins_tpu_torch.eval import metrics
    from open_vins_tpu_torch.ops import lie

    ps = ps.cpu().double().numpy()
    R_est = lie.quat_2_rot(qs.cpu()).double().numpy()
    R_gt = lie.quat_2_rot(run.gt_q[1:].cpu()).double().numpy()
    gt_p = run.gt_p[1:].cpu().double().numpy()
    ori, pos = metrics.ate(ps, R_est.transpose(0, 2, 1), gt_p,
                           R_gt.transpose(0, 2, 1), method="posyaw")
    n = len(gt_p)
    sl = slice(n // 4, n)
    _, _, full = metrics.nees(ps[sl], R_est[sl], gt_p[sl], R_gt[sl],
                              covs6.cpu().double().numpy()[sl])
    return pos.rmse, ori.rmse, full.mean, float(n_slam[n // 4:].float().mean())


def init_replay_metrics(qs, ps, covs6, gt_q, gt_p, k0):
    """The numbers of a replay started from the filter's own init at frame
    k0 (outputs k0.. against groundtruth k0+1..): posyaw ATE (position m,
    orientation degrees), and the mean pose NEES over the last three
    quarters of those frames after the same posyaw alignment — the init
    fixes its own yaw and origin, so the unaligned error is the gauge, not
    the filter's (the position block of each covariance is rotated by the
    alignment's yaw; the JPL δθ is a body-frame error and stays).  Inputs
    are numpy arrays or CPU tensors."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.eval import alignment, metrics
    from open_vins_tpu_torch.ops import lie

    def arr(x):
        return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                          dtype=np.float64)

    qs, ps, covs6 = arr(qs)[k0:], arr(ps)[k0:], arr(covs6)[k0:]
    gt_q, gt_p = arr(gt_q)[1:][k0:], arr(gt_p)[1:][k0:]
    R_est = lie.quat_2_rot(torch.from_numpy(qs)).numpy()
    R_gt = lie.quat_2_rot(torch.from_numpy(gt_q)).numpy()
    ori, pos = metrics.ate(ps, R_est.transpose(0, 2, 1), gt_p,
                           R_gt.transpose(0, 2, 1), method="posyaw")
    s, R, t = alignment.align_trajectory(ps, gt_p, "posyaw")
    p_a, R_a = alignment.apply_alignment(ps, R_est.transpose(0, 2, 1), s, R,
                                         t)
    T = np.eye(6)
    T[3:, 3:] = R
    covs_a = T @ covs6 @ T.T
    n = len(ps)
    sl = slice(n // 4, n)
    _, _, full = metrics.nees(p_a[sl], R_a[sl].transpose(0, 2, 1), gt_p[sl],
                              R_gt[sl], covs_a[sl])
    return pos.rmse, ori.rmse, full.mean


def phase_v102_replay(staged, ref):
    """The V1_02 replay through `runner.run_filter`, with the corpus
    replay's gates, then `run_filter_from` from the groundtruth state."""
    import torch

    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import manager, runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import lie

    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    _, _, run, calib = staged
    row, outs, _ = _drive("main_path_v102_replay", cfg, run, calib, ref,
                          meta["max_tracks"])
    qs, ps, _, covs6, diag = outs
    ate_p, ate_o, nees, n_slam = _replay_metrics(qs, ps, covs6, diag.n_slam,
                                                 run)
    row.update(ate_pos_m=ate_p, ate_ori_deg=ate_o, nees_full=nees,
               n_slam_last3q_mean=n_slam,
               jax_ate_pos_m=float(ref["ref_ate_pos_m"]),
               jax_ate_ori_deg=float(ref["ref_ate_ori_deg"]),
               jax_nees_full=float(ref["ref_nees_full"]))
    emit(row)
    ok = (row["finite"] and ate_p < REPLAY_ATE_POS_M
          and ate_o < REPLAY_ATE_ORI_DEG and REPLAY_NEES[0] < nees
          < REPLAY_NEES[1] and n_slam > REPLAY_MIN_SLAM
          and abs(ate_p - row["jax_ate_pos_m"]) <= REF_RMSE_SPREAD_M)
    if not ok:
        raise AssertionError("main_path_v102_replay: a replay gate failed")

    # run_filter_from: the groundtruth state at frame K0, the first
    # RUN_FROM_FRAMES frames (tests/test_corpus_replay.py:91-115)
    k0, n = RUN_FROM_K0, RUN_FROM_FRAMES
    state0 = manager.initialize_from_gt(
        cfg, run.gt_q[k0], run.gt_p[k0], run.gt_v[k0], calib.bias_g0,
        calib.bias_a0, float(run.frames.t_new[k0 - 1]),
        calib_ext_q=lie.rot_2_quat(calib.cam_R_ItoC),
        calib_ext_p=calib.cam_p_IinC, calib_intr=calib.cam_intr)
    t0 = time.perf_counter()
    st, fouts = runner.run_filter_from(cfg, tri.TriangulationOptions(),
                                       _prefix(run, n), state0, k0,
                                       max_tracks=meta["max_tracks"],
                                       device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = fouts[1][k0:] - run.gt_p[1:n + 1][k0:]
    rmse = float(err.norm(dim=1).pow(2).mean().sqrt())
    finite = bool(torch.isfinite(st.cov).all().item())
    emit({"phase": "run_filter_from", "k0": k0, "frames": n,
          "seconds": seconds, "rmse_m": rmse, "finite": finite})
    if not (finite and rmse < RUN_FROM_RMSE_M):
        raise AssertionError(f"run_filter_from: RMSE {rmse} m")
    return row


def _ensemble_step_check(cfg, opts, calibs, runs, max_tracks,
                         tols=(1e-5, 5e-5), phase="ensemble8_step_check"):
    """The batch stepped to ENSEMBLE_CHECK_FRAME, then once more from its
    state; each stream against its own `step_frame` from the same state:
    covariance within tols[0]·‖P‖∞ (tols[1] in a step that initializes a
    landmark; 1e-5 and 5e-5 are the repo's SLAM rule), the window full."""
    from open_vins_tpu_torch.models import manager, runner

    state, table = runner.ensemble_start(cfg, calibs, runs, max_tracks)
    step = runner.ensemble_step(cfg, opts)
    for k in range(ENSEMBLE_CHECK_FRAME):
        state, table, _ = step(state, table, runner.ensemble_frame(runs, k))
    frame = runner.ensemble_frame(runs, ENSEMBLE_CHECK_FRAME)
    post, _, _ = step(state, table, frame)
    streams = []
    for b in range(runs.gt_p.shape[0]):
        pre = runner.record_at(state, b)
        one, _, _ = manager.step_frame(pre, runner.record_at(table, b), cfg,
                                       opts, runner.record_at(frame, b))
        init = bool((one.slam_valid & ~pre.slam_valid).any())
        norm = one.cov.abs().sum(dim=1).max().item()
        streams.append({
            "stream": b, "window_full": int(pre.n_clones) == cfg.max_clones,
            "init_step": init, "tol": tols[1] if init else tols[0],
            "cov_gap_rel_norm_inf":
                (post.cov[b] - one.cov).abs().max().item() / norm,
            "p_gap_m": (post.p[b] - one.p).abs().max().item(),
            "n_slam": int(one.slam_valid.sum())})
    emit({"phase": phase, "frame": ENSEMBLE_CHECK_FRAME, "streams": streams})
    for r in streams:
        if not (r["window_full"] and r["cov_gap_rel_norm_inf"] <= r["tol"]):
            raise AssertionError(f"ensemble step check failed: {r}")


def phase_ensemble8(ref):
    """bench.py's 8-seed ensemble through `runner.run_ensemble` (the
    module docstring's phase 10)."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels
    from open_vins_tpu_torch.sim import simulator

    meta = ref["meta"]
    params = simulator.SimParams(**meta["sim"])
    cfg, opts = FilterConfig(**meta["cfg"]), tri.TriangulationOptions()
    seeds, max_tracks = meta["seeds"], meta["max_tracks"]
    t0 = time.perf_counter()
    calibs, runs = runner.stage_ensemble(params, seeds, "cuda")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    for b, seed in enumerate(seeds):
        _check_staging(
            f"ensemble8_seed{seed}", stage_s / len(seeds), params,
            runner.record_at(runs, b), _digest_of(ref, b),
            lambda seed=seed: simulator.build(
                params, seed=seed, draws=simulator.draw(params, seed),
                device="cuda"))

    t0 = time.perf_counter()
    runner.run_ensemble(cfg, opts, calibs,
                        _prefix(runs, ENSEMBLE_WARM_FRAMES, streams=True),
                        max_tracks=max_tracks, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    B, n_frames = len(seeds), runs.frames.t_new.shape[1]
    kernels.symmetric_downdate.launches = 0
    kernels.householder_qr_blocks.launches = 0
    t0 = time.perf_counter()
    state, outs = runner.run_ensemble(cfg, opts, calibs, runs,
                                      max_tracks=max_tracks, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"symmetric_downdate": kernels.symmetric_downdate.launches,
                "householder_qr_blocks":
                    kernels.householder_qr_blocks.launches}
    m = runner.ensemble_metrics(outs, runs)
    diag = outs[4]
    jax_rmse, jax_nees = np.asarray(ref["ref_rmse"]), np.asarray(
        ref["ref_nees"])
    row = {"phase": "main_path_ensemble8", "streams": B, "seeds": seeds,
           "frames": n_frames, "state_dim": cfg.state_dim,
           "seconds": seconds, "warm_up_seconds": warm_s,
           "agg_frames_per_s": B * n_frames / seconds,
           "rmse_m": m["rmse"].tolist(), "rmse_median_m": m["rmse_median"],
           "nees": m["nees"].tolist(),
           "nees_seed_mean": m["nees_seed_mean"],
           "nees_seed_std": m["nees_seed_std"],
           "jax_rmse_m": jax_rmse.tolist(), "jax_nees": jax_nees.tolist(),
           "jax_nees_seed_mean": float(ref["ref_nees_seed_mean"]),
           "jax_nees_seed_std": float(ref["ref_nees_seed_std"]),
           "max_rmse_gap_to_jax_m": float(np.abs(m["rmse"] - jax_rmse).max()),
           "n_slam_mean": diag.n_slam.float().mean(dim=1).tolist(),
           "jax_n_slam_mean": ref["ref_n_slam_mean"].tolist(),
           "n_msckf_mean": diag.n_msckf.float().mean(dim=1).tolist(),
           "finite": [bool(torch.isfinite(c).all()) for c in state.cov],
           "launches": launches}
    emit(row)
    jax_mean = row["jax_nees_seed_mean"]
    ok = (all(row["finite"]) and m["rmse_median"] < RMSE_GATE_M
          and row["max_rmse_gap_to_jax_m"] <= REF_RMSE_SPREAD_M
          and 0.2 < m["nees_seed_mean"] < 30.0
          and abs(m["nees_seed_mean"] - jax_mean)
          <= ENSEMBLE_NEES_SPREAD * jax_mean
          and launches["symmetric_downdate"] == n_frames
          and min(row["n_slam_mean"]) > 0)
    if not ok:
        raise AssertionError("main_path_ensemble8: a gate failed")
    _ensemble_step_check(cfg, opts, calibs, runs, max_tracks)
    return row, calibs, runs


def phase_newton_zupt_ensemble(ref, calibs, runs):
    """The vmapped step in the newton joint form with ZUPT (direct, the
    default gates) on the ensemble's 8 streams for NEWTON_ZUPT_FRAMES
    frames through `runner.run_ensemble`: every batched frame launches the
    batched K ≠ PHt downdate twice (the ZUPT attempt's at m = 9, the newton
    update's) and runs the masked polish sweeps; every covariance finite,
    every newton residual under the no-op gate; then each stream against
    its own single-stream step at ENSEMBLE_CHECK_FRAME (NEWTON_STEP_TOL,
    NEWTON_INIT_STEP_TOL)."""
    import torch

    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels

    meta = ref["meta"]
    cfg = FilterConfig(**dict(meta["cfg"], joint_update_form="newton",
                              use_zupt=True))
    opts, n = tri.TriangulationOptions(), NEWTON_ZUPT_FRAMES
    part = _prefix(runs, n, streams=True)
    kernels.symmetric_downdate.launches = 0
    kernels.householder_qr_blocks.launches = 0
    t0 = time.perf_counter()
    state, outs = runner.run_ensemble(cfg, opts, calibs, part,
                                      max_tracks=meta["max_tracks"],
                                      device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.symmetric_downdate.launches
    diag = outs[4]
    row = {"phase": "main_path_ensemble8_newton_zupt",
           "streams": len(meta["seeds"]), "frames": n, "seconds": seconds,
           "agg_frames_per_s": len(meta["seeds"]) * n / seconds,
           "launches": {"symmetric_downdate": launches},
           "finite": [bool(torch.isfinite(c).all()) for c in state.cov],
           "newton_resid_max": float(diag.newton_resid.max()),
           "n_slam_last": diag.n_slam[:, -1].tolist()}
    emit(row)
    if not (all(row["finite"]) and launches == 2 * n
            and row["newton_resid_max"] < NEWTON_NOOP_TOL
            and min(row["n_slam_last"]) > 0):
        raise AssertionError("main_path_ensemble8_newton_zupt: a gate "
                             "failed")
    _ensemble_step_check(cfg, opts, calibs, runs, meta["max_tracks"],
                         (NEWTON_STEP_TOL, NEWTON_INIT_STEP_TOL),
                         "ensemble8_newton_zupt_step_check")
    return row


def _loop_gates(name, row, ref):
    """The health gate and the JAX checks of a loop: finite covariance,
    RMSE < 0.05 m and within 0.01 m of the JAX run, NEES in 0.2-30 and
    within NEES_SPREAD of the JAX run's, landmarks in use."""
    _jax_gates(name, row, ref)
    ok = (row["rmse_m"] < RMSE_GATE_M and 0.2 < row["nees"] < 30.0
          and row["n_slam_mean"] > 0)
    if not ok:
        raise AssertionError(f"{name}: a gate failed: {row}")


def phase_forms_path(run, calib):
    """The operating point in the woodbury, spd and newton joint forms
    over the staged frames, each against the JAX run of its form: one
    downdate launch per frame (K ≠ PHt), and the newton solve's residual
    under its no-op gate on every frame."""
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig

    rows = {}
    for form, path in FORM_REFS.items():
        ref = convert.load_reference(path)
        meta = ref["meta"]
        name = f"main_path_{form}"
        row, outs, _ = _drive(name, FilterConfig(**meta["cfg"]), run, calib,
                              ref, meta["max_tracks"])
        row["jax_n_slam_mean"] = float(ref["ref_n_slam"].mean())
        if form == "newton":
            row["newton_resid_max"] = float(outs[4].newton_resid.max())
            row["jax_newton_resid_max"] = float(
                ref["ref_newton_resid"].max())
        emit(row)
        _loop_gates(name, row, ref)
        if row["launches"]["symmetric_downdate"] != row["frames"]:
            raise AssertionError(f"{name}: one downdate per frame expected")
        if form == "newton" and not (row["newton_resid_max"]
                                     < NEWTON_NOOP_TOL):
            raise AssertionError("main_path_newton: the solve's residual "
                                 "reached the no-op gate")
        rows[form] = row
    return rows


def phase_sequential_path(run, calib):
    """The operating point in the reference-exact sequential ordering
    (MSCKF update, SLAM update, delayed init with its leftover update, each
    its own downdate) against the JAX run of the same ordering."""
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig

    ref = convert.load_reference(SEQUENTIAL_REF)
    meta = ref["meta"]
    row, _, _ = _drive("main_path_sequential", FilterConfig(**meta["cfg"]),
                       run, calib, ref, meta["max_tracks"])
    row["downdates_per_frame"] = (row["launches"]["symmetric_downdate"]
                                  / row["frames"])
    emit(row)
    _loop_gates("main_path_sequential", row, ref)
    if row["launches"]["symmetric_downdate"] < 2 * row["frames"]:
        raise AssertionError("main_path_sequential: the MSCKF and the SLAM "
                             "update must each launch a downdate per frame")
    return row


def _zupt_frames(diag):
    """Frames consumed by a ZUPT from ZUPT_FIRST_FRAME on: no MSCKF
    feature and no landmark used (tests/test_slam_stack.py:120-124)."""
    n_msckf = diag.n_msckf[ZUPT_FIRST_FRAME:]
    used = diag.n_slam_used[ZUPT_FIRST_FRAME:]
    return int(((n_msckf == 0) & (used == 0)).sum())


def phase_zupt_path(ref):
    """The operating point's widths with ZUPT over 20 s of the stop-and-go
    trajectory: staged on the card by the port's simulator (held against
    the CPU staging's digest), then the closed loop against the JAX run on
    the CPU staging, with at least ZUPT_MIN_FRAMES ZUPT frames and a count
    within ZUPT_COUNT_SPREAD of the JAX run's."""
    import numpy as np
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner

    meta = ref["meta"]
    sim_kw = meta["sim"]
    traj = tuple(torch.as_tensor(a, device="cuda")
                 for a in stop_and_go_trajectory(
                     sim_kw["duration"] + 2.0 * sim_kw["start_offset"] + 2.0,
                     **meta["traj"]["stop_and_go"]))
    t0 = time.perf_counter()
    sim, params, run = convert.stage_stream(meta, "cuda", traj=traj)
    torch.cuda.synchronize()
    _check_staging("zupt_stopgo", time.perf_counter() - t0, params, run,
                   _digest_of(ref), lambda: sim)
    row, outs, _ = _drive("main_path_zupt", FilterConfig(**meta["cfg"]), run,
                          runner.sim_calib(sim), ref, meta["max_tracks"])
    diag = outs[4]
    jax_n = int(((np.asarray(ref["ref_n_msckf"])[ZUPT_FIRST_FRAME:] == 0)
                 & (np.asarray(ref["ref_n_slam_used"])[ZUPT_FIRST_FRAME:]
                    == 0)).sum())
    row.update(zupt_frames=_zupt_frames(diag), jax_zupt_frames=jax_n,
               jax_n_slam_mean=float(ref["ref_n_slam"].mean()))
    emit(row)
    _loop_gates("main_path_zupt", row, ref)
    if not (row["zupt_frames"] >= ZUPT_MIN_FRAMES
            and abs(row["zupt_frames"] - jax_n) <= ZUPT_COUNT_SPREAD * jax_n):
        raise AssertionError(f"main_path_zupt: {row['zupt_frames']} ZUPT "
                             f"frames against JAX's {jax_n}")
    return row


def _metric(name, value, unit, smi):
    """One bench.py-style metric line with the card's name and power
    limit."""
    emit({"metric": name, "value": value, "unit": unit, "nvidia_smi": smi})


def phase_sim_staging_rendered(ref):
    """Stage bench.py's rendered stream (752x480 stereo, 2,048 map points,
    8 s) on the card and hold it against the CPU staging's digest."""
    import torch

    from open_vins_tpu_torch import convert

    t0 = time.perf_counter()
    sim, params, run = convert.stage_stream(ref["meta"], "cuda")
    torch.cuda.synchronize()
    _check_staging("rendered_stereo", time.perf_counter() - t0, params, run,
                   _digest_of(ref), lambda: sim)
    return sim, params, run


def phase_render(sim, params, ref, smi):
    """Every frame of both cameras rendered on the card in one batched
    call (`runner.render_frames`), held per frame against JAX's
    `render_frame` moments on the CPU staging; returns the images."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.models import runner

    n = ref["ref_render_sum"].shape[0]
    runner.render_frames(sim, params, 2, device="cuda")  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        imgs = runner.render_frames(sim, params, n, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = [m.cpu().numpy() for m in render_moments(imgs.double())]
    errs = {m: float(np.abs(g / ref[f"ref_render_{m}"] - 1.0).max())
            for m, g in zip(RENDER_MOMENTS, got)}
    err = max(errs.values())
    ms = 1e3 * statistics.median(times) / n
    row = {"phase": "render", "frames": n, "cams": params.num_cams,
           "shape": list(imgs.shape), "seconds": times,
           "ms_per_frame": ms, "moments_max_rel_err": errs,
           "finite": bool(torch.isfinite(imgs).all())}
    emit(row)
    _metric("frontend_render_ms_per_frame", ms,
            f"ms/frame ({params.width}x{params.height} stereo sprite "
            f"render, {params.map_size} pts, {n} frames in one call)", smi)
    if not (row["finite"] and err <= RENDER_SUM_RTOL):
        raise AssertionError(f"render: image moments {errs} from JAX's")
    return imgs


def _tracker_launches(imgs, sim, params, kp, n):
    """(GPU kernels per frame, host ms per frame) of the tracker over n
    frames under torch.profiler."""
    import torch

    from open_vins_tpu_torch.frontend import ransac
    from open_vins_tpu_torch.models import runner

    sets_of = ransac.sampler(torch.Generator(device="cuda").manual_seed(0))
    tstate = runner.start_tracker(sim.cam_intr, params, kp, "STRETCH",
                                  sets_of, imgs[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(1, n + 1):
            tstate, *_ = runner.track_images(tstate, imgs[k], sim.cam_intr,
                                             params, kp, False, "STRETCH",
                                             sets_of)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(gpu) / n, 1e3 * wall / n


def phase_tracker_staged(imgs, sim, params, ref, smi):
    """`runner.run_tracker_staged` on the first card-rendered stereo frames
    with bench.py's KltParams, against JAX's counts on the CPU-rendered
    images."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.frontend import klt
    from open_vins_tpu_torch.models import runner

    meta = ref["meta"]
    kp = klt.KltParams(**meta["klt"])
    n = meta["tracker_frames"]
    runner.run_tracker_staged(imgs[:6], sim, params, kp, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, counts = runner.run_tracker_staged(imgs[:n], sim, params, kp,
                                          device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counts.cpu().numpy()
    jax_counts = np.asarray(ref["ref_tracker_counts"])
    kernels_pf, host_ms = _tracker_launches(imgs, sim, params, kp,
                                            TRACKER_PROFILE_FRAMES)
    fps = (n - 1) / seconds
    row = {"phase": "tracker_staged", "frames": n - 1, "seconds": seconds,
           "frames_per_s": fps, "host_ms_per_frame": 1e3 * seconds / (n - 1),
           "tracks_mean": float(counts.mean()),
           "jax_tracks_mean": float(jax_counts.mean()),
           "tracks_min_share_of_jax": float((counts / jax_counts).min()),
           "gpu_kernels_per_frame": kernels_pf,
           "profiled_host_ms_per_frame": host_ms}
    emit(row)
    _metric("klt_track_frames_per_sec_1chip", fps,
            f"frames/s ({params.width}x{params.height} stereo tracker-only, "
            f"{row['tracks_mean']:.0f} tracks/frame, {kernels_pf:.0f} GPU "
            "kernels/frame)", smi)
    ok = (row["tracks_mean"] > MIN_TRACKS
          and abs(row["tracks_mean"] - row["jax_tracks_mean"])
          <= TRACKER_MEAN_SPREAD * row["jax_tracks_mean"]
          and row["tracks_min_share_of_jax"] >= TRACKER_FRAME_FLOOR)
    if not ok:
        raise AssertionError(f"tracker_staged: a gate failed: {row}")
    return row


def phase_main_path_rendered(sim, params, run, ref, smi):
    """The images->pose pipeline through `runner.run_filter_rendered` over
    every frame of the rendered stream (the module docstring's rendered
    gates)."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.frontend import klt
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels

    meta = ref["meta"]
    cfg, kp = FilterConfig(**meta["cfg"]), klt.KltParams(**meta["klt"])
    opts = tri.TriangulationOptions()
    runner.run_filter_rendered(cfg, opts, sim, params, _prefix(run, 8), kp,
                               max_tracks=meta["max_tracks"], device="cuda")
    torch.cuda.synchronize()
    n_frames = run.frames.t_new.shape[0]
    kernels.symmetric_downdate.launches = 0
    kernels.householder_qr_blocks.launches = 0
    t0 = time.perf_counter()
    (state, _, _), outs = runner.run_filter_rendered(
        cfg, opts, sim, params, run, kp, max_tracks=meta["max_tracks"],
        device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"symmetric_downdate": kernels.symmetric_downdate.launches,
                "householder_qr_blocks":
                    kernels.householder_qr_blocks.launches}
    qs, ps, _, covs6, diag, tracked = outs
    rmse, nees = runner.pose_metrics(qs, ps, covs6, run.gt_q, run.gt_p)
    spread = abs(ref["ref_rmse"] - ref["ref_seed1_rmse"])
    bar = max(REF_RMSE_SPREAD_M, 2.0 * spread)
    fps = n_frames / seconds
    row = {"phase": "main_path_rendered", "frames": n_frames,
           "state_dim": cfg.state_dim, "seconds": seconds,
           "frames_per_s": fps, "rmse_m": rmse, "nees": nees,
           "finite": bool(torch.isfinite(state.cov).all().item()),
           "jax_rmse_m": ref["ref_rmse"], "jax_nees": ref["ref_nees"],
           "jax_seed1_rmse_m": ref["ref_seed1_rmse"],
           "jax_seed1_nees": ref["ref_seed1_nees"],
           "jax_rmse_bar_m": bar,
           "tracks_mean": float(tracked.float().mean()),
           "n_msckf_mean": float(diag.n_msckf.float().mean()),
           "n_slam_mean": float(diag.n_slam.float().mean()),
           "jax_n_slam_mean": float(np.mean(ref["ref_n_slam"])),
           "launches": launches}
    emit(row)
    _metric("rendered_pipeline_frames_per_sec_1chip", fps,
            f"frames/s (images->pose, {params.width}x{params.height} stereo,"
            f" rmse {rmse:.3f} m)", smi)
    ok = (row["finite"] and rmse < RENDERED_RMSE_GATE_M
          and RENDERED_NEES[0] < nees < RENDERED_NEES[1]
          and row["n_slam_mean"] > 0 and row["tracks_mean"] > MIN_TRACKS
          and launches["symmetric_downdate"] == n_frames
          and abs(rmse - ref["ref_rmse"]) <= bar)
    if not ok:
        raise AssertionError(f"main_path_rendered: a gate failed: {row}")
    return row


def replay_packets(sim, params, kp, ref, n):
    """The tracker over frames 0..n of the rendered stream with the JAX
    sets recorded in `ref` (`replayed_sets`), each packet against JAX's.
    Returns, per frame 1..n, (ids differing, masks differing, offsets [px]
    of the points of the tracks both keep, the larger coordinate), and the
    sets not handed out."""
    import numpy as np

    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.sim import render

    sets_of = replayed_sets(ref["ref_replay_sets"])
    tstate = runner.start_tracker(sim.cam_intr, params, kp, "STRETCH",
                                  sets_of, render.render(sim, params, [0])[0])
    frames = []
    for k in range(1, n + 1):
        tstate, ids, uv, _, mask = runner.render_and_track(
            tstate, sim, params, kp, k, False, "STRETCH", sets_of)
        ids, uv, mask = (x.cpu().numpy() for x in (ids, uv, mask))
        want = ref["ref_replay_mask"][k - 1]
        offsets = np.abs(uv - ref["ref_replay_uv"][k - 1]).max(-1)
        frames.append((int((ids != ref["ref_replay_ids"][k - 1]).sum()),
                       int((mask != want).sum()), offsets[mask & want]))
    return frames, sets_of.left()


def phase_rendered_replay(ref, device="cuda"):
    """The rendered pipeline's first frames with JAX's own RANSAC sets
    replayed (the module docstring's `rendered_replay`) on the CPU staging
    that JAX's reference ran on, moved to `device`: the tracker's packets
    frame by frame, then `runner.run_filter_rendered`'s poses and counts,
    each against JAX's.  `device` "cpu" is the CPU tests' run of the same
    gates."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.frontend import klt
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri

    meta = ref["meta"]
    n = meta["replay_frames"]
    cfg, kp = FilterConfig(**meta["cfg"]), klt.KltParams(**meta["klt"])
    sim, params, run = convert.stage_stream(meta, "cpu")
    sim, run = (pytree.tree_map(lambda a: a.to(device), x) for x in (sim, run))
    t0 = time.perf_counter()
    frames, tracker_left = replay_packets(sim, params, kp, ref, n)
    ids_off = sum(f[0] for f in frames)
    mask_off = sum(f[1] for f in frames)
    uv_err = max(float(f[2].max(initial=0.0)) for f in frames)
    sets_of = replayed_sets(ref["ref_replay_sets"])
    (state, _, _), outs = runner.run_filter_rendered(
        cfg, tri.TriangulationOptions(), sim, params, _prefix(run, n), kp,
        max_tracks=meta["max_tracks"], sets_of=sets_of, device=device)
    qs, ps, _, _, diag, _ = outs
    counts_off = {c: int((getattr(diag, c).cpu().numpy()
                          != ref[f"ref_{c}"][:n]).sum())
                  for c in ("n_tracks", "n_msckf", "n_slam", "n_slam_used")}
    row = {"phase": "rendered_replay", "frames": n,
           "seconds": time.perf_counter() - t0,
           "ids_differing": ids_off, "mask_differing": mask_off,
           "uv_max_abs_err_px": uv_err,
           "p_max_abs_err_m": float(np.abs(ps.cpu().numpy()
                                           - ref["ref_p"][:n]).max()),
           "q_max_abs_err": float(np.abs(qs.cpu().numpy()
                                         - ref["ref_q"][:n]).max()),
           "counts_differing": counts_off,
           "n_slam_mean": float(diag.n_slam.float().mean()),
           "sets_left": [tracker_left, sets_of.left()],
           "finite": bool(torch.isfinite(state.cov).all().item())}
    emit(row)
    ok = (ids_off == 0 and mask_off == 0 and uv_err <= REPLAY_UV_TOL_PX
          and row["p_max_abs_err_m"] <= REPLAY_POSE_TOL
          and row["q_max_abs_err"] <= REPLAY_POSE_TOL
          and not any(counts_off.values()) and row["n_slam_mean"] > 0
          and row["sets_left"] == [0, 0] and row["finite"])
    if not ok:
        raise AssertionError(f"rendered_replay: a gate failed: {row}")
    return row


def inherited_counts(ids, valid):
    """Per frame 1.. of a descriptor-tracker run (ids [K, P], valid
    [K, P], numpy): valid detections whose id comes from an earlier
    frame."""
    counts = []
    for k in range(1, len(ids)):
        before = ids[:k][valid[:k]]
        top = before.max() if before.size else -1
        counts.append(int((valid[k] & (ids[k] <= top)).sum()))
    return counts


def phase_descriptor(imgs, sim, ref):
    """The descriptor tracker on the first card-rendered left-eye frames,
    against JAX's `descriptor.track_frame` with the matched-rows id scatter
    (the port's semantics) on the CPU-rendered images; JAX's count with its
    scatter of every row is printed beside it."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.frontend import descriptor, klt, ransac

    meta = ref["meta"]
    kp = klt.KltParams(**meta["klt"])
    sets_of = ransac.sampler(torch.Generator(device="cuda").manual_seed(0))
    state = descriptor.init_tracker(kp.num_features, device="cuda")
    ids, valid = [], []
    t0 = time.perf_counter()
    for k in range(meta["descriptor_frames"]):
        state, i, _, _, v = descriptor.track_frame(
            state, imgs[k, 0], sim.cam_intr[0], kp, sets_of,
            first_frame=k == 0)
        ids.append(i)
        valid.append(v)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = inherited_counts(torch.stack(ids).cpu().numpy(),
                              torch.stack(valid).cpu().numpy())
    want = float(np.mean(ref["ref_desc_matched_scatter_counts"]))
    row = {"phase": "descriptor", "frames": len(ids), "seconds": seconds,
           "inherited_mean": float(np.mean(counts)),
           "jax_inherited_mean": want,
           "jax_all_rows_scatter_inherited_mean": float(
               np.mean(ref["ref_desc_counts"])),
           "detections_mean": float(torch.stack(valid).float().sum(1)
                                    .mean())}
    emit(row)
    if not abs(row["inherited_mean"] - want) <= DESC_SPREAD * want:
        raise AssertionError(f"descriptor: a gate failed: {row}")
    return row


def _load_prefixed(path, prefix):
    import numpy as np

    with np.load(path) as z:
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


def _rel_gaps(got, want, keys):
    """Per key, max|got − want| relative to max|want|."""
    import numpy as np

    return {k: float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max()
                     / max(np.abs(np.asarray(want[k])).max(), 1e-30))
            for k in keys}


def _gpu_kernels(fn):
    """(result of fn(), GPU kernels it ran, host ms) under torch.profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return out, n, 1e3 * wall


def phase_static_init():
    """`static_init.try_static_init` on the card for tests/test_init.py's
    windows (jerk, no jerk, moving, attitude and biases), waiting for the
    jerk and not: the success flags of the committed JAX results, q and
    the biases within STATIC_TOL."""
    import numpy as np
    import torch

    from open_vins_tpu_torch.init import static_init

    t0 = time.perf_counter()
    with np.load(STATIC_REF) as z:
        ref = {k: z[k] for k in z.files}
    meta = json.loads(str(ref["meta"]))
    rows = []
    for case in meta["cases"]:
        imu = [torch.as_tensor(ref[f"{case}_{k}"], device="cuda").to(
                   torch.float32) for k in ("t", "w", "a")]
        imu.append(torch.as_tensor(ref[f"{case}_mask"], device="cuda"))
        for wait in (True, False):
            tag = f"{case}_{'jerk' if wait else 'still'}"
            opts = static_init.StaticInitOptions(
                **dict(meta["opts"], wait_for_jerk=wait))
            res = static_init.try_static_init(opts, *imu,
                                              float(ref[f"{case}_t"][-1]))
            got = {k: v.cpu().numpy() for k, v in res.items()}
            gaps = {k: float(np.abs(got[k] - ref[f"{tag}_{k}"]).max())
                    for k in STATIC_TOL}
            rows.append({"case": tag, "success": bool(got["success"]),
                         "jax_success": bool(ref[f"{tag}_success"]),
                         "gaps": gaps})
    emit({"phase": "static_init", "seconds": time.perf_counter() - t0,
          "cases": rows})
    for r in rows:
        if (r["success"] != r["jax_success"]
                or any(r["gaps"][k] > STATIC_TOL[k] for k in STATIC_TOL)):
            raise AssertionError(f"static_init disagrees with JAX: {r}")


def phase_dynamic_init():
    """`dynamic_init.initialize` on the card for tests/test_dynamic_init
    .py's problem (PARAMS, seed 11, P = 6; JAX's DynInitInput carried over
    in dyninit_seed11_ref.npz) and its degenerate windows: success as
    JAX's, the seed-11 outputs within DYNINIT_TOL of JAX's jitted result;
    host ms and GPU kernels of one attempt."""
    import numpy as np

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.init import dynamic_init

    t0 = time.perf_counter()
    with np.load(DYNINIT_REF) as z:
        cases = list(json.loads(str(z["meta"]))["cases"])
    opts = dynamic_init.DynamicInitOptions()
    rows = []
    for case in cases:
        inp = convert.dyn_input_from_numpy(
            _load_prefixed(DYNINIT_REF, f"{case}_in_"), "cuda")
        if case == "recover":  # warm (cuBLAS, cuSOLVER), then profiled
            dynamic_init.initialize(inp, opts)
            res, kernels, host_ms = _gpu_kernels(
                lambda: dynamic_init.initialize(inp, opts))
        else:
            t1 = time.perf_counter()
            res, kernels = dynamic_init.initialize(inp, opts), None
            host_ms = 1e3 * (time.perf_counter() - t1)
        got = convert.dyn_result_to_numpy(res)
        want = _load_prefixed(DYNINIT_REF, f"{case}_jit_")
        rows.append({"case": case, "success": bool(got["success"]),
                     "jax_success": bool(want["success"]),
                     "host_ms": host_ms, "gpu_kernels": kernels,
                     "gaps": _rel_gaps(got, want, DYNINIT_TOL)})
    emit({"phase": "dynamic_init", "seconds": time.perf_counter() - t0,
          "shape": list(np.shape(_load_prefixed(
              DYNINIT_REF, "recover_in_")["uvn"])), "cases": rows})
    for r in rows:
        if r["success"] != r["jax_success"]:
            raise AssertionError(f"dynamic_init success differs: {r}")
    rec = rows[0]
    if any(rec["gaps"][k] > DYNINIT_TOL[k] for k in DYNINIT_TOL):
        raise AssertionError(f"dynamic_init outputs off JAX's: {rec}")
    return rec


def _init_state_row(st0, k0, run, want=None):
    """The init state's gravity-direction and |v| errors against
    groundtruth at k0, and its IMU mean and 15×15 block against JAX's
    init state `want`."""
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.ops import lie

    ez = torch.tensor([0.0, 0.0, 1.0], device=st0.q.device)
    g_i = lie.quat_2_rot(st0.q) @ ez
    g_t = lie.quat_2_rot(run.gt_q[k0].to(st0.q.device)) @ ez
    row = {"gravity_err_deg": float(torch.rad2deg(torch.arccos(
               torch.clamp(g_i @ g_t, -1.0, 1.0)))),
           "speed_err_mps": abs(float(st0.v.norm())
                                - float(run.gt_v[k0].norm()))}
    if want is not None:
        got = convert.state_to_numpy(st0)

        def imu(s):
            return {"q_GtoI": s["q"], "p": s["p"], "v": s["v"],
                    "bg": s["bg"], "ba": s["ba"],
                    "cov15": s["cov"][:15, :15]}

        row["gaps_to_jax"] = _rel_gaps(imu(got), imu(want), DYNINIT_TOL)
    return row


def phase_auto_init_v102(card_staged):
    """`runner.auto_init_state` on the V1_02 replay: on the port's CPU
    staging moved to the card (kind, k0 and the state against JAX's
    auto_init_state on the same staging, v102_autoinit_seed0_ref.npz) and
    on the card's own staging (`card_staged`, phase 7's); both held to the
    corpus replay's init gates.  Then `runner.run_filter_from` from the
    CPU staging's init over the whole replay (the launch counts set to 0
    just before it): posyaw ATE < 0.08 m and < 1.5°, within 0.01 m of
    JAX's run from JAX's init, the aligned NEES in 0.5-30, more than 10
    landmarks over the last three quarters.  Returns (row, the CPU
    staging's run on the card, its init)."""
    import numpy as np
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels

    ref = convert.load_reference(V102_AUTOINIT_REF)
    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    want0 = _load_prefixed(V102_AUTOINIT_REF, "state0_")
    with np.load(V102_AUTOINIT_REF) as z:
        jax_kind, jax_k0 = str(z["ref_kind"]), int(z["ref_k0"])
        jax_attempts = int(z["ref_attempts"])
    sim_c, params, run_c = convert.stage_stream(meta, "cpu")
    run = runner._to(run_c, "cuda")
    calib = runner._to(runner.sim_calib(sim_c), "cuda")
    rows = {}
    inits = {}
    for name, (r, c) in {"cpu_staging": (run, calib),
                         "card_staging": card_staged}.items():
        attempts = []
        t0 = time.perf_counter()
        out = runner.auto_init_state(r, c, cfg, params,
                                     max_search_s=meta["max_search_s"],
                                     device="cuda", attempts=attempts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if out is None:
            raise AssertionError(f"auto_init_v102 {name}: no init")
        st0, k0, kind, t_init = out
        inits[name] = out
        rows[name] = {
            "kind": kind, "k0": k0, "t_init": t_init,
            "attempts": len(attempts), "seconds": seconds,
            "host_ms_per_attempt": [1e3 * a[2] for a in attempts],
            **_init_state_row(st0, k0, r,
                              want0 if name == "cpu_staging" else None)}
    # the replay from the CPU staging's own init
    st0, k0, _, _ = inits["cpu_staging"]
    kernels.symmetric_downdate.launches = 0
    diags = []
    t0 = time.perf_counter()
    st, outs = runner.run_filter_from(cfg, tri.TriangulationOptions(), run,
                                      st0, k0, meta["max_tracks"],
                                      device="cuda", diags=diags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.symmetric_downdate.launches
    n = run.frames.t_new.shape[0]
    ate_p, ate_o, nees = init_replay_metrics(outs[0], outs[1], outs[3],
                                             run.gt_q, run.gt_p, k0)
    n_slam = torch.stack([d.n_slam for d in diags]).float()
    row = {"phase": "auto_init_v102", "inits": rows,
           "jax": {"kind": jax_kind, "k0": jax_k0, "attempts": jax_attempts,
                   "ate_pos_m": ref["ref_ate_pos_m"],
                   "ate_ori_deg": ref["ref_ate_ori_deg"],
                   "nees_aligned": ref["ref_nees_full"]},
           "replay_frames": n - k0, "replay_seconds": seconds,
           "frames_per_s": (n - k0) / seconds,
           "finite": bool(torch.isfinite(st.cov).all().item()),
           "ate_pos_m": ate_p, "ate_ori_deg": ate_o, "nees_aligned": nees,
           "n_slam_last3q_mean": float(n_slam[len(n_slam) // 4:].mean()),
           "launches": {"symmetric_downdate": launches}}
    emit(row)
    cpu = rows["cpu_staging"]
    ok = (cpu["kind"] == jax_kind and cpu["k0"] == jax_k0
          and all(cpu["gaps_to_jax"][k] <= DYNINIT_TOL[k]
                  for k in DYNINIT_TOL)
          and all(r["gravity_err_deg"] < INIT_GRAVITY_DEG
                  and r["speed_err_mps"] < INIT_SPEED_MPS
                  for r in rows.values())
          and row["finite"] and ate_p < REPLAY_ATE_POS_M
          and ate_o < REPLAY_ATE_ORI_DEG
          and REPLAY_NEES[0] < nees < REPLAY_NEES[1]
          and abs(ate_p - ref["ref_ate_pos_m"]) <= REF_RMSE_SPREAD_M
          and row["n_slam_last3q_mean"] > REPLAY_MIN_SLAM
          and launches >= n - k0)
    if not ok:
        raise AssertionError("auto_init_v102: a gate failed")
    return row, run, calib


def phase_background_init(run, calib):
    """The same search driven through `background.BackgroundInitializer` in
    replay mode: the attempt (the routed search up to JAX's init frame) on
    the worker thread, the next camera times queued behind it, `join()`,
    then `catch_up` over the queued times.  Gates: the route and the queued
    times as JAX's, and `catch_up` from JAX's init state equal to JAX's
    `background.catch_up` (CATCHUP_VALUE_TOL, CATCHUP_COV_TOL·‖P‖∞)."""
    import numpy as np
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.init import background
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.sim import simulator

    ref = convert.load_reference(V102_AUTOINIT_REF)
    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    params_rate = meta["sim"]["imu_rate"]
    with np.load(V102_AUTOINIT_REF) as z:
        k0, t_init = int(z["ref_k0"]), float(z["ref_t_init"])
        jax_queued = [float(x) for x in z["ref_catchup_t"]]
        jax_kind = str(z["ref_kind"])
    params = simulator.SimParams(**meta["sim"])
    t_new = run.frames.t_new.cpu().numpy()

    def attempt():
        out = runner.auto_init_state(run, calib, cfg, params,
                                     max_search_s=t_init, device="cuda")
        return ("none", None) if out is None else (out[2], out)

    t0 = time.perf_counter()
    bg = background.BackgroundInitializer()
    bg.try_to_initialize(t_init, attempt)
    for t in t_new[k0:k0 + meta["catchup_frames"]]:
        bg.try_to_initialize(float(t), None)
    bg.join(600.0)
    kind, out, t_attempt = bg.result
    queued = bg.queued_times(t_attempt)
    make_window = runner.window_packer(*runner.imu_stream(run))
    own = background.catch_up(out[0], cfg, queued, make_window, params_rate)
    st_j = convert.state_from_numpy(_load_prefixed(V102_AUTOINIT_REF,
                                                   "state0_"), "cuda")
    caught = convert.state_to_numpy(background.catch_up(
        st_j, cfg, jax_queued, make_window, params_rate))
    torch.cuda.synchronize()
    want = _load_prefixed(V102_AUTOINIT_REF, "catchup_")
    norm = float(np.abs(want["cov"]).sum(1).max())
    value_gap = max(float(np.abs(caught[k] - want[k]).max())
                    for k in ("q", "p", "v", "clones_q", "clones_p"))
    row = {"phase": "background_init", "seconds": time.perf_counter() - t0,
           "kind": kind, "queued": len(queued),
           "queued_equal_jax": queued == jax_queued,
           "n_clones": int(caught["n_clones"]),
           "jax_n_clones": int(want["n_clones"]),
           "cov_gap_rel_norm_inf": float(np.abs(caught["cov"]
                                                - want["cov"]).max()) / norm,
           "value_gap": value_gap,
           "own_init_p_gap_to_jax_catchup_m": float(np.abs(
               own.p.cpu().numpy() - want["p"]).max())}
    emit(row)
    ok = (kind == jax_kind and row["queued_equal_jax"]
          and row["n_clones"] == row["jax_n_clones"]
          and row["cov_gap_rel_norm_inf"] <= CATCHUP_COV_TOL
          and value_gap <= CATCHUP_VALUE_TOL
          and np.array_equal(caught["clone_valid"], want["clone_valid"]))
    if not ok:
        raise AssertionError("background_init: a gate failed")


def _reference_prefix(ref, run, n):
    """A JAX run's reference cut to its first n frames: positions, counts
    and its RMSE and NEES recomputed over those frames from its per-frame
    poses and pose covariances (`ref_covs6`), as `runner.pose_metrics`
    computes the port's."""
    import torch

    from open_vins_tpu_torch.models import runner

    rmse, nees = runner.pose_metrics(
        *(torch.as_tensor(ref[k][:n]) for k in ("ref_q", "ref_p",
                                                 "ref_covs6")),
        run.gt_q[:n + 1], run.gt_p[:n + 1])
    cut = {k: v[:n] for k, v in ref.items()
           if k.startswith("ref_") and getattr(v, "ndim", 0) >= 1}
    return dict(ref, **cut, ref_rmse=rmse, ref_nees=nees)


def phase_single_depth(run, calib):
    """The operating point's first SINGLE_FRAMES frames with
    ANCHORED_INVERSE_DEPTH_SINGLE landmarks, in the joint "qr" update and in
    the sequential ordering, each against the JAX run of its configuration
    over the same frames: RMSE within 0.01 m, NEES within 25 %, a finite
    covariance, a downdate launch per frame at least.  Returns {name:
    row}."""
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig

    rows = {}
    prefix = _prefix(run, SINGLE_FRAMES)
    for name, path in SINGLE_REFS.items():
        ref = _reference_prefix(convert.load_reference(path), prefix,
                                SINGLE_FRAMES)
        meta = ref["meta"]
        row, _, _ = _drive(f"main_path_{name}", FilterConfig(**meta["cfg"]),
                           prefix, calib, ref, meta["max_tracks"])
        row["jax_n_slam_mean"] = float(ref["ref_n_slam"].mean())
        emit(row)
        _jax_gates(f"main_path_{name}", row, ref)
        rows[name] = row
    return rows


def _jax_gates(name, row, ref):
    """A loop against its JAX run on the same frames: finite covariance,
    RMSE within REF_RMSE_SPREAD_M, NEES within NEES_SPREAD."""
    ok = (row["finite"]
          and abs(row["rmse_m"] - ref["ref_rmse"]) <= REF_RMSE_SPREAD_M
          and abs(row["nees"] - ref["ref_nees"]) <= NEES_SPREAD
          * ref["ref_nees"])
    if not ok:
        raise AssertionError(f"{name}: a gate failed: {row}")


def phase_aruco():
    """tests/test_aruco_sigma.py's stream staged on the card (held against
    the CPU staging's digest) with ids 0..256 aruco tag corners, against
    JAX's run on the CPU staging."""
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner

    ref = convert.load_reference(ARUCO_REF)
    meta = ref["meta"]
    t0 = time.perf_counter()
    sim, params, run = convert.stage_stream(meta, "cuda")
    torch.cuda.synchronize()
    _check_staging("aruco", time.perf_counter() - t0, params, run,
                   _digest_of(ref), lambda: sim)
    row, _, state = _drive("main_path_aruco", FilterConfig(**meta["cfg"]),
                           run, runner.sim_calib(sim), ref,
                           meta["max_tracks"])
    ids = state.slam_id[state.slam_valid]
    row["aruco_landmarks_end"] = int(((ids >= 0) & (
        ids <= 4 * meta["cfg"]["num_aruco_tags"])).sum())
    emit(row)
    _jax_gates("main_path_aruco", row, ref)
    return row


def _write_config_tree(root):
    """The reference's three-file YAML layout for the operating point
    (estimator_config.yaml naming the two kalibr files), with the staged
    run's IMU noise."""
    with open(os.path.join(root, "kalibr_imu_chain.yaml"), "w") as f:
        f.write("imu0:\n"
                "  accelerometer_noise_density: 2.0e-3\n"
                "  accelerometer_random_walk: 3.0e-3\n"
                "  gyroscope_noise_density: 1.6968e-4\n"
                "  gyroscope_random_walk: 1.9393e-5\n"
                "  update_rate: 200.0\n")
    with open(os.path.join(root, "kalibr_imucam_chain.yaml"), "w") as f:
        f.write("cam0:\n"
                "  T_imu_cam:\n"
                "    - [0.0, -1.0, 0.0, 0.0]\n"
                "    - [1.0, 0.0, 0.0, 0.0]\n"
                "    - [0.0, 0.0, 1.0, 0.0]\n"
                "    - [0.0, 0.0, 0.0, 1.0]\n"
                "  intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
                "  distortion_coeffs: [0.0, 0.0, 0.0, 0.0]\n"
                "  distortion_model: radtan\n"
                "  resolution: [752, 480]\n")
    path = os.path.join(root, "estimator_config.yaml")
    with open(path, "w") as f:
        f.write("%YAML:1.0\n"
                "relative_config_imu: kalibr_imu_chain.yaml\n"
                "relative_config_imucam: kalibr_imucam_chain.yaml\n"
                "max_cameras: 1\nmax_clones: 11\nmax_slam: 50\n"
                "max_msckf_in_update: 40\nintegration: analytical\n"
                "use_fej: true\nfeat_rep_slam: GLOBAL_3D\n")
    return path


def phase_config(run, calib):
    """`utils.config.load` on a YAML tree written to a temporary directory
    must give the operating point's FilterConfig (newton_iters, which only
    the newton form reads and no YAML key sets, aside), and 40 frames of
    the operating point run from it: finite, within REF_RMSE_SPREAD_M of
    the JAX run's positions, a downdate launch per frame."""
    import tempfile

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.utils import config

    ref = convert.load_reference(OPPOINT_REF)
    want = FilterConfig(**ref["meta"]["cfg"])
    with tempfile.TemporaryDirectory() as root:
        loaded = config.load(_write_config_tree(root))
    if loaded.filter._replace(newton_iters=want.newton_iters) != want:
        raise AssertionError(f"config: {loaded.filter} is not {want}")
    ref = dict(ref, ref_p=ref["ref_p"][:CONFIG_FRAMES])
    row, outs, _ = _drive("config_oppoint", loaded.filter,
                          _prefix(run, CONFIG_FRAMES), calib, ref,
                          ref["meta"]["max_tracks"])
    emit(row)
    if not (row["finite"] and row["max_position_gap_to_jax_m"]
            < REF_RMSE_SPREAD_M):
        raise AssertionError(f"config: a gate failed: {row}")
    return row


def _timed_step(timer, state, table, cfg, opts, frame):
    """The operating point's frame as `manager.step_frame` runs it
    (`_step_core` for the joint update), its stages timed."""
    from open_vins_tpu_torch.models import manager

    timer.start_frame()
    state, table, reserved = manager.pre_update(state, table, cfg, frame)
    timer.stage("propagation")
    state, table, H, res, diag, n_used = manager.build_joint_system(
        state, cfg, table, opts, reserved)
    timer.stage("msckf")
    state, table, diag = manager.joint_update(state, cfg, table, H, res, diag,
                                              n_used)
    timer.stage("slam")
    timer.end_frame(float(frame.t_new))
    return state, table


def _record_gaps(got, want):
    """{field: max |got − want|} over two records' float fields, and
    {field: equal} over all."""
    import torch

    gaps, equal = {}, {}
    for k, v in want.items():
        g = getattr(got, k)
        equal[k] = torch.equal(g, v)
        if v.is_floating_point():
            gaps[k] = float((g - v).abs().max()) if v.numel() else 0.0
    return gaps, equal


def phase_resume(run, calib, smi):
    """The operating point's frames 0..59 with `utils.timing.FrameTimer`
    writing the reference's timing CSV (stages synchronized on the card),
    a checkpoint written after frame 30 (`utils.checkpoint.save`), loaded
    back onto the card and stepped to frame 60 again: the resumed state and
    table must equal the uninterrupted ones (where a CUDA operation is not
    deterministic, the gaps are printed per field and the covariance held
    to STEP_COV_TOL·‖P‖∞, the values to 1e-4).  The trajectory is written
    as TUM (`eval.traj_io`) and read back within 1e-6.  Returns (row, the
    state and table at frame 60)."""
    import tempfile

    import numpy as np
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.eval import traj_io
    from open_vins_tpu_torch.models import feature_table as ft
    from open_vins_tpu_torch.models import manager, runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels
    from open_vins_tpu_torch.utils import checkpoint, timing

    meta = convert.load_reference(OPPOINT_REF)["meta"]
    cfg, opts = FilterConfig(**meta["cfg"]), tri.TriangulationOptions()
    state0 = runner._initial_state(cfg, calib, run)
    table0 = ft.init_table(cfg, meta["max_tracks"], "cuda")
    frames = [runner.frame_at(run.frames, k) for k in range(RESUME_FRAMES)]
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "frame30.npz")
        timer = timing.FrameTimer(os.path.join(root, "timing.csv"),
                                  device="cuda")
        kernels.symmetric_downdate.launches = 0
        t0 = time.perf_counter()
        state, table, qs, ps = state0, table0, [], []
        for k, fr in enumerate(frames):
            if k == RESUME_SAVE:
                checkpoint.save(ckpt, state, table, extra={"frame": k})
            state, table = _timed_step(timer, state, table, cfg, opts, fr)
            qs.append(state.q)
            ps.append(state.p)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        timer.close()
        launches = kernels.symmetric_downdate.launches
        csv = timing.load_timing_csv(os.path.join(root, "timing.csv"))

        st, tb, extra = checkpoint.load(ckpt, state0, table0, device="cuda")
        for fr in frames[int(extra["frame"]):]:
            st, tb, _ = manager.step_frame(st, tb, cfg, opts, fr)
        st_gaps, st_equal = _record_gaps(st, state)
        tb_gaps, tb_equal = _record_gaps(tb, table)

        tum = os.path.join(root, "traj.txt")
        t = run.frames.t_new[:RESUME_FRAMES].double().cpu().numpy()
        p = torch.stack(ps).cpu().numpy()
        q = torch.stack(qs).cpu().numpy()  # JPL q_GtoI = Hamilton q_ItoG
        traj_io.save_tum(tum, t, p, q)
        t_r, p_r, q_r = traj_io.load_tum(tum)
    tum_gap = max(np.abs(t_r - t).max(), np.abs(p_r - p).max(),
                  np.abs(q_r - q).max())
    norm = float(state.cov.abs().sum(1).max())
    bitwise = all(st_equal.values()) and all(tb_equal.values())
    row = {"phase": "checkpoint_timing_traj_io", "frames": RESUME_FRAMES,
           "saved_after_frame": RESUME_SAVE, "seconds": seconds,
           "frames_per_s": RESUME_FRAMES / seconds, "nvidia_smi": smi,
           "launches": {"symmetric_downdate": launches},
           "resume_bitwise": bitwise,
           "resume_state_gaps": {k: v for k, v in st_gaps.items() if v},
           "resume_table_gaps": {k: v for k, v in tb_gaps.items() if v},
           "resume_cov_gap_rel": st_gaps["cov"] / norm,
           "timing_rows": int(csv["total"].shape[0]),
           "timing_ms_mean": {c: 1e3 * float(np.mean(csv[c]))
                              for c in ("propagation", "msckf", "slam",
                                        "total")},
           "tum_gap": float(tum_gap),
           "finite": bool(torch.isfinite(state.cov).all())}
    emit(row)
    value_gap = max(v for k, v in st_gaps.items() if k != "cov")
    if not (row["finite"] and launches >= RESUME_FRAMES
            and (bitwise or (row["resume_cov_gap_rel"] <= STEP_COV_TOL
                             and value_gap <= 1e-4
                             and all(tb_equal[k] for k in
                                     ("ids", "mbits", "seen"))))
            and row["timing_rows"] == RESUME_FRAMES
            and (csv["total"] > 0).all()
            and (csv["propagation"] + csv["msckf"] + csv["slam"]
                 <= csv["total"] + 1e-6).all()
            and tum_gap <= 1e-6):
        raise AssertionError(f"checkpoint/timing/traj_io: a gate failed: {row}")
    return row, (state, table, cfg, opts)


def phase_profiling(carry, run, smi):
    """`utils.profiling.trace` over PROFILE_FRAMES more frames, each in an
    `annotate` range: the Chrome trace it writes must hold the labels and
    a CUDA kernel event of `symmetric_downdate` in every frame."""
    import glob
    import gzip
    import tempfile

    from open_vins_tpu_torch.models import manager, runner
    from open_vins_tpu_torch.utils import profiling

    state, table, cfg, opts = carry
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        with profiling.trace(root) as where:
            if where != root:
                raise AssertionError("profiling.trace did not start")
            for k in range(RESUME_FRAMES, RESUME_FRAMES + PROFILE_FRAMES):
                with profiling.annotate(f"frame_{k}"):
                    state, table, _ = manager.step_frame(
                        state, table, cfg, opts, runner.frame_at(run.frames,
                                                                 k))
        seconds = time.perf_counter() - t0
        files = glob.glob(os.path.join(root, "*.pt.trace.json*"))
        if len(files) != 1:
            raise AssertionError(f"profiling: trace files {files}")
        opener = gzip.open if files[0].endswith(".gz") else open
        with opener(files[0], "rt") as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    downdates = [e for e in kernels if "symmetric_downdate" in e["name"]]
    labels = {e.get("name") for e in events} & {
        f"frame_{k}" for k in range(RESUME_FRAMES,
                                    RESUME_FRAMES + PROFILE_FRAMES)}
    row = {"phase": "profiling", "frames": PROFILE_FRAMES,
           "seconds": seconds, "nvidia_smi": smi,
           "cuda_kernel_events": len(kernels),
           "symmetric_downdate_events": len(downdates),
           "symmetric_downdate_us": [e.get("dur") for e in downdates],
           "labels": sorted(labels)}
    emit(row)
    if len(downdates) < PROFILE_FRAMES or len(labels) != PROFILE_FRAMES:
        raise AssertionError(f"profiling: a gate failed: {row}")
    return row


def phase_window_refine(smi):
    """`parallel.window_refine` on the card on JAX's operating-point state
    and table after 30 frames (`window_refine_oppoint30_ref.npz`): JAX's
    landmark rows and `ok` exactly, the refined window and RMS within
    WINDOW_TOL of JAX's and the RMS after at most the RMS before.  It also
    prints how far the card's and JAX's f32 answers lie from the same
    problem refined in f64 on the card (`f64_gaps_card_jax`)."""
    import numpy as np
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import manager
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.parallel import distributed_ba, window_refine

    with np.load(WINDOW_REF) as z:
        meta = json.loads(str(z["meta"]))
        state = convert.state_from_numpy(
            {k[6:]: z[k] for k in z.files if k.startswith("state_")}, "cuda")
        table = convert.table_from_numpy(
            {k[6:]: z[k] for k in z.files if k.startswith("table_")}, "cuda")
        ref = {k[4:]: z[k] for k in z.files if k.startswith("ref_")}
    cfg, opts = FilterConfig(**meta["cfg"]), tri.TriangulationOptions()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, _ = window_refine.select_rows(table, WINDOW_LANDMARKS)
    prob, ok = window_refine.build_problem(state, cfg, table, opts,
                                           WINDOW_LANDMARKS,
                                           manager.gather_feature_obs)
    outs = window_refine.refine_window(
        state, cfg, table, opts, manager.gather_feature_obs,
        max_landmarks=WINDOW_LANDMARKS, iters=WINDOW_ITERS, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = dict(zip(("R", "p", "landmarks", "rms_before", "rms_after"),
                   (o.cpu().numpy() for o in outs)))
    gaps = {k: float(np.abs(got[k] - ref[k]).max()) for k in WINDOW_TOL}
    prob64, _ = distributed_ba.refine(prob.replace(**{
        k: v.double() for k, v in prob.items() if v.is_floating_point()}),
        iters=WINDOW_ITERS)
    f64 = {"R": prob64.R, "p": prob64.p, "landmarks": prob64.landmarks}
    f64_gaps = {k: [float(np.abs(got[k] - v.cpu().numpy()).max()),
                    float(np.abs(ref[k] - v.cpu().numpy()).max())]
                for k, v in f64.items()}
    row = {"phase": "window_refine", "seconds": seconds, "nvidia_smi": smi,
           "f64_gaps_card_jax": f64_gaps,
           "rows_equal": bool(np.array_equal(rows.cpu().numpy(),
                                             ref["rows"])),
           "ok_equal": bool(np.array_equal(ok.cpu().numpy(), ref["ok"])),
           "landmarks_ok": int(ok.sum()), "gaps_to_jax": gaps,
           "rms_before": float(got["rms_before"]),
           "rms_after": float(got["rms_after"])}
    emit(row)
    if not (row["rows_equal"] and row["ok_equal"]
            and all(gaps[k] <= WINDOW_TOL[k] for k in WINDOW_TOL)
            and row["rms_after"] <= row["rms_before"]):
        raise AssertionError(f"window_refine: a gate failed: {row}")
    return row


def _dense_references(st_np, H, res, r, cfg, prob):
    """The port's dense single-device results on the card: the plain
    update of the sharded system and one BA step and a 6-step refine."""
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core import ekf
    from open_vins_tpu_torch.parallel import distributed_ba as dba

    full = convert.state_from_numpy(st_np, "cuda")
    Ht, rt, rdt = (torch.as_tensor(a, device="cuda") for a in (H, res, r))
    dx, cov = ekf.kalman_update_math(full.cov, Ht, rt, rdt,
                                     fuse_downdate=False)
    dense = ekf.boxplus(full, cfg, dx).replace(cov=cov)
    prob = prob.replace(**{k: v.to("cuda") for k, v in prob.items()})
    step, _ = dba.ba_step(prob)
    refined, _ = dba.refine(prob, iters=6)
    return dense, step, refined


def _parallel_gaps(name, sh, ba_step, ba_refine, dense, step, refined, D):
    """A row of the sharded update's and the BA's gaps to the dense run."""
    import numpy as np

    cov = sh["cov"]
    return {"sharded_cov_gap": float(np.abs(cov[:D, :D] - dense.cov.cpu()
                                            .numpy()).max()),
            "sharded_p_gap": float(np.abs(sh["p"] - dense.p.cpu().numpy())
                                   .max()),
            "sharded_padding_zero": bool(not cov[D:].any()
                                         and not cov[:, D:].any()),
            "ba_step_pose_gap": float(np.abs(ba_step["p"] - step.p.cpu()
                                             .numpy()).max()),
            "ba_step_landmark_gap": float(np.abs(
                ba_step["landmarks"] - step.landmarks.cpu().numpy()).max()),
            "ba_refine_pose_gap": float(np.abs(
                ba_refine["p"] - refined.p.cpu().numpy()).max()),
            "ba_refine_landmark_gap": float(np.abs(
                ba_refine["landmarks"] - refined.landmarks.cpu().numpy())
                .max()),
            "ba_rmse_before": ba_refine["rmse_before"],
            "ba_rmse_after": ba_refine["rmse_after"], "where": name}


def _parallel_gates(row):
    ok = (row["sharded_cov_gap"] <= SHARDED_COV_TOL
          and row["sharded_p_gap"] <= SHARDED_P_TOL
          and row["sharded_padding_zero"]
          and row["ba_step_pose_gap"] <= BA_POSE_TOL
          and row["ba_step_landmark_gap"] <= BA_LM_TOL
          and row["ba_refine_pose_gap"] <= BA_POSE_TOL
          and row["ba_refine_landmark_gap"] <= BA_LM_TOL
          and row["ba_rmse_after"] < 0.2 * row["ba_rmse_before"])
    if not ok:
        raise AssertionError(f"{row['phase']}: a gate failed: {row}")


def phase_parallel(smi):
    """The row-sharded EKF update at the large map's D (the dry run's
    synthetic system) and the distributed BA (make_ba_problem(L=32): one
    step and a 6-step refine), each against the port's dense single-device
    result on the card: on one NCCL rank in this process, then on
    PARALLEL_RANKS ranks spawned on the one card with gloo and CUDA
    tensors.  Sharded: covariance within SHARDED_COV_TOL, p within
    SHARDED_P_TOL, the padding zero; BA: poses within BA_POSE_TOL,
    landmarks within BA_LM_TOL, the refine's RMS below a fifth of the
    start.  Returns the rows."""
    import torch
    import torch.distributed as dist

    from open_vins_tpu_torch.parallel import distributed_ba as dba
    from open_vins_tpu_torch.parallel import dryrun, mesh, sharded_ekf

    cfg = dryrun.LARGE_MAP
    st_np, H, res, r = dryrun.sharded_system(cfg)
    prob, _ = dba.make_ba_problem(L=32, device="cpu")
    dense, step, refined = _dense_references(st_np, H, res, r, cfg, prob)
    prob_np = {k: v.numpy() for k, v in prob.items()}
    tasks = [dryrun.sharded_task(st_np, H, res, r, cfg),
             dryrun.ba_task(prob_np, step_only=True),
             dryrun.ba_task(prob_np, iters=6)]
    rows = []

    t0 = time.perf_counter()
    mesh.init_distributed("nccl", rank=0, world_size=1,
                          init_method=f"tcp://localhost:{mesh.free_port()}")
    try:
        got = [dryrun._TASKS[name](0, 1, torch.device("cuda", 0), **kw)
               for name, kw in tasks]
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    row = {"phase": "parallel_nccl_1", "ranks": 1, "backend": "nccl",
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi,
           **_parallel_gaps("nccl", *got, dense, step, refined,
                            cfg.state_dim)}
    emit(row)
    _parallel_gates(row)
    rows.append(row)

    t0 = time.perf_counter()
    got = dryrun.run_tasks(PARALLEL_RANKS, "gloo", tasks, device="cuda")
    row = {"phase": f"parallel_gloo_{PARALLEL_RANKS}",
           "ranks": PARALLEL_RANKS, "backend": "gloo (CUDA tensors, one card)",
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi,
           "padded_dim": sharded_ekf._padded_dim(cfg.state_dim,
                                                 PARALLEL_RANKS),
           **_parallel_gaps("gloo", *got, dense, step, refined,
                            cfg.state_dim)}
    emit(row)
    _parallel_gates(row)
    rows.append(row)
    return rows


def phase_dryrun(smi):
    """`parallel.dryrun.run` on PARALLEL_RANKS ranks on the one card (gloo):
    the ensemble at the operating point (each rank its own stream through
    `manager.step_frame`, one downdate launch per frame), the sharded update
    at the large map's D and the distributed BA; prints its lines, with the
    host-bound caveat (the ranks share the host and the card)."""
    from open_vins_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    out = dryrun.run(PARALLEL_RANKS, device="cuda", backend="gloo")
    ens = out["ensemble"]
    row = {"phase": "dryrun", "ranks": PARALLEL_RANKS,
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi,
           "frames_per_rank": ens["frames"], "state_dim": ens["state_dim"],
           "launches": {"symmetric_downdate": ens["launches"]},
           "ensemble_pass_s": ens["dt_ensemble"],
           "single_pass_s": ens["dt_single"],
           "aggregate_steps_per_s": PARALLEL_RANKS * ens["frames"]
           / ens["dt_ensemble"],
           "single_steps_per_s": ens["frames"] / ens["dt_single"]}
    emit(row)
    return row


def _kernel_numbers(row):
    """A kernel's numbers for the kernels line: `ms` and `library_ms` are
    device times (`device_ms`); the per-call times stand beside them."""
    return {"max_abs_err": row["max_abs_err"], "ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_device_ms"],
            "device_ms": row["device_ms"], "call_ms": row["call_ms"],
            "library_call_ms": row["library_call_ms"],
            "bound_share": row["bound_share"]}


def main():
    import torch

    import open_vins_tpu_torch  # noqa: F401  (the port, from this checkout)
    from open_vins_tpu_torch import convert

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    dd_rows = phase_downdate()
    bd_rows = phase_downdate_batched()
    qr_rows = phase_qr()
    run, calib, ref = convert.load_staged_run(FIXTURE, device="cuda")
    phase_msckf_path(run, calib, ref)
    tsqr_launches, operands = phase_tsqr(run, calib, convert.load_reference(
        OPPOINT_REF))
    kf_rows = phase_downdate_forms(operands)
    op_row = phase_oppoint_path(run, calib)
    form_rows = phase_forms_path(run, calib)
    seq_row = phase_sequential_path(run, calib)
    zupt_row = phase_zupt_path(convert.load_reference(ZUPT_REF))
    refs = {"largemap": convert.load_reference(LARGEMAP_REF),
            "v102_replay": convert.load_reference(V102_REF)}
    staged = phase_sim_staging(refs)
    lm_row = phase_largemap(staged["largemap"], refs["largemap"])
    rp_row = phase_v102_replay(staged["v102_replay"], refs["v102_replay"])
    en_ref = convert.load_reference(ENSEMBLE_REF)
    en_row, calibs, runs = phase_ensemble8(en_ref)
    nz_row = phase_newton_zupt_ensemble(en_ref, calibs, runs)
    del calibs, runs
    rd_ref = convert.load_reference(RENDERED_REF)
    rsim, rparams, rrun = phase_sim_staging_rendered(rd_ref)
    imgs = phase_render(rsim, rparams, rd_ref, smi)
    phase_tracker_staged(imgs, rsim, rparams, rd_ref, smi)
    phase_descriptor(imgs, rsim, rd_ref)
    del imgs
    phase_rendered_replay(rd_ref)
    rd_row = phase_main_path_rendered(rsim, rparams, rrun, rd_ref, smi)
    del rsim, rrun
    phase_static_init()
    phase_dynamic_init()
    _, _, v_run, v_calib = staged["v102_replay"]
    ai_row, ai_run, ai_calib = phase_auto_init_v102((v_run, v_calib))
    phase_background_init(ai_run, ai_calib)
    sd_rows = phase_single_depth(run, calib)
    ar_row = phase_aruco()
    cf_row = phase_config(run, calib)
    rs_row, carry = phase_resume(run, calib, smi)
    phase_profiling(carry, run, smi)
    del carry
    phase_window_refine(smi)
    phase_parallel(smi)
    dr_row = phase_dryrun(smi)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    dd = dd_rows[OPPOINT_SHAPE + (True,)]
    qr = qr_rows[("oppoint_stack", 544, 271)]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "symmetric_downdate", "route": "cuda",
        "source": "open_vins_tpu_torch/ops/csrc/symmetric_downdate.cu",
        "replaces": "open_vins_tpu/ops/pallas_kernels.py:32",
        "launches": op_row["launches"]["symmetric_downdate"],
        "launches_largemap": lm_row["launches"]["symmetric_downdate"],
        "launches_v102_replay": rp_row["launches"]["symmetric_downdate"],
        "launches_ensemble8": en_row["launches"]["symmetric_downdate"],
        **{f"launches_{form}": r["launches"]["symmetric_downdate"]
           for form, r in form_rows.items()},
        "launches_sequential": seq_row["launches"]["symmetric_downdate"],
        "launches_zupt": zupt_row["launches"]["symmetric_downdate"],
        "launches_ensemble8_newton_zupt":
            nz_row["launches"]["symmetric_downdate"],
        "launches_rendered": rd_row["launches"]["symmetric_downdate"],
        "launches_auto_init_replay":
            ai_row["launches"]["symmetric_downdate"],
        **{f"launches_{name}": r["launches"]["symmetric_downdate"]
           for name, r in sd_rows.items()},
        "launches_aruco": ar_row["launches"]["symmetric_downdate"],
        "launches_config": cf_row["launches"]["symmetric_downdate"],
        "launches_resume": rs_row["launches"]["symmetric_downdate"],
        "launches_dryrun_ranks": dr_row["launches"]["symmetric_downdate"],
        **_kernel_numbers(dd),
        "k_not_pht": [{"operands": name, "shape": [r["D"], r["m"]],
                       "library": "torch.addmm", **_kernel_numbers(r)}
                      for name, r in kf_rows.items()],
        "batched": [{"shape": list(k[:3]), "K_is_PHt": True,
                     "library": "torch.baddbmm",
                     **_kernel_numbers(bd_rows[k])}
                    for k in (ENSEMBLE_SHAPE + (True,), (8, 120, 81, True))],
    }, {
        "name": "householder_qr_blocks", "route": "cuda",
        "source": "open_vins_tpu_torch/ops/csrc/householder_qr_blocks.cu",
        "replaces": "open_vins_tpu/ops/pallas_kernels.py:115",
        "launches": tsqr_launches,
        **_kernel_numbers(qr),
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
