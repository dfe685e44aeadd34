"""Closed-loop runner: stage the sensor stream, initialize from groundtruth
and step the filter over the staged frames.

Counterpart of `stage_run`, `run_filter` and `run_filter_from` in
`open_vins_tpu/models/runner.py` (run_simulation.cpp:34-110): the reference
scans the step with `lax.scan`; here a Python loop calls
`manager.step_frame` once per frame and stacks the same outputs.  The frames
come from the port's simulator (`stage_run`) or from a staged-run file
(`open_vins_tpu_torch/convert.py`).

`run_filter_rendered` is the images->pose pipeline (runner.py:145-289 of
the reference): every frame the simulator's map is rendered into camera
images (`sim.render`), tracked by the KLT front end with fundamental-matrix
RANSAC (`frontend.tracker`), and the tracker's packets replace the staged
TrackSIM measurements in `manager.step_frame`.  `run_tracker_rendered`,
`render_frames` and `run_tracker_staged` are its front-end-only parts (the
bench's render and tracker metrics, bench.py:284-380).  The RANSAC
hypotheses come from a given `sets_of`, else from a `torch.Generator` on the
run's device seeded with 0.

`auto_init_state` is the replay's own routed initialization (static or
dynamic, `init/router.py`), whose state `run_filter_from` takes instead of
groundtruth.

`stage_ensemble` and `run_ensemble` are the bench's seed ensemble
(bench.py:227-282): B streams of one configuration, one seed each, stepped
frame by frame as one batched step, `manager.step_frame` under
`torch.func.vmap` (the reference runs `jax.vmap(run_filter)`);
`ensemble_metrics` gives each stream's RMSE and NEES and the seed-mean
NEES.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils._pytree as pytree

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.frontend import ransac
from open_vins_tpu_torch.frontend import tracker as tracker_mod
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import manager
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.models.propagator import ImuWindow
from open_vins_tpu_torch.ops import lie
from open_vins_tpu_torch.sim import render, simulator


@dataclasses.dataclass
class SimRun(TensorRecord):
    frames: manager.FrameInput  # batched over frames (leading axis)
    gt_q: torch.Tensor  # [Kf, 4]
    gt_p: torch.Tensor  # [Kf, 3]
    gt_v: torch.Tensor  # [Kf, 3]


@dataclasses.dataclass
class SimCalib(TensorRecord):
    """What `run_filter` reads of the simulator: true initial biases and
    the camera calibration."""

    bias_g0: torch.Tensor  # [3]
    bias_a0: torch.Tensor  # [3]
    cam_R_ItoC: torch.Tensor  # [N, 3, 3]
    cam_p_IinC: torch.Tensor  # [N, 3]
    cam_intr: torch.Tensor  # [N, 8]


def stage_run(sim: simulator.SimData, params: simulator.SimParams) -> SimRun:
    """The whole sensor stream packed per frame, on the simulator's device.

    Frame k (1..n_frames-1; frame 0 is the initial state) takes the IMU
    steps [(k-1)·ipc, k·ipc], both ends included: the rates divide, so no
    interpolation is needed."""
    ipc = simulator.imu_per_cam(params)
    n_frames = simulator.n_cam_frames(params)
    dev = sim.map_pts.device
    imu = simulator.get_imu(sim, params, torch.arange(
        simulator.n_imu_steps(params) + 1, device=dev))
    cams = simulator.get_cam(sim, params, torch.arange(n_frames, device=dev))
    win = ((torch.arange(1, n_frames, device=dev)[:, None] - 1) * ipc
           + torch.arange(ipc + 1, device=dev)[None, :])  # [K-1, ipc+1]
    frames = manager.FrameInput(
        win=ImuWindow(t=imu.t[win], w=imu.wm[win], a=imu.am[win]),
        t_new=cams.t[1:], ids=cams.ids[1:], uv=cams.uvs[1:],
        uvn=cams.uvs_norm[1:], mask=cams.mask[1:])
    gt_q, gt_p, gt_v, _, _ = simulator.get_state(sim, params, cams.t)
    return SimRun(frames=frames, gt_q=gt_q, gt_p=gt_p, gt_v=gt_v)


def sim_calib(sim: simulator.SimData) -> SimCalib:
    """What `run_filter` reads of a simulator the port built."""
    return SimCalib(bias_g0=sim.bias_g_traj[0], bias_a0=sim.bias_a_traj[0],
                    cam_R_ItoC=sim.cam_R_ItoC, cam_p_IinC=sim.cam_p_IinC,
                    cam_intr=sim.cam_intr)


def frame_at(frames: manager.FrameInput, k: int) -> manager.FrameInput:
    """Frame k of a batch of frames."""
    return pytree.tree_map(lambda a: a[k], frames)


def stack_records(records, dim: int = 0):
    """Records of one type (nested records too) stacked field by field along
    a new dimension `dim`."""
    return pytree.tree_map(lambda *xs: torch.stack(xs, dim=dim), *records)


def record_at(record, b: int):
    """Stream b of a record stacked over streams."""
    return pytree.tree_map(lambda a: a[b], record)


def _to(record, device):
    """A record of tensors (nested records too) moved to `device`."""
    return pytree.tree_map(lambda v: v.to(device), record)


def _initial_state(cfg: FilterConfig, calib: SimCalib, run: SimRun):
    """The groundtruth start of a run at frame 0, on the run's device."""
    return manager.initialize_from_gt(
        cfg, run.gt_q[0], run.gt_p[0], run.gt_v[0], calib.bias_g0,
        calib.bias_a0, 0.0,
        calib_ext_q=lie.rot_2_quat(calib.cam_R_ItoC),
        calib_ext_p=calib.cam_p_IinC,
        calib_intr=calib.cam_intr,
    )


def _per_frame(state, diag):
    """The outputs kept per frame: (q, p, v, cov[:6,:6], diag)."""
    return state.q, state.p, state.v, state.cov[..., :6, :6], diag


def run_filter(cfg: FilterConfig, tri_opts: tri.TriangulationOptions,
               calib: SimCalib, run: SimRun, max_tracks: int = 256,
               device=None):
    """Init from groundtruth at frame 0 and step the filter over all frames
    on `device` (None = CUDA).

    Returns (final_state, per-frame (q, p, v, cov[:6,:6], diag)) with each
    output stacked over frames."""
    dev = resolve_device(device)
    run, calib = _to(run, dev), _to(calib, dev)
    state = _initial_state(cfg, calib, run)
    table = ft.init_table(cfg, max_tracks, dev)
    outs = []
    for k in range(run.frames.t_new.shape[0]):
        state, table, diag = manager.step_frame(state, table, cfg, tri_opts,
                                                frame_at(run.frames, k))
        outs.append(_per_frame(state, diag))
    return state, stack_records(outs)


def track_images(tstate, imgs, cam_intr, params: simulator.SimParams,
                 klt_params, first, hist_method, sets_of):
    """The KLT front end on the images [C, H, W] of one frame: (tstate,
    ids [C, P], uv, uvn, mask) in FrameInput layout."""
    if params.num_cams >= 2:
        return tracker_mod.track_frame_multi(
            tstate, imgs, cam_intr, klt_params, sets_of,
            cam_model=params.cam_model, first_frame=first,
            hist_method=hist_method)
    tstate, ids, uv, uvn, mask = tracker_mod.track_frame(
        tstate, imgs[0], cam_intr[0], klt_params, sets_of,
        cam_model=params.cam_model, first_frame=first,
        hist_method=hist_method)
    return tstate, ids[None], uv[None], uvn[None], mask[None]


def render_and_track(tstate, sim, params, klt_params, k, first,
                     hist_method, sets_of):
    """Render every camera at frame k and track the images."""
    imgs = render.render(sim, params, [k])[0]
    return track_images(tstate, imgs, sim.cam_intr, params, klt_params,
                        first, hist_method, sets_of)


def start_tracker(cam_intr, params, klt_params, hist_method, sets_of,
                  imgs0):
    """A tracker primed on the images [C, H, W] of frame 0 (the initial
    state's frame): detection only."""
    tstate = tracker_mod.init_tracker(params.height, params.width,
                                      klt_params.num_features,
                                      device=cam_intr.device)
    tstate, *_ = track_images(tstate, imgs0, cam_intr, params, klt_params,
                              True, hist_method, sets_of)
    return tstate


def run_filter_rendered(cfg: FilterConfig, tri_opts: tri.TriangulationOptions,
                        sim: simulator.SimData, params: simulator.SimParams,
                        run: SimRun, klt_params, max_tracks: int = 256,
                        hist_method: str = "STRETCH", sets_of=None,
                        device=None):
    """The images->pose pipeline on `device` (None = CUDA): start from
    groundtruth at frame 0, prime the tracker on frame 0's images, then per
    frame render every camera, track, and step the filter on the tracker's
    packets (the reference's serial image replay,
    ros1_serial_msckf.cpp:210-278).

    Returns ((state, table, tracker state), per-frame (q, p, v,
    cov[:6,:6], diag, tracked)) stacked over frames: `tracked` is the
    number of valid tracks in the frame's packet over all cameras."""
    dev = resolve_device(device)
    sim, run = _to(sim, dev), _to(run, dev)
    if sets_of is None:  # the reference init_tracker's default key, 0
        sets_of = ransac.sampler(torch.Generator(device=dev).manual_seed(0))
    state = _initial_state(cfg, sim_calib(sim), run)
    table = ft.init_table(cfg, max_tracks, dev)
    tstate = start_tracker(sim.cam_intr, params, klt_params, hist_method,
                           sets_of, render.render(sim, params, [0])[0])
    outs = []
    for k in range(1, run.frames.t_new.shape[0] + 1):
        tstate, ids, uv, uvn, mask = render_and_track(
            tstate, sim, params, klt_params, k, False, hist_method, sets_of)
        frame = frame_at(run.frames, k - 1).replace(ids=ids, uv=uv, uvn=uvn,
                                                    mask=mask)
        state, table, diag = manager.step_frame(state, table, cfg, tri_opts,
                                                frame)
        outs.append(_per_frame(state, diag) + (mask.sum(),))
    return (state, table, tstate), stack_records(outs)


def run_tracker_rendered(sim: simulator.SimData, params: simulator.SimParams,
                         klt_params, n_frames: int,
                         hist_method: str = "STRETCH", sets_of=None,
                         device=None):
    """The front end alone: render and track `n_frames` frames (no
    filter).  Returns (final tracker state, per-frame track counts over all
    cameras [n_frames - 1]) — bench.py's `klt_track_frames_per_sec_1chip`
    unit."""
    dev = resolve_device(device)
    sim = _to(sim, dev)
    if sets_of is None:  # the reference init_tracker's default key, 0
        sets_of = ransac.sampler(torch.Generator(device=dev).manual_seed(0))
    tstate = start_tracker(sim.cam_intr, params, klt_params, hist_method,
                           sets_of, render.render(sim, params, [0])[0])
    counts = []
    for k in range(1, n_frames):
        tstate, _, _, _, mask = render_and_track(
            tstate, sim, params, klt_params, k, False, hist_method, sets_of)
        counts.append(torch.sum(mask.to(torch.int32)))
    return tstate, torch.stack(counts)


def render_frames(sim: simulator.SimData, params: simulator.SimParams,
                  n_frames: int, device=None):
    """Every camera's images of frames 0..n_frames-1, [n_frames, C, H, W],
    rendered as one batched call (the render half of the front end's cost,
    bench.py's `frontend_render_ms_per_frame`)."""
    dev = resolve_device(device)
    sim = _to(sim, dev)
    return render.render(sim, params, torch.arange(n_frames, device=dev))


def run_tracker_staged(imgs, sim, params: simulator.SimParams, klt_params,
                       hist_method: str = "STRETCH", sets_of=None,
                       device=None):
    """The tracker alone over given images [K, C, H, W] (the role of camera
    frames arriving from a sensor): frame 0 primes it, frames 1.. are
    tracked.  `sim` gives the intrinsics (`cam_intr`).  Returns (final
    tracker state, per-frame track counts over all cameras [K - 1])."""
    dev = resolve_device(device)
    imgs, cam_intr = imgs.to(dev), sim.cam_intr.to(dev)
    if sets_of is None:  # the reference init_tracker's default key, 0
        sets_of = ransac.sampler(torch.Generator(device=dev).manual_seed(0))
    tstate = start_tracker(cam_intr, params, klt_params, hist_method,
                           sets_of, imgs[0])
    counts = []
    for k in range(1, imgs.shape[0]):
        tstate, _, _, _, mask = track_images(
            tstate, imgs[k], cam_intr, params, klt_params, False,
            hist_method, sets_of)
        counts.append(torch.sum(mask.to(torch.int32)))
    return tstate, torch.stack(counts)


def stage_ensemble(params: simulator.SimParams, seeds, device=None):
    """One stream per seed (`simulator.draw(params, seed)`, the sine
    trajectory), each built and staged on `device` (None = CUDA) as
    `convert.stage_stream` stages one, then stacked.

    Returns (calibs, runs): a SimCalib and a SimRun whose every field has a
    leading stream axis B = len(seeds)."""
    dev = resolve_device(device)
    calibs, runs = [], []
    for seed in seeds:
        sim = simulator.build(params, seed=seed,
                              draws=simulator.draw(params, seed), device=dev)
        calibs.append(sim_calib(sim))
        runs.append(stage_run(sim, params))
    return stack_records(calibs), stack_records(runs)


def run_ensemble(cfg: FilterConfig, tri_opts: tri.TriangulationOptions,
                 calibs: SimCalib, runs: SimRun, max_tracks: int = 384,
                 device=None):
    """`run_filter` over B streams at once (bench.py:233-236): each stream
    starts from its groundtruth at frame 0, then every frame is one call of
    `manager.step_frame` vmapped over the streams (`batched=True`), whose
    covariance downdate is one batched kernel launch.

    calibs, runs: stacked over streams (`stage_ensemble`).  Returns
    (final batched state, per-frame (q, p, v, cov[:6,:6], diag)) with each
    output [B, frames, ...]."""
    dev = resolve_device(device)
    runs, calibs = _to(runs, dev), _to(calibs, dev)
    state, table = ensemble_start(cfg, calibs, runs, max_tracks)
    step = ensemble_step(cfg, tri_opts)
    outs = []
    for k in range(runs.frames.t_new.shape[1]):
        state, table, diag = step(state, table, ensemble_frame(runs, k))
        outs.append(_per_frame(state, diag))
    return state, stack_records(outs, dim=1)


def ensemble_start(cfg: FilterConfig, calibs: SimCalib, runs: SimRun,
                   max_tracks: int):
    """(state, table) of every stream at frame 0, stacked over streams, on
    the runs' device: each stream's groundtruth start and an empty
    table."""
    B = runs.gt_p.shape[0]
    state = stack_records([_initial_state(cfg, record_at(calibs, b),
                                          record_at(runs, b))
                           for b in range(B)])
    table = stack_records([ft.init_table(cfg, max_tracks,
                                         runs.gt_p.device)] * B)
    return state, table


def ensemble_step(cfg: FilterConfig, tri_opts: tri.TriangulationOptions):
    """The batched frame step: (state, table, frame) stacked over streams
    -> (state, table, diag) stacked over streams."""
    return torch.func.vmap(lambda st, tb, fr: manager.step_frame(
        st, tb, cfg, tri_opts, fr, batched=True))


def ensemble_frame(runs: SimRun, k: int) -> manager.FrameInput:
    """Frame k of every stream of a run stacked over streams."""
    return pytree.tree_map(lambda a: a[:, k], runs.frames)


def run_filter_from(cfg: FilterConfig, tri_opts: tri.TriangulationOptions,
                    run: SimRun, state0, k0: int, max_tracks: int = 256,
                    device=None, diags=None):
    """`run_filter`, but from a given initial state at frame index k0 (the
    replay's real-initialization entry, InertialInitializer.cpp:104-158 →
    VioManagerHelper.cpp:78-188).  The first frame stepped is k0, whose IMU
    window starts at `run.frames.t_new[k0-1]` = `state0.t`; the outputs of
    the frames before k0 hold `state0`, as the reference's skipped scan
    steps do.

    Returns (final_state, per-frame (q, p, v, cov[:6,:6])) stacked over all
    frames (no StepDiag, as in the reference; a list `diags` gets each
    stepped frame's)."""
    dev = resolve_device(device)
    run = _to(run, dev)
    state = _to(state0, dev)
    table = ft.init_table(cfg, max_tracks, dev)
    n = run.frames.t_new.shape[0]
    outs = [(state.q, state.p, state.v, state.cov[:6, :6])] * min(k0, n)
    for k in range(k0, n):
        state, table, diag = manager.step_frame(state, table, cfg, tri_opts,
                                                frame_at(run.frames, k))
        outs.append((state.q, state.p, state.v, state.cov[:6, :6]))
        if diags is not None:
            diags.append(diag)
    return state, stack_records(outs)


def pose_metrics(qs, ps, covs6, gt_q, gt_p):
    """(position RMSE [m], mean pose NEES) of a run, as bench.py computes
    them: outputs index k is frame k+1, NEES over the last three quarters of
    the frames, error δp = gt − est and δθ = −log(R_gt R_estᵀ)."""
    qs, ps = qs.detach().cpu(), ps.detach().cpu().numpy()
    covs6 = covs6.detach().cpu().numpy()
    gt_q, gt_p = gt_q.detach().cpu()[1:], gt_p.detach().cpu().numpy()[1:]
    rmse = float(np.sqrt(((gt_p - ps) ** 2).sum(1).mean()))
    R_est, R_gt = lie.quat_2_rot(qs), lie.quat_2_rot(gt_q)
    nf = len(gt_p)
    dth = -lie.log_so3(R_gt @ R_est.mT).numpy()
    nees = []
    for k in range(nf // 4, nf):
        e = np.concatenate([dth[k], gt_p[k] - ps[k]])
        nees.append(e @ np.linalg.solve(covs6[k] + 1e-12 * np.eye(6), e))
    return rmse, float(np.mean(nees))


def ensemble_metrics(outs, runs: SimRun):
    """Each stream's (RMSE, NEES) by `pose_metrics` and the seed-mean NEES
    and its spread, as bench.py:246-265 reads the ensemble: outs and runs
    stacked over streams (`run_ensemble`).  Returns a dict of numpy arrays
    `rmse` [B] and `nees` [B] and floats `rmse_median`, `nees_seed_mean`,
    `nees_seed_std` (numpy's population std, as the bench prints)."""
    qs, ps, _, covs6, _ = outs
    per = [pose_metrics(qs[b], ps[b], covs6[b], runs.gt_q[b], runs.gt_p[b])
           for b in range(qs.shape[0])]
    rmse, nees = (np.asarray(x) for x in zip(*per))
    return {"rmse": rmse, "nees": nees,
            "rmse_median": float(np.median(rmse)),
            "nees_seed_mean": float(nees.mean()),
            "nees_seed_std": float(nees.std())}


def imu_stream(run: SimRun):
    """The staged run's IMU samples as one host stream (imu_t [N],
    imu_w [N, 3], imu_a [N, 3], numpy): the frames' windows with the
    shared end samples once."""
    wt, ww, wa = (x.cpu().numpy() for x in (run.frames.win.t,
                                            run.frames.win.w,
                                            run.frames.win.a))
    return (np.concatenate([wt[:, :-1].reshape(-1), wt[-1, -1:]]),
            np.concatenate([ww[:, :-1].reshape(-1, 3), ww[-1:, -1]]),
            np.concatenate([wa[:, :-1].reshape(-1, 3), wa[-1:, -1]]))


def window_packer(imu_t, imu_w, imu_a):
    """make_window(t0, t1, K) -> (n, t [K+1], w [K+1, 3], a [K+1, 3]) over
    a host IMU stream: SensorHub::make_window's contract
    (native/sensor_hub.cpp; the replay's packer of
    examples/run_benchmark_suite.py:148-163): the samples in [t0, t1],
    padded by repeating the last (dt = 0 no-ops)."""
    def make_window(t0, t1, K):
        sel = (imu_t >= t0 - 1e-6) & (imu_t <= t1 + 1e-6)
        t, w, a = imu_t[sel], imu_w[sel], imu_a[sel]
        n = min(len(t), K + 1)
        T = np.full((K + 1,), t[n - 1] if n else 0.0)
        W = np.zeros((K + 1, 3))
        A = np.zeros((K + 1, 3))
        if n:
            T[:n], W[:n], A[:n] = t[:n], w[:n], a[:n]
            W[n:], A[n:] = w[n - 1], a[n - 1]
        return n, T, W, A

    return make_window


def auto_init_state(run: SimRun, sim, cfg: FilterConfig,
                    params: simulator.SimParams, max_search_s: float = 40.0,
                    device=None, attempts=None):
    """The routed initialization on a staged stream, on `device` (None =
    CUDA): the counterpart of `examples/run_benchmark_suite.py`'s
    `auto_init_state` (:126-230 of the reference, InertialInitializer.cpp:
    104-158).  Frame by frame the camera-0 track history grows; from 2 s on
    the two half-window disparities route static or dynamic (the dynamic
    problem on P = 6 poses ending at the newest frame, built by
    `router.build_dyn_input`), and the first success ends the search.  The
    attempt is synchronous: a replay loses no frame, so background
    initialization's catch-up has nothing to do.  `sim` gives the camera
    calibration (`cam_R_ItoC`, `cam_p_IinC`, `cam_intr`: a SimCalib or the
    simulator).  `attempts`, a list, gets one (frame, kind, seconds) per
    routed attempt.

    Returns (state0, k0, kind, t_init) with k0 the first frame index to
    process (state0.t == run.frames.t_new[k0 - 1]), or None when nothing
    initializes within `max_search_s`."""
    import time

    from open_vins_tpu_torch.init import router

    dev = resolve_device(device)
    f = run.frames
    ids, uv, uvn, mask = (x[:, 0].cpu().numpy()
                          for x in (f.ids, f.uv, f.uvn, f.mask))
    t_new = f.t_new.cpu().numpy()
    imu_t, imu_w, imu_a = imu_stream(run)
    make_window = window_packer(imu_t, imu_w, imu_a)
    ropts = router.RouterOptions(window_time=1.0, imu_thresh=1.0)
    w = ropts.window_time
    imu_t_d, imu_w_d, imu_a_d = (torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev)
                                 for x in (imu_t, imu_w, imu_a))
    R_ItoC = sim.cam_R_ItoC.to(dev)
    calib_q = lie.rot_2_quat(R_ItoC)
    cam_p, cam_intr = sim.cam_p_IinC.to(dev), sim.cam_intr.to(dev)
    hist = {}
    for k in range(len(t_new)):
        tk = float(t_new[k])
        if tk > max_search_s:
            break
        for i in np.where(mask[k])[0]:
            h = hist.setdefault(int(ids[k, i]), ([], [], []))
            h[0].append(tk)
            h[1].append(uv[k, i])
            h[2].append(uvn[k, i])
        if k < 8 or tk < 2.0 * w:
            continue
        ts_l = [v[0] for v in hist.values()]
        px_l = [v[1] for v in hist.values()]
        d1 = router.average_disparity(px_l, ts_l, tk - 2 * w, tk - w)
        d2 = router.average_disparity(px_l, ts_l, tk - w, tk)
        use_static, use_dynamic = router.decide(ropts, d1, d2)
        t0 = time.perf_counter()
        dyn_input = None
        if use_dynamic:
            P = 6
            stride = max(1, int(round(2 * w * params.cam_rate / (P - 1))))
            # the pose grid ends at the newest frame k: the state is
            # reported at the last pose time
            pose_ks = [j for j in (k - stride * (P - 1 - i) for i in range(P))
                       if j >= 0]
            t_poses = [float(t_new[j]) for j in pose_ks]
            hist_n = {fid: (ts, uvns) for fid, (ts, _, uvns) in hist.items()}
            dyn_input = router.build_dyn_input(
                hist_n, t_poses, make_window, R_ItoC[0].cpu().numpy(),
                cam_p[0].cpu().numpy(),
                K=int(params.imu_rate * 2 * w
                      / max(len(t_poses) - 1, 1)) + 4, device=dev)
        kind, res = router.try_initialize(ropts, imu_t_d, imu_w_d, imu_a_d,
                                          tk, d1, d2, dyn_input=dyn_input)
        if attempts is not None and (use_static or dyn_input is not None):
            attempts.append((k, kind, time.perf_counter() - t0))
        if kind == "none":
            continue
        if kind == "static":
            zero = torch.zeros(3, dtype=torch.float32, device=dev)
            st0 = manager.initialize_from_gt(
                cfg, res.q_GtoI, zero, zero, res.bg, res.ba, tk, calib_q,
                cam_p, cam_intr)
        else:
            st0 = manager.initialize_from_dynamic(cfg, res, tk, calib_q,
                                                  cam_p, cam_intr)
        return st0, k + 1, kind, tk
    return None
