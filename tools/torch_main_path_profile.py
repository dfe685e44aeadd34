"""Where a frame of the PyTorch port's main path spends its time on the GPU.

    python tools/torch_main_path_profile.py
        [--config msckf|oppoint|woodbury|spd|newton|sequential|zupt|
                  largemap|replay|ensemble8|rendered|tracker|single|
                  single_sequential|aruco|dyninit|autoinit]
        [--warm 40] [--frames 40]

Steps a closed loop (`models/manager.step_frame`) through `--warm` frames,
then traces the next `--frames` frames with `torch.profiler` and prints one
JSON line: host wall time per frame, GPU kernel launches and busy time per
frame, the GPU's idle share of the wall time, the hand-written kernels'
launches, the host time spent in delayed init's one read of a device flag
(the `updater_slam.INIT_FLAG_READ` range: the wait for the queued GPU work
plus the few operations that form the flag) and in the ZUPT decision's
(`manager.ZUPT_FLAG_READ`), and the kernels that take the most device
time.  The host time per frame is taken on a second, untraced
window of as many frames.
`msckf` is the MSCKF-only configuration of the staged run
`open_vins_tpu_torch/data/msckf_sim20_seed0.npz`; `oppoint` is the bench's
operating point (SLAM, ACI², the joint "qr" update) of
`open_vins_tpu_torch/data/oppoint_sim20_seed0_ref.npz` on the same frames;
`woodbury`, `spd` and `newton` are the operating point in those joint
forms and `sequential` in the reference-exact sequential ordering (the
configurations of `oppoint_{form}_sim20_seed0_ref.npz` and
`sequential_sim20_seed0_ref.npz`), on the same frames; `zupt` is the
operating point's widths with ZUPT on the stop-and-go stream of
`zupt_stopgo20_seed0_ref.npz`, staged on the card (the trajectory is
chip_smoke.py's `stop_and_go_trajectory`);
`largemap` (bench.py's large map, D = 1434, 159 frames) and `replay` (the
V1_02 replay in ANCHORED_MSCKF_INVERSE_DEPTH, 799 frames) are staged on the
card by the port's simulator from the configuration of
`largemap_sim8_seed0_ref.npz` and `v102_replay40_seed0_ref.npz`;
`ensemble8` is bench.py's 8-seed ensemble of the operating point
(`ensemble8_sim20_ref.npz`), staged by `runner.stage_ensemble` and stepped
by `runner.ensemble_step` (one batched step per frame for all 8 streams,
so "per frame" means per batched frame of 8 stream frames; delayed init
selects on the device and reads no flag).  `rendered` is bench.py's
images->pose pipeline (752x480 stereo, `rendered_stereo8_seed0_ref.npz`,
staged on the card): every frame renders both cameras, tracks them
(`runner.render_and_track`) and steps the filter on the tracker's packets;
`tracker` is the tracker alone (`runner.track_images`) on the same stream's
images rendered up front.  `single` and `single_sequential` are the
operating point with ANCHORED_INVERSE_DEPTH_SINGLE landmarks in the joint
"qr" update and in the sequential ordering
(`oppoint_single_sim20_seed0_ref.npz`, `sequential_single_sim20_seed0_ref
.npz`) on the fixture's frames; `aruco` is tests/test_aruco_sigma.py's
stream with aruco landmarks (`aruco_sim5_seed3_ref.npz`, 99 frames, staged
on the card; the warm-up shrinks to fit).

`dyninit` and `autoinit` profile initialization attempts instead of
frames: `dyninit` one routed dynamic attempt (`router.try_initialize`) on
tests/test_dynamic_init.py's seed-11 problem (`dyninit_seed11_ref.npz`,
after one untraced attempt), `autoinit` the whole routed search of
`runner.auto_init_state` on the V1_02 replay (`v102_autoinit_seed0_ref
.npz`'s stream, the port's CPU staging moved to the card); each prints the
attempts, host ms, GPU kernels and busy ms per attempt, the GPU's idle
share and the host ms of the attempt's one read of its success flag (the
`router.INIT_SUCCESS_READ` range).  Needs a CUDA device; the card's name
and power limit are printed with the numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from open_vins_tpu_torch import convert  # noqa: E402
from open_vins_tpu_torch.core.layout import FilterConfig  # noqa: E402
from open_vins_tpu_torch.models import feature_table as ft  # noqa: E402
from open_vins_tpu_torch.models import manager, runner  # noqa: E402
from open_vins_tpu_torch.models import triangulation as tri  # noqa: E402
from open_vins_tpu_torch.models import updater_slam  # noqa: E402
from open_vins_tpu_torch.frontend import klt, ransac  # noqa: E402
from open_vins_tpu_torch.init import router  # noqa: E402
from open_vins_tpu_torch.ops import kernels, lie  # noqa: E402
from open_vins_tpu_torch.sim import render, simulator  # noqa: E402

DATA = os.path.join(ROOT, "open_vins_tpu_torch", "data")
FIXTURE = os.path.join(DATA, "msckf_sim20_seed0.npz")
OPPOINT_REF = os.path.join(DATA, "oppoint_sim20_seed0_ref.npz")
STAGED_REFS = {"largemap": os.path.join(DATA, "largemap_sim8_seed0_ref.npz"),
               "replay": os.path.join(DATA, "v102_replay40_seed0_ref.npz"),
               "aruco": os.path.join(DATA, "aruco_sim5_seed3_ref.npz")}
ENSEMBLE_REF = os.path.join(DATA, "ensemble8_sim20_ref.npz")
# configurations on the fixture's frames, each with its reference file
FRAME_REFS = {"oppoint": OPPOINT_REF,
              "sequential": os.path.join(DATA,
                                         "sequential_sim20_seed0_ref.npz"),
              **{form: os.path.join(DATA, f"oppoint_{form}_sim20_seed0_ref.npz")
                 for form in ("woodbury", "spd", "newton")},
              "single": os.path.join(DATA,
                                     "oppoint_single_sim20_seed0_ref.npz"),
              "single_sequential": os.path.join(
                  DATA, "sequential_single_sim20_seed0_ref.npz")}
DYNINIT_REF = os.path.join(DATA, "dyninit_seed11_ref.npz")
AUTOINIT_REF = os.path.join(DATA, "v102_autoinit_seed0_ref.npz")
ZUPT_REF = os.path.join(DATA, "zupt_stopgo20_seed0_ref.npz")
RENDERED_REF = os.path.join(DATA, "rendered_stereo8_seed0_ref.npz")
FLAG_READS = {"init": updater_slam.INIT_FLAG_READ,
              "zupt": manager.ZUPT_FLAG_READ,
              "init_success": router.INIT_SUCCESS_READ}


def _union_us(intervals):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def profile_init(config):
    """The `dyninit` and `autoinit` configurations (module docstring)."""
    if config == "dyninit":
        with __import__("numpy").load(DYNINIT_REF) as z:
            inp = convert.dyn_input_from_numpy(
                {k[len("recover_in_"):]: z[k] for k in z.files
                 if k.startswith("recover_in_")}, "cuda")
        ropts = router.RouterOptions()
        imu = torch.zeros((3, 8), device="cuda")

        def run():
            # the disparities route dynamic; the static buffer is unused
            kind, _ = router.try_initialize(ropts, imu[0], imu[1:].T,
                                            imu[1:].T, 0.0, 99.0, 99.0,
                                            dyn_input=inp)
            return [kind]

        run()
    else:
        ref = convert.load_reference(AUTOINIT_REF)
        meta = ref["meta"]
        sim, params, run_c = convert.stage_stream(meta, "cpu")
        run_d = runner._to(run_c, "cuda")
        calib = runner._to(runner.sim_calib(sim), "cuda")
        cfg = FilterConfig(**meta["cfg"])

        def run():
            attempts = []
            runner.auto_init_state(run_d, calib, cfg, params,
                                   max_search_s=meta["max_search_s"],
                                   device="cuda", attempts=attempts)
            return [a[1] for a in attempts]

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        kinds = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in FLAG_READS.values()]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in gpu])
    reads = [e.time_range.elapsed_us() for e in prof.events()
             if e.name == router.INIT_SUCCESS_READ
             and e.device_type == torch.autograd.DeviceType.CPU]
    n = max(len(kinds), 1)
    print(json.dumps({
        "config": config, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": _smi(), "attempts": len(kinds), "kinds": kinds,
        "traced_host_ms_per_attempt": 1e3 * wall_s / n,
        "gpu_kernels_per_attempt": len(gpu) / n,
        "gpu_busy_ms_per_attempt": busy_us / 1e3 / n,
        "gpu_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "success_reads": len(reads),
        "success_read_host_ms": sum(reads) / 1e3}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="msckf",
                    choices=("msckf", *FRAME_REFS, "zupt", *STAGED_REFS,
                             "ensemble8", "rendered", "tracker", "dyninit",
                             "autoinit"))
    ap.add_argument("--warm", type=int, default=40)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    if args.config in ("dyninit", "autoinit"):
        profile_init(args.config)
        return

    opts = tri.TriangulationOptions()
    tracked = []  # the front end's valid tracks per traced frame
    if args.config in ("rendered", "tracker"):
        ref = convert.load_reference(RENDERED_REF)
        meta = ref["meta"]
        cfg = FilterConfig(**meta["cfg"])
        kp = klt.KltParams(**meta["klt"])
        sim, params, run = convert.stage_stream(meta, "cuda")
        sets_of = ransac.sampler(torch.Generator(device="cuda").manual_seed(
            0))
        if args.config == "tracker":
            imgs = runner.render_frames(sim, params,
                                        simulator.n_cam_frames(params),
                                        device="cuda")
            tstate = runner.start_tracker(sim.cam_intr, params, kp,
                                          "STRETCH", sets_of, imgs[0])

            def step(k):
                nonlocal tstate
                tstate, _, _, _, mask = runner.track_images(
                    tstate, imgs[k + 1], sim.cam_intr, params, kp, False,
                    "STRETCH", sets_of)
                tracked.append(mask.sum())
                return None
        else:
            state = runner._initial_state(cfg, runner.sim_calib(sim), run)
            table = ft.init_table(cfg, meta["max_tracks"], "cuda")
            tstate = runner.start_tracker(
                sim.cam_intr, params, kp, "STRETCH", sets_of,
                render.render(sim, params, [0])[0])

            def step(k):
                nonlocal state, table, tstate
                tstate, ids, uv, uvn, mask = runner.render_and_track(
                    tstate, sim, params, kp, k + 1, False, "STRETCH",
                    sets_of)
                frame = runner.frame_at(run.frames, k).replace(
                    ids=ids, uv=uv, uvn=uvn, mask=mask)
                state, table, diag = manager.step_frame(state, table, cfg,
                                                        opts, frame)
                tracked.append(mask.sum())
                return diag
    elif args.config == "ensemble8":
        ref = convert.load_reference(ENSEMBLE_REF)
        meta = ref["meta"]
        cfg = FilterConfig(**meta["cfg"])
        calibs, runs = runner.stage_ensemble(
            simulator.SimParams(**meta["sim"]), meta["seeds"], "cuda")
        state, table = runner.ensemble_start(cfg, calibs, runs,
                                             meta["max_tracks"])
        batched = runner.ensemble_step(cfg, opts)

        def step(k):
            nonlocal state, table
            state, table, diag = batched(state, table,
                                         runner.ensemble_frame(runs, k))
            return diag
    else:
        if args.config in STAGED_REFS:
            ref = convert.load_reference(STAGED_REFS[args.config])
            sim, _, run = convert.stage_stream(ref["meta"], "cuda")
            calib = runner.sim_calib(sim)
        elif args.config == "zupt":
            from chip_smoke import stop_and_go_trajectory

            ref = convert.load_reference(ZUPT_REF)
            meta = ref["meta"]
            traj = tuple(torch.as_tensor(a, device="cuda")
                         for a in stop_and_go_trajectory(
                             meta["sim"]["duration"]
                             + 2.0 * meta["sim"]["start_offset"] + 2.0,
                             **meta["traj"]["stop_and_go"]))
            sim, _, run = convert.stage_stream(meta, "cuda", traj=traj)
            calib = runner.sim_calib(sim)
        else:
            run, calib, ref = convert.load_staged_run(FIXTURE, "cuda")
        if args.config in FRAME_REFS:
            ref = convert.load_reference(FRAME_REFS[args.config])
        cfg = FilterConfig(**ref["meta"]["cfg"])
        state = manager.initialize_from_gt(
            cfg, run.gt_q[0], run.gt_p[0], run.gt_v[0], calib.bias_g0,
            calib.bias_a0, 0.0, calib_ext_q=lie.rot_2_quat(calib.cam_R_ItoC),
            calib_ext_p=calib.cam_p_IinC, calib_intr=calib.cam_intr)
        table = ft.init_table(cfg, ref["meta"]["max_tracks"], "cuda")

        def step(k):
            nonlocal state, table
            state, table, diag = manager.step_frame(
                state, table, cfg, opts, runner.frame_at(run.frames, k))
            return diag

    if args.config in STAGED_REFS or args.config in FRAME_REFS:
        # a short stream: the warm-up shrinks so both windows fit
        args.warm = max(0, min(args.warm, run.frames.t_new.shape[0]
                               - 2 * args.frames))
    for k in range(args.warm):
        step(k)
    torch.cuda.synchronize()

    n = args.frames
    frames = range(args.warm, args.warm + n)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    kernels.symmetric_downdate.launches = 0
    kernels.householder_qr_blocks.launches = 0
    diags = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in frames:
            diags.append(step(k))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = {"symmetric_downdate": kernels.symmetric_downdate.launches,
                "householder_qr_blocks":
                    kernels.householder_qr_blocks.launches}
    # the same number of frames again, untraced: the host time without the
    # profiler's own overhead
    t0 = time.perf_counter()
    for k in range(args.warm + n, args.warm + 2 * n):
        step(k)
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0

    # kernels only: the profiler also puts record_function ranges on the
    # GPU timeline
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in FLAG_READS.values()]
    spans = [(e.time_range.start, e.time_range.end) for e in gpu]
    busy_us = _union_us(spans)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in gpu:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # the host's ranges only
    flag_reads = {k: [e.time_range.elapsed_us() for e in prof.events()
                      if e.name == name
                      and e.device_type == torch.autograd.DeviceType.CPU]
                  for k, name in FLAG_READS.items()}
    smi = _smi()

    def mean(key):
        if diags[0] is None:  # the tracker alone
            return None
        return float(torch.stack([getattr(d, key) for d in diags])
                     .float().mean())

    def largest(key):
        if diags[0] is None:
            return None
        return float(torch.stack([getattr(d, key) for d in diags]).max())

    print(json.dumps({
        "config": args.config, "state_dim": cfg.state_dim,
        "streams_per_frame": (len(meta["seeds"]) if args.config == "ensemble8"
                              else 1),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "frames": n, "first_frame": args.warm,
        "n_msckf_mean": mean("n_msckf"), "n_slam_mean": mean("n_slam"),
        "n_slam_used_mean": mean("n_slam_used"),
        "tracks_per_frame": (float(torch.stack(tracked[-2 * n:-n]).float()
                                   .mean()) if tracked else None),
        "host_ms_per_frame": 1e3 * plain_wall_s / n,
        "traced_host_ms_per_frame": 1e3 * wall_s / n,
        "gpu_kernels_per_frame": len(gpu) / n,
        "gpu_busy_ms_per_frame": busy_us / 1e3 / n,
        "gpu_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "launches": launches,
        **{f"{k}_flag_reads_per_frame": len(v) / n
           for k, v in flag_reads.items()},
        **{f"{k}_flag_read_host_ms_per_frame": sum(v) / 1e3 / n
           for k, v in flag_reads.items()},
        **{f"{k}_flag_read_host_ms_max": max(v, default=0.0) / 1e3
           for k, v in flag_reads.items()},
        "zupt_frames": sum(int((d.n_msckf == 0) & (d.n_slam_used == 0))
                           for d in diags) if args.config == "zupt" else None,
        "newton_resid_max": largest("newton_resid"),
        "top_kernels": [{"name": k[:80], "calls_per_frame": c / n,
                         "us_per_frame": us / n} for k, (c, us) in top],
    }))


if __name__ == "__main__":
    main()
