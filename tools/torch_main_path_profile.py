"""Where a frame of the PyTorch port's main path spends its time on the GPU.

    python tools/torch_main_path_profile.py [--config msckf|oppoint]
                                            [--warm 40] [--frames 40]

Steps a closed loop (`models/manager.step_frame` over the staged run of
`open_vins_tpu_torch/data/msckf_sim20_seed0.npz`) through `--warm` frames,
then traces the next `--frames` frames with `torch.profiler` and prints one
JSON line: host wall time per frame, GPU kernel launches and busy time per
frame, the GPU's idle share of the wall time, the hand-written kernels'
launches, the host time spent in delayed init's one read of a device flag
(the `updater_slam.INIT_FLAG_READ` range: the wait for the queued GPU work
plus the few operations that form the flag), and the kernels that take the
most device time.  The host time per frame is taken on a second, untraced
window of as many frames.
`msckf` is the MSCKF-only configuration of the staged run; `oppoint` is the
bench's operating point (SLAM, ACI², the joint "qr" update) of
`open_vins_tpu_torch/data/oppoint_sim20_seed0_ref.npz`.  Needs a CUDA
device; the card's name and power limit are printed with the numbers.
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
from open_vins_tpu_torch.ops import kernels, lie  # noqa: E402

DATA = os.path.join(ROOT, "open_vins_tpu_torch", "data")
FIXTURE = os.path.join(DATA, "msckf_sim20_seed0.npz")
OPPOINT_REF = os.path.join(DATA, "oppoint_sim20_seed0_ref.npz")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("msckf", "oppoint"),
                    default="msckf")
    ap.add_argument("--warm", type=int, default=40)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()

    run, calib, ref = convert.load_staged_run(FIXTURE, "cuda")
    if args.config == "oppoint":
        ref = convert.load_reference(OPPOINT_REF)
    cfg = FilterConfig(**ref["meta"]["cfg"])
    opts = tri.TriangulationOptions()
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
           and e.name != updater_slam.INIT_FLAG_READ]
    spans = [(e.time_range.start, e.time_range.end) for e in gpu]
    busy_us = _union_us(spans)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in gpu:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # the host's range only
    flag_reads = [e.time_range.elapsed_us() for e in prof.events()
                  if e.name == updater_slam.INIT_FLAG_READ
                  and e.device_type == torch.autograd.DeviceType.CPU]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    def mean(key):
        return float(torch.stack([getattr(d, key) for d in diags])
                     .float().mean())

    print(json.dumps({
        "config": args.config, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "frames": n, "first_frame": args.warm,
        "n_msckf_mean": mean("n_msckf"), "n_slam_mean": mean("n_slam"),
        "n_slam_used_mean": mean("n_slam_used"),
        "host_ms_per_frame": 1e3 * plain_wall_s / n,
        "traced_host_ms_per_frame": 1e3 * wall_s / n,
        "gpu_kernels_per_frame": len(gpu) / n,
        "gpu_busy_ms_per_frame": busy_us / 1e3 / n,
        "gpu_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "launches": launches,
        "init_flag_reads_per_frame": len(flag_reads) / n,
        "init_flag_read_host_ms_per_frame": sum(flag_reads) / 1e3 / n,
        "init_flag_read_host_ms_max": max(flag_reads, default=0.0) / 1e3,
        "top_kernels": [{"name": k[:80], "calls_per_frame": c / n,
                         "us_per_frame": us / n} for k, (c, us) in top],
    }))


if __name__ == "__main__":
    main()
