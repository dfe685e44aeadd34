"""Where a frame of the PyTorch port's main path spends its time on the GPU.

    python tools/torch_main_path_profile.py [--warm 40] [--frames 40]

Steps the MSCKF-only closed loop (`models/manager.step_frame`, the staged run
of `open_vins_tpu_torch/data/msckf_sim20_seed0.npz`) through `--warm`
frames, then traces the next `--frames` frames with `torch.profiler` and
prints one JSON line: host wall time per frame, GPU kernel launches and
busy time per frame, the GPU's idle share of the wall time, and the kernels
that take the most device time.  The host time per frame is taken on a
second, untraced window of as many frames.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
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
from open_vins_tpu_torch.ops import kernels, lie  # noqa: E402

FIXTURE = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                       "msckf_sim20_seed0.npz")


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
    ap.add_argument("--warm", type=int, default=40)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()

    run, calib, ref = convert.load_staged_run(FIXTURE, "cuda")
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
    n_msckf = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in frames:
            n_msckf.append(step(k).n_msckf)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = kernels.symmetric_downdate.launches
    # the same number of frames again, untraced: the host time without the
    # profiler's own overhead
    t0 = time.perf_counter()
    for k in range(args.warm + n, args.warm + 2 * n):
        step(k)
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0

    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in gpu]
    busy_us = _union_us(spans)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in gpu:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "frames": n, "first_frame": args.warm,
        "n_msckf_mean": float(torch.stack(n_msckf).float().mean()),
        "host_ms_per_frame": 1e3 * plain_wall_s / n,
        "traced_host_ms_per_frame": 1e3 * wall_s / n,
        "gpu_kernels_per_frame": len(gpu) / n,
        "gpu_busy_ms_per_frame": busy_us / 1e3 / n,
        "gpu_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "symmetric_downdate_launches": launches,
        "top_kernels": [{"name": k[:80], "calls_per_frame": c / n,
                         "us_per_frame": us / n} for k, (c, us) in top],
    }))


if __name__ == "__main__":
    main()
