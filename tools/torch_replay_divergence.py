"""Where the rendered tracker leaves JAX's packets, by staging.

    python tools/torch_replay_divergence.py [--frames 40] [--device cuda]

Tracks the first `--frames` frames of bench.py's rendered 752x480 stereo
stream (`open_vins_tpu_torch/data/rendered_stereo8_seed0_ref.npz`) with the
JAX RANSAC sets recorded there (chip_smoke.py's `replayed_sets`), twice: on
the stream staged on `--device` itself, and on the CPU staging that JAX's
reference ran on, moved to `--device`.  Prints one JSON line: how far the
two stagings' poses and rendered images lie apart and, for each run, the
first frame whose packet leaves JAX's (an id or a mask differs, or a point
of a track both keep lies more than `chip_smoke.REPLAY_UV_TOL_PX` away),
the tracks beyond that bound there and the largest offset, and the ids
that differ over all frames.  The card's name and power limit are printed
with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

import chip_smoke  # noqa: E402
from open_vins_tpu_torch import convert  # noqa: E402
from open_vins_tpu_torch.frontend import klt  # noqa: E402
from open_vins_tpu_torch.sim import render  # noqa: E402


def first_divergence(sim, params, kp, ref, n):
    """The first frame whose packet leaves JAX's, its tracks beyond the
    bound, their largest offset, and the ids differing over all frames."""
    frames, _ = chip_smoke.replay_packets(sim, params, kp, ref, n)
    bound = chip_smoke.REPLAY_UV_TOL_PX
    first = next((k for k, (ids, mask, off) in enumerate(frames, 1)
                  if ids or mask or (off > bound).any()), None)
    off = frames[first - 1][2] if first else np.zeros(0)
    return {"first_divergent_frame": first,
            "tracks_beyond_bound": int((off > bound).sum()),
            "max_offset_px": float(off.max(initial=0.0)),
            "ids_differing": sum(f[0] for f in frames)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ref = convert.load_reference(chip_smoke.RENDERED_REF)
    meta = ref["meta"]
    n = min(args.frames, meta["replay_frames"])
    kp = klt.KltParams(**meta["klt"])
    own_sim, params, own_run = convert.stage_stream(meta, args.device)
    cpu_sim, _, cpu_run = convert.stage_stream(meta, "cpu")
    cpu_sim = pytree.tree_map(lambda a: a.to(args.device), cpu_sim)
    frames = list(range(n + 1))
    image_gap = float((render.render(own_sim, params, frames)
                       - render.render(cpu_sim, params, frames)).abs().max())
    smi = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip() if args.device != "cpu" else "cpu")
    print(json.dumps({
        "device": args.device, "nvidia_smi": smi, "frames": n,
        "gt_p_gap_m": float((own_run.gt_p.cpu() - cpu_run.gt_p).abs().max()),
        "image_gap": image_gap,
        "own_staging": first_divergence(own_sim, params, kp, ref, n),
        "cpu_staging": first_divergence(cpu_sim, params, kp, ref, n)}), flush=True)


if __name__ == "__main__":
    main()
