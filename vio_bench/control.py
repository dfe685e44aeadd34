"""Readings of the comparison that decides `correct`, for setting its
limits: the program as it runs, or the control, the program with TF32
products switched on (the precision below the configurations' float32
with TF32 off), on a list of seeds in one process.

    python3 vio_bench/control.py --workload msckf.mc --seconds 8 \
        --mode tf32 --seeds 11 12 13

Prints one JSON line per seed: the compared numbers and `correct` under
the configuration's limits.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(workload, seeds, seconds, mode, dev):
    """[(seed, result)] of one run per seed on `dev`."""
    import torch

    from vio_bench import harness

    out = []
    for seed in seeds:
        # the program's import sets TF32 off; the control turns it on
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        res = harness.run_cell(ROOT, workload, seed, seconds, False, dev,
                               time.perf_counter())
        out.append((seed, res))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, default=8)
    ap.add_argument("--mode", choices=("program", "tf32"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    for seed, res in readings(args.workload, args.seeds, args.seconds,
                              args.mode, torch.device("cuda", 0)):
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
