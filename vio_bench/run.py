"""Run one benchmark cell once and print its result line.

    python3 vio_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last the compared numbers with their limits (`check`),
which also end standard error.  Without the devices, or when a module of
JAX or of the JAX package was loaded, it prints no result and exits 1.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run at a fixed path in the checkout
_CACHE = ROOT / "build" / "vio_bench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from vio_bench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 1
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print("no CUDA device, or fewer than the cell asks for",
              file=sys.stderr)
        return 1
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROC0)
    found = harness.loaded_forbidden()
    if found:
        print(f"modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 1
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
