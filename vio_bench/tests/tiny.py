"""A checkout with one more cell, `tiny.mc`, defined by new files alone: a
configuration file (a configuration's filter on a short stream) and a
traffic file (two streams), its entry in BENCHMARK.json and its name in the
per-layer metrics' lists of cells."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "tiny.mc"


def make_tree(root: Path, duration: float, base: str = "sim_msckf",
              filter_: dict | None = None, pass_frames: int = 9):
    """The tree under `root`: `base`'s configuration on a stream of
    `duration` seconds, its filter options overridden by `filter_`."""
    shutil.copytree(ROOT / "vio_bench", root / "vio_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / f"vio_bench/configs/{base}.json").read_text())
    cfg["sim"]["duration"] = duration
    cfg["filter"].update(filter_ or {})
    (root / "vio_bench/configs/sim_tiny.json").write_text(json.dumps(cfg))
    (root / "vio_bench/traffic/two.json").write_text(json.dumps({
        "streams": 2, "warmup_frames": 2, "profile_from": 1,
        "profile_steps": 2, "check": {"streams": 2, "steps": 3,
                                        "pass_frames": pass_frames}}))
    spec["configs"].append({"name": "sim_tiny", "source": "test",
                            "file": "vio_bench/configs/sim_tiny.json",
                            "reduced": ["duration"], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "sim_tiny",
                              "traffic": "two", "chips": 1, "why": "test"})
    for m in spec["per_layer"]:
        m.setdefault("workloads", []).append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
