"""What a run loads: no module of JAX or of the JAX package, compared by
whole top-level name (the port's `open_vins_tpu_torch` begins with
`open_vins_tpu`), and a reference that loads nothing of the program.
Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from vio_bench.tests.tiny import ROOT, make_tree

FORBIDDEN = {"jax", "jaxlib", "flax", "open_vins_tpu"}
TOP = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _top_names(code, cwd):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, timeout=900,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_tiny_cell_loads_no_jax(tmp_path):
    """A CPU run of a cell of two streams and 12 frames."""
    make_tree(tmp_path, 0.65)
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
from pathlib import Path
from vio_bench import harness
res = harness.run_cell(Path({str(tmp_path)!r}), "tiny.mc", 7, 2, False,
                       torch.device("cpu"), time.perf_counter())
assert res["attempted"] > 0
{TOP}
"""
    names = _top_names(code, tmp_path)
    assert "open_vins_tpu_torch" in names and "vio_bench" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import vio_bench.check, vio_bench.gen, vio_bench.roofline, vio_bench.trace
import vio_bench.reference.manager
{TOP}
"""
    names = _top_names(code, tmp_path)
    assert not names & (FORBIDDEN | {"open_vins_tpu_torch"})
