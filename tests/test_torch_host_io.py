"""The port's host I/O utilities against the JAX package's: trajectory files
(`eval/traj_io.py`), the timing CSV (`utils/timing.py`) and profiler
traces (`utils/profiling.py`).

Each package reads what the other writes: TUM trajectories, EuRoC
groundtruth converted to TUM, and the reference's timing CSV (the same
columns, `#` header and 9 decimals).  The quaternion helpers agree to
1e-6.  The profiler's trace over two port steps on the CPU is a Chrome
trace in the log directory that holds the `annotate` labels.
"""

import glob
import gzip
import json
import os

import numpy as np
import pytest

from open_vins_tpu.eval import traj_io as jtraj
from open_vins_tpu.utils import timing as jtiming
from open_vins_tpu_torch.eval import traj_io as ttraj
from open_vins_tpu_torch.utils import profiling, timing


def trajectory(n=25, seed=0):
    rng = np.random.default_rng(seed)
    t = 1.4e9 + np.cumsum(rng.uniform(0.04, 0.06, n))
    p = rng.normal(size=(n, 3)) * 3.0
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return t, p, q


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tum_round_trip_across_packages(tmp_path, writer):
    t, p, q = trajectory()
    path = str(tmp_path / "traj.txt")
    (ttraj if writer == "port" else jtraj).save_tum(path, t, p, q)
    reader = jtraj if writer == "port" else ttraj
    got = reader.load_tum(path)
    want = (ttraj if writer == "jax" else jtraj).load_tum(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], t, atol=1e-9 * t.max())
    np.testing.assert_allclose(got[1], p, atol=1e-6)
    np.testing.assert_allclose(got[2], q, atol=1e-6)


def test_euroc_groundtruth_to_tum(tmp_path):
    t, p, q = trajectory(12, seed=1)
    rng = np.random.default_rng(2)
    rest = rng.normal(size=(12, 9))
    csv = tmp_path / "data.csv"
    lines = ["#timestamp, p_RS_R_x [m], ..."]
    for i in range(12):
        row = ([int(t[i] * 1e9)] + list(p[i]) + [q[i, 3], *q[i, :3]]
               + list(rest[i]))
        lines.append(",".join(str(x) for x in row))
    csv.write_text("\n".join(lines) + "\n")
    got = ttraj.load_euroc_gt(str(csv))
    want = jtraj.load_euroc_gt(str(csv))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ttraj.euroc_to_tum(str(csv), str(tmp_path / "port.txt"))
    jtraj.euroc_to_tum(str(csv), str(tmp_path / "jax.txt"))
    assert ((tmp_path / "port.txt").read_text()
            == (tmp_path / "jax.txt").read_text())


def test_quaternion_helpers_match_jax():
    _, _, q = trajectory(40, seed=3)
    R_t, R_j = ttraj.quat_xyzw_to_rot(q), jtraj.quat_xyzw_to_rot(q)
    np.testing.assert_allclose(R_t, R_j, atol=1e-6, rtol=0)
    q_t = ttraj.rot_to_quat_xyzw(R_t)
    np.testing.assert_allclose(q_t, jtraj.rot_to_quat_xyzw(R_j), atol=1e-6)
    # round trip up to the quaternion's sign
    sign = np.sign(np.sum(q_t * q, axis=1, keepdims=True))
    np.testing.assert_allclose(q_t * sign, q, atol=1e-6)


def _write_timing(module, path, device):
    timer = (module.FrameTimer(path, device=device) if device
             else module.FrameTimer(path))
    for k in range(4):
        timer.start_frame()
        sum(range(2000))
        timer.stage("propagation")
        timer.stage("msckf")
        timer.stage("not_a_column")
        timer.end_frame(0.05 * k)
    timer.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_timing_csv_across_packages(tmp_path, writer):
    path = str(tmp_path / "timing.txt")
    if writer == "port":
        _write_timing(timing, path, "cpu")
    else:
        _write_timing(jtiming, path, None)
    assert timing.COLUMNS == jtiming.COLUMNS
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "#" + ",".join(timing.COLUMNS)
    assert all(len(v.split(".")[1]) == 9 for v in lines[1].split(","))
    got, want = timing.load_timing_csv(path), jtiming.load_timing_csv(path)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["timestamp"], [0.0, 0.05, 0.1, 0.15])
    assert (got["total"] >= got["propagation"] + got["msckf"] - 1e-9).all()


def test_profiling_trace_holds_annotations(tmp_path):
    from open_vins_tpu_torch.models import manager, runner
    from open_vins_tpu_torch.parallel import dryrun

    cfg, opts, state, table, run = dryrun.build_problem(device="cpu")
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as where:
        assert where == logdir
        for k in range(2):
            with profiling.annotate(f"frame_{k}"):
                state, table, _ = manager.step_frame(
                    state, table, cfg, opts, runner.frame_at(run.frames, k))
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json*"))
    assert len(files) == 1, files
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"frame_0", "frame_1"} <= names
    assert any(str(n).startswith("aten::") for n in names)
