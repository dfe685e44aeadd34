"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to the GPU and never fall back to the CPU on their
own, `chip_smoke.py` fails without a GPU or without the repository around
it, `convert.py` carries state across unchanged, and every update
configuration of the JAX package's step_frame steps."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import open_vins_tpu_torch
from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import init_state
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import runner
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.sim import simulator, trajectories
from torch_port_helpers import FIXTURE

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "open_vins_tpu")


def _port_sources():
    return sorted((ROOT / "open_vins_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    bad = [(str(p.relative_to(ROOT)), m) for p in _port_sources()
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"the port must not import JAX or its package: {bad}"
    assert len(_port_sources()) >= 16
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for module in ("frontend/klt.py", "frontend/ransac.py",
                   "frontend/tracker.py", "frontend/descriptor.py",
                   "sim/render.py", "init/static_init.py",
                   "init/dynamic_init.py", "init/router.py",
                   "init/background.py", "parallel/mesh.py",
                   "parallel/sharded_ekf.py", "parallel/distributed_ba.py",
                   "parallel/window_refine.py", "parallel/dryrun.py",
                   "utils/config.py", "utils/checkpoint.py",
                   "utils/timing.py", "utils/profiling.py",
                   "utils/native.py", "eval/traj_io.py",
                   "frontend/aruco.py", "frontend/visualization.py"):
        assert f"open_vins_tpu_torch/{module}" in names, module


def test_entry_points_default_to_cuda():
    """device=None means CUDA; without a card that raises."""
    cfg = FilterConfig(max_clones=3, max_slam=0)
    if torch.cuda.is_available():
        assert open_vins_tpu_torch.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_vins_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.load_staged_run(FIXTURE)
    run, calib, _ = convert.load_staged_run(FIXTURE, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_filter(cfg, tri.TriangulationOptions(), calib, run)
    params = simulator.SimParams(num_pts=4, map_size=8, duration=0.2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulator.build(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulator.sine_trajectory(1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trajectories.load_trajectory_file(
            ROOT / "results" / "suite" / "truths" / "V1_02_medium.txt")


def test_init_entry_points_default_to_cuda():
    """The initialization's entry points: device=None means CUDA."""
    if torch.cuda.is_available():
        return
    from open_vins_tpu_torch.init import router
    from open_vins_tpu_torch.models import propagator

    run, calib, _ = convert.load_staged_run(FIXTURE, "cpu")
    params = simulator.SimParams()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.auto_init_state(run, calib, FilterConfig(), params)
    imu_t = np.arange(40) * 0.005
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        propagator.make_window(imu_t, np.zeros((40, 3)), np.zeros((40, 3)),
                               0.0, 0.1, 24)
    hist = {i: ([0.0, 0.1, 0.2], [np.zeros(2)] * 3) for i in range(8)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        router.build_dyn_input(
            hist, [0.0, 0.1, 0.2],
            runner.window_packer(imu_t, np.zeros((40, 3)),
                                 np.zeros((40, 3))),
            np.eye(3), np.zeros(3), K=24)


def test_front_end_entry_points_default_to_cuda():
    """The front end's entry points: device=None means CUDA."""
    if torch.cuda.is_available():
        return
    from open_vins_tpu_torch.frontend import descriptor, klt, tracker

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tracker.init_tracker(48, 64, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        descriptor.init_tracker(8)
    params = simulator.SimParams(num_pts=4, map_size=8, duration=0.2,
                                 width=64, height=48)
    sim = simulator.build(params, device="cpu")
    run = runner.stage_run(sim, params)
    kp = klt.KltParams(num_pyr=2, win=3, num_features=8, grid_x=2, grid_y=2)
    cfg = FilterConfig(max_clones=3, max_slam=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.render_frames(sim, params, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_tracker_staged(torch.zeros(2, 1, 48, 64), sim, params, kp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_tracker_rendered(sim, params, kp, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_filter_rendered(cfg, tri.TriangulationOptions(), sim,
                                   params, run, kp)


def test_parallel_and_utils_entry_points_default_to_cuda(tmp_path):
    """The parallel layer's and the utilities' entry points that take
    tensors: device=None means CUDA; without a card they raise, before any
    rank is spawned."""
    if torch.cuda.is_available():
        return
    from open_vins_tpu_torch.models import manager
    from open_vins_tpu_torch.parallel import (distributed_ba, dryrun,
                                              sharded_ekf, window_refine)
    from open_vins_tpu_torch.utils import checkpoint, timing

    cfg = FilterConfig(max_clones=3, max_slam=0)
    state = init_state(cfg, "cpu")
    table = ft.init_table(cfg, 8, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.build_problem()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded_ekf.shard_state(state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed_ba.make_ba_problem()
    prob, _ = distributed_ba.make_ba_problem(L=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed_ba.shard_problem(prob)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        window_refine.refine_window(state, cfg, table,
                                    tri.TriangulationOptions(),
                                    manager.gather_feature_obs,
                                    max_landmarks=4)
    checkpoint.save(str(tmp_path / "c.npz"), state, table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load(str(tmp_path / "c.npz"), state, table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timing.FrameTimer()


def test_dryrun_entry_refuses_without_gpu():
    """`python -m open_vins_tpu_torch.parallel.dryrun` without --device
    means the card: without one it fails and prints no "OK"."""
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "open_vins_tpu_torch.parallel.dryrun", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "OK" not in out.stdout


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(where, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd, env = tmp_path, dict(os.environ)
        env.pop("PYTHONPATH", None)
    out = _run_smoke(cwd, env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_convert_round_trip():
    cfg = FilterConfig(max_clones=4, max_slam=2, num_cams=2)
    rng = np.random.default_rng(0)
    st = init_state(cfg, "cpu")
    arrays = {k: (rng.normal(size=v.shape).astype(np.float32)
                  if v.is_floating_point() else v.numpy())
              for k, v in st.items()}
    back = convert.state_to_numpy(convert.state_from_numpy(arrays, "cpu"))
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    tb = convert.table_to_numpy(ft.init_table(cfg, 8, "cpu"))
    tb2 = convert.table_to_numpy(convert.table_from_numpy(tb, "cpu"))
    for k, v in tb.items():
        np.testing.assert_array_equal(tb2[k], v, err_msg=k)
    with np.load(FIXTURE) as z:
        frames = {k: z[k][:3] for k in convert.FRAME_KEYS}
    fr = convert.frames_to_numpy(convert.frames_from_numpy(frames, "cpu"))
    for k, v in frames.items():
        np.testing.assert_array_equal(fr[k], v, err_msg=k)


@pytest.mark.parametrize("max_slam", [0, 4])
@pytest.mark.parametrize("kw", [
    dict(joint_update_form="woodbury"), dict(joint_update_form="spd"),
    dict(joint_update_form="newton", gauge_deflation=True,
         newton_joseph=True),
    dict(joint_vision_update=False), dict(fast_compress=True),
    dict(use_zupt=True), dict(use_zupt=True, zupt_explicit_motion=True),
    dict(feat_rep_slam="ANCHORED_MSCKF_INVERSE_DEPTH", use_zupt=True,
         joint_vision_update=False),
    dict(feat_rep_slam="ANCHORED_INVERSE_DEPTH_SINGLE"),
    dict(num_aruco_tags=2)], ids=str)
def test_every_update_configuration_steps(kw, max_slam):
    """Every update configuration of the JAX package's step_frame, the
    single-depth landmarks and aruco landmarks too, steps in the port: the
    graft widths (5 clones, <= 8 MSCKF features, ACI²) over the fixture's
    first 8 frames, which fill the window and reach delayed init, with a
    finite covariance after every step."""
    from open_vins_tpu_torch.models import manager

    cfg = FilterConfig(max_clones=5, max_slam=max_slam, num_cams=1,
                       max_msckf_in_update=8, integration="analytical", **kw)
    run, calib, _ = convert.load_staged_run(FIXTURE, "cpu")
    state = runner._initial_state(cfg, calib, run)
    table = ft.init_table(cfg, 64, "cpu")
    for k in range(8):
        state, table, diag = manager.step_frame(
            state, table, cfg, tri.TriangulationOptions(),
            runner.frame_at(run.frames, k))
        assert torch.isfinite(state.cov).all(), f"frame {k}"
    assert int(state.n_clones) == 5
