"""The staged run that the PyTorch port replays on the GPU.

`open_vins_tpu_torch/data/msckf_sim20_seed0.npz` holds the whole
`runner.stage_run` output of the MSCKF-only configuration at reference widths
(11 clones, 1 camera, 200 points, <= 40 MSCKF features per update, 20 Hz
camera / 200 Hz IMU, rk4, 20 s, seed 0), plus the JAX run's per-frame pose and
its RMSE / NEES.  The machine with the card has no JAX, so the port reads the
frames from this file.

`open_vins_tpu_torch/data/oppoint_sim20_seed0_ref.npz` holds the JAX run of
the bench's operating point (`bench.py:94-96`: 11 clones, 50 SLAM landmarks,
<= 40 MSCKF features, ACI² integration, the joint "qr" vision update) over
the same frames: per-frame pose, MSCKF and SLAM counts, RMSE / NEES and the
configuration.  It holds no frames of its own.

Regenerate both with ``python tests/test_torch_fixture.py --write`` (or only
the operating-point reference with ``--write-oppoint``).  The test below
re-stages with JAX and requires the committed arrays to match; it is marked
slow (about half a minute of JAX staging): run it with ``-m slow`` after any
change to the fixture or to the simulator.

Two more references hold JAX runs on streams that the port's own simulator
stages from `simulator.draw(params, 0)` (the machine with the card stages
them itself and holds its staging against the digest stored here):

* `open_vins_tpu_torch/data/largemap_sim8_seed0_ref.npz`: bench.py's
  large-map point (bench.py:389-402: 30 clones, 400 SLAM landmarks, 400
  points per frame, a map of 4,096 points, 8 s on the sine trajectory,
  D = 1434);
* `open_vins_tpu_torch/data/v102_replay40_seed0_ref.npz`: the V1_02 corpus
  replay of tests/test_corpus_replay.py:33-48 (40 s of the padded
  trajectory, room-scale depths, the operating point in
  ANCHORED_MSCKF_INVERSE_DEPTH) on the in-repo
  `results/suite/truths/V1_02_medium.txt`.

Each holds the JAX run's per-frame pose and counts, its RMSE, NEES and
posyaw ATE, `meta` (the stream and the filter) and the port's CPU staging
digest (`convert.staging_digest`).  Write them with
``python tests/test_torch_fixture.py --write-sim-refs`` (JAX and the port
on the CPU, a few minutes); `test_sim_refs_match_fresh_run` (slow)
re-derives both.

`open_vins_tpu_torch/data/ensemble8_sim20_ref.npz` holds bench.py's 8-seed
ensemble (bench.py:221-282): the operating point on 8 streams that the
port's simulator stages on the CPU from `simulator.draw(params, s)`,
s = 0..7 (`runner.stage_ensemble`), run through
`jax.jit(jax.vmap(runner.run_filter))` as bench.py:233-235 runs it: per
stream the positions, RMSE, NEES (bench.py's formulas), mean landmark and
MSCKF counts and the staging digest (`convert.ensemble_digest`), and the
seed-mean NEES with its std.  Write it with
``python tests/test_torch_fixture.py --write-ensemble-ref`` (JAX and the
port on the CPU, several minutes).

The update forms, the sequential ordering and ZUPT have JAX runs of their
own, each a file like the operating point's:

* `open_vins_tpu_torch/data/oppoint_{woodbury,spd,newton}_sim20_seed0_ref.npz`:
  the operating point in the joint form of the file's name, and
  `sequential_sim20_seed0_ref.npz` with `joint_vision_update=False` (the
  reference-exact ordering), all on the committed frames of the fixture
  (``--write-forms-ref``, about two minutes);
* `open_vins_tpu_torch/data/zupt_stopgo20_seed0_ref.npz`: the operating
  point's widths with ZUPT (`zupt_max_velocity=0.2`,
  `zupt_max_disparity=3.0`) over 20 s of the stop-and-go trajectory of
  tests/test_slam_stack.py:27-59 (chip_smoke.py's numpy copy,
  `stop_and_go_trajectory`), staged by the port's simulator on the CPU
  from `simulator.draw(params, 0)`, with its staging digest
  (``--write-zupt-ref``).

`test_forms_refs_match_fresh_run` and `test_sim_refs_match_fresh_run`
(slow) re-derive them.

`open_vins_tpu_torch/data/rendered_stereo8_seed0_ref.npz` holds the JAX
references of bench.py's rendered 752x480 stereo pipeline
(bench.py:284-380), all on the port's CPU staging of its stream
(`RENDERED_META`, sigma_pix 0; no images are stored): the staging digest;
JAX's per-frame render moments of both cameras (sum, sum of squares,
Σx·I, Σy·I; `render_frame` on a JAX SimData built from the port's
simulator); the hypothesis sets of every RANSAC call of JAX's tracker over
the pipeline's first 40 frames, in call order, with its packets' ids,
points and masks (`ref_replay_*`, `jax_tracker_recorded`: the card replays
the sets and is held to the packets);
`run_tracker_staged`'s per-frame counts on the port's CPU-rendered images
of the first 120 frames; the descriptor tracker's inherited ids per frame
on the first 40 left-eye images, as the JAX package has it and with the
matched-rows id scatter the port implements
(`test_torch_tracker.jax_desc_track_frame_matched_scatter`);
`run_filter_rendered`'s poses, counts, RMSE and NEES, and the same
pipeline with the tracker's PRNG seeded 1 (`ref_seed1_*`, a test-side
copy of its loop: the RMSE gap between the two is the pipeline's own
spread); and JAX's `run_filter` on the same stream's TrackSIM frames with
pixel noise (`ref_tracksim_*`, the stereo estimator's check).  Write it
with ``python tests/test_torch_fixture.py --write-rendered-ref`` (JAX and
the port on the CPU, about four minutes); `test_rendered_ref_matches_fresh_run`
(slow) re-derives it.

The initialization and the rest of the estimator have JAX results of their
own: `static_init_ref.npz` (`try_static_init` on tests/test_init.py's
windows, ``--write-static-ref``); `dyninit_seed11_ref.npz` (the jitted
`initialize` on tests/test_dynamic_init.py's problems, their inputs, and
the eager run of every accepted one: the reference's own spread,
``--write-dyninit-ref``, a few minutes); `v102_autoinit_seed0_ref.npz`
(examples/run_benchmark_suite.py's `auto_init_state` on the port's CPU
staging of the V1_02 replay, with every routed attempt, the dynamic problem
and result of the successful one, JAX's `run_filter_from` from that init
and `background.catch_up` over the next camera times,
``--write-autoinit-ref``, a few minutes); `oppoint_single_sim20_seed0_ref
.npz` and `sequential_single_sim20_seed0_ref.npz` (the operating point with
ANCHORED_INVERSE_DEPTH_SINGLE landmarks, joint and sequential, on the
fixture's frames, with the per-frame pose covariances `ref_covs6` from
which `chip_smoke.py` recomputes JAX's RMSE and NEES over a prefix,
``--write-single-ref``); and `aruco_sim5_seed3_ref.npz`
(tests/test_aruco_sigma.py's stream with aruco landmarks, staged by the
port on the CPU, ``--write-aruco-ref``).  `test_init_refs_match_fresh_run`
(slow) re-derives them.
"""

from __future__ import annotations

import json
import os
import sys
from typing import NamedTuple

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                       "msckf_sim20_seed0.npz")

SIM = dict(imu_rate=200.0, cam_rate=20.0, num_cams=1, num_pts=200,
           map_size=2048, duration=20.0, sigma_pix=1.0, start_offset=3.0)
CFG = dict(max_clones=11, max_slam=0, num_cams=1, max_msckf_in_update=40,
           integration="rk4")
SEED = 0
MAX_TRACKS = 384

OPPOINT_REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                           "oppoint_sim20_seed0_ref.npz")
# bench.py:94-96, with the default joint "qr" vision update
OPPOINT_CFG = dict(max_clones=11, max_slam=50, num_cams=1,
                   max_msckf_in_update=40, integration="analytical",
                   newton_iters=14)

LARGEMAP_REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                            "largemap_sim8_seed0_ref.npz")
V102_REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                        "v102_replay40_seed0_ref.npz")
# bench.py:389-402, on the sine trajectory (the reference's udel_gore.txt is
# not in the repository, as bench.py:100-102 allows)
LARGEMAP_META = {
    "sim": dict(imu_rate=200.0, cam_rate=20.0, num_cams=1, num_pts=400,
                map_size=4096, duration=8.0, sigma_pix=1.0,
                start_offset=3.0),
    "traj": None, "seed": SEED,
    "cfg": dict(max_clones=30, max_slam=400, num_cams=1,
                max_msckf_in_update=40, max_obs_per_feature=30,
                integration="analytical", joint_update_form="qr"),
    "max_tracks": 768,
}
ENSEMBLE_REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                            "ensemble8_sim20_ref.npz")
# bench.py:221-282: the operating point on 8 streams, seeds 0..7, on the sine
# trajectory (udel_gore.txt is not in the repository, bench.py:99-103)
ENSEMBLE_META = {"sim": SIM, "traj": None, "seeds": list(range(8)),
                 "cfg": OPPOINT_CFG, "max_tracks": MAX_TRACKS}
# the joint update forms and the sequential ordering at the operating point,
# each on the fixture's frames: name -> (reference file, configuration)
FORM_REFS = {
    form: (os.path.join(ROOT, "open_vins_tpu_torch", "data",
                        f"oppoint_{form}_sim20_seed0_ref.npz"),
           dict(OPPOINT_CFG, joint_update_form=form))
    for form in ("woodbury", "spd", "newton")}
FORM_REFS["sequential"] = (
    os.path.join(ROOT, "open_vins_tpu_torch", "data",
                 "sequential_sim20_seed0_ref.npz"),
    dict(OPPOINT_CFG, joint_vision_update=False))
ZUPT_REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                        "zupt_stopgo20_seed0_ref.npz")
# the operating point's widths with ZUPT on the stop-and-go trajectory
# (tests/test_slam_stack.py:27-88: its gates, 20 s of the fixture's stream)
ZUPT_META = {"sim": SIM, "traj": {"stop_and_go": {"dt": 0.1}},
             "seed": SEED,
             "cfg": dict(OPPOINT_CFG, use_zupt=True, zupt_max_velocity=0.2,
                         zupt_max_disparity=3.0),
             "max_tracks": MAX_TRACKS}
RENDERED_REF = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                            "rendered_stereo8_seed0_ref.npz")
# bench.py:292-357: the rendered 752x480 stereo images->pose pipeline on the
# sine trajectory (udel_gore.txt is not in the repository, bench.py:100-102)
RENDERED_META = {
    "sim": dict(imu_rate=200.0, cam_rate=20.0, num_cams=2, num_pts=200,
                map_size=2048, duration=8.0, sigma_pix=0.0, start_offset=3.0,
                width=752, height=480, min_depth=4.0, max_depth=9.0),
    "traj": None, "seed": SEED,
    "calib": {"intr": [[458.0, 458.0, 376.0, 240.0, 0.0, 0.0, 0.0, 0.0]] * 2,
              "rot": [[-1.2, 1.2, -1.2]] * 2,
              "p": [[0.0, -0.01, 0.02], [0.11, -0.01, 0.02]]},
    "cfg": dict(max_clones=11, max_slam=25, num_cams=2,
                max_msckf_in_update=40, integration="analytical"),
    "max_tracks": 384,
    "klt": dict(num_features=200, num_pyr=4, grid_x=20, grid_y=15),
    "tracker_frames": 120, "descriptor_frames": 40,
    # the first frames of the pipeline with JAX's RANSAC sets recorded, so
    # that the card replays them and is held to JAX's packets and poses
    "replay_frames": 40,
    # the same stream's TrackSIM frames with pixel noise: the stereo
    # estimator's check before any image code
    "tracksim_sigma_pix": 1.0,
}
V102_TRUTH = "results/suite/truths/V1_02_medium.txt"
V102_T_RUN = 40.0
DATA = os.path.join(ROOT, "open_vins_tpu_torch", "data")
# the 1-dof single-depth landmarks at the operating point, in the joint
# "qr" update and in the sequential ordering, on the fixture's frames
SINGLE_REFS = {
    "single": (os.path.join(DATA, "oppoint_single_sim20_seed0_ref.npz"),
               dict(OPPOINT_CFG,
                    feat_rep_slam="ANCHORED_INVERSE_DEPTH_SINGLE")),
    "single_sequential": (
        os.path.join(DATA, "sequential_single_sim20_seed0_ref.npz"),
        dict(OPPOINT_CFG, feat_rep_slam="ANCHORED_INVERSE_DEPTH_SINGLE",
             joint_vision_update=False))}
ARUCO_REF = os.path.join(DATA, "aruco_sim5_seed3_ref.npz")
# tests/test_aruco_sigma.py's stream (30 points of a 512-point map, 5 s,
# seed 3) and filter (11 clones, 8 landmark slots, <= 20 MSCKF features),
# with ids 0..256 aruco tag corners (64 tags) at sigma_pix_aruco 3 and a
# doubled χ² multiplier, so that both kinds of landmark are in the state
ARUCO_META = {
    "sim": dict(imu_rate=200.0, cam_rate=20.0, num_cams=1, num_pts=30,
                map_size=512, duration=5.0, sigma_pix=1.0),
    "traj": None, "seed": 3,
    "cfg": dict(max_clones=11, max_slam=8, num_cams=1,
                max_msckf_in_update=20, num_aruco_tags=64,
                sigma_pix_aruco=3.0, chi2_multiplier_aruco=2.0),
    "max_tracks": 256,
}
DYNINIT_REF = os.path.join(DATA, "dyninit_seed11_ref.npz")
# tests/test_dynamic_init.py's problems: name -> (seed, constant-
# acceleration trajectory, n_pose, window s, features cleared)
DYNINIT_CASES = {
    "recover": (11, False, 6, 2.0, False),
    "const_accel": (5, True, 6, 2.0, False),
    "short_window": (11, False, 4, 0.75, False),
    "short_const_accel": (7, True, 4, 1.0, False),
    "no_features": (12, False, 6, 2.0, True),
}
STATIC_REF = os.path.join(DATA, "static_init_ref.npz")
V102_AUTOINIT_REF = os.path.join(DATA, "v102_autoinit_seed0_ref.npz")
CATCHUP_FRAMES = 10  # camera times queued behind the init attempt


def v102_meta():
    """tests/test_corpus_replay.py:33-48 on the in-repo V1_02 groundtruth."""
    from open_vins_tpu_torch.sim import trajectories

    n_ctrl = int(round((3.0 + V102_T_RUN + 3.0) / 0.05))
    _, valid = trajectories.load_trajectory_padded(
        os.path.join(ROOT, V102_TRUTH), n_ctrl, device="cpu")
    return {
        "sim": dict(imu_rate=200.0, cam_rate=20.0, num_cams=1, num_pts=200,
                    map_size=2048, duration=V102_T_RUN, sigma_pix=1.0,
                    start_offset=3.0,
                    map_duration=min(valid - 3.5, V102_T_RUN),
                    min_view_depth=1.5, min_depth=3.0, max_depth=8.0),
        "traj": {"file": V102_TRUTH, "n_ctrl": n_ctrl, "dt": 0.05},
        "seed": SEED,
        "cfg": dict(max_clones=11, max_slam=50, num_cams=1,
                    max_msckf_in_update=40, integration="analytical",
                    feat_rep_slam="ANCHORED_MSCKF_INVERSE_DEPTH"),
        "max_tracks": 384,
    }


STAGED_KEYS = ("win_t", "win_w", "win_a", "t_new", "ids", "uv", "uvn", "mask",
               "gt_q", "gt_p", "gt_v", "bias_g0", "bias_a0", "cam_R_ItoC",
               "cam_p_IinC", "cam_intr")


def stage_arrays():
    """(sim, params, run, arrays): the JAX staging of the fixture's run."""
    import open_vins_tpu  # noqa: F401
    from open_vins_tpu.models import runner
    from open_vins_tpu.sim import simulator

    params = simulator.SimParams(**SIM)
    sim = simulator.build(params, seed=SEED)
    run = runner.stage_run(sim, params)
    f = run.frames
    arrays = {
        "win_t": f.win.t, "win_w": f.win.w, "win_a": f.win.a,
        "t_new": f.t_new, "ids": f.ids, "uv": f.uv, "uvn": f.uvn,
        "mask": f.mask, "gt_q": run.gt_q, "gt_p": run.gt_p, "gt_v": run.gt_v,
        "bias_g0": sim.bias_g_traj[0], "bias_a0": sim.bias_a_traj[0],
        "cam_R_ItoC": sim.cam_R_ItoC, "cam_p_IinC": sim.cam_p_IinC,
        "cam_intr": sim.cam_intr,
    }
    return sim, params, run, {k: np.asarray(v) for k, v in arrays.items()}


def pose_metrics(qs, ps, covs6, gt_q, gt_p, quat_2_rot, log_so3):
    """(rmse, nees) as bench.py computes them: outs index k is frame k+1,
    NEES over the last three quarters, δθ = −log(R_gt R_estᵀ)."""
    gt_q, gt_p = np.asarray(gt_q)[1:], np.asarray(gt_p)[1:]
    rmse = float(np.sqrt(((gt_p - ps) ** 2).sum(1).mean()))
    nees = []
    nf = len(gt_p)
    for k in range(nf // 4, nf):
        R_est = np.asarray(quat_2_rot(qs[k]))
        R_gt = np.asarray(quat_2_rot(gt_q[k]))
        dth = -np.asarray(log_so3(R_gt @ R_est.T))
        e = np.concatenate([dth, gt_p[k] - ps[k]])
        nees.append(e @ np.linalg.solve(covs6[k] + 1e-12 * np.eye(6), e))
    return rmse, float(np.mean(nees))


def write_fixture(path=FIXTURE):
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.models import runner
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.ops import lie

    sim, params, run, arrays = stage_arrays()
    cfg = FilterConfig(**CFG)
    tri_opts = tri.TriangulationOptions()
    state, outs = jax.jit(lambda r: runner.run_filter(
        cfg, tri_opts, sim, params, r, max_tracks=MAX_TRACKS))(run)
    qs, ps, covs6 = (np.asarray(outs[0]), np.asarray(outs[1]),
                     np.asarray(outs[3]))
    rmse, nees = pose_metrics(
        qs, ps, covs6, arrays["gt_q"], arrays["gt_p"],
        lambda q: lie.quat_2_rot(jnp.asarray(q)),
        lambda R: lie.log_so3(jnp.asarray(R)))
    meta = {"sim": SIM, "cfg": CFG, "seed": SEED, "max_tracks": MAX_TRACKS,
            "tri_opts": "TriangulationOptions()"}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, **arrays, ref_q=qs, ref_p=ps,
        ref_n_msckf=np.asarray(outs[4].n_msckf),
        ref_rmse=np.float64(rmse), ref_nees=np.float64(nees),
        meta=np.asarray(json.dumps(meta)))
    print(json.dumps({"path": path, "bytes": os.path.getsize(path),
                      "frames": int(qs.shape[0]), "rmse": rmse, "nees": nees,
                      "finite": bool(np.isfinite(np.asarray(state.cov)).all())}))


def write_oppoint_reference(path=OPPOINT_REF, frames_path=FIXTURE,
                            cfg_kw=OPPOINT_CFG):
    """Run JAX's operating point (or the configuration `cfg_kw`) over the
    committed frames of `frames_path` (the very arrays the port replays)
    and save the small reference file."""
    import types

    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.models import manager, runner
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu.ops import lie

    with np.load(frames_path) as z:
        a = {k: z[k] for k in z.files}
    frames = manager.FrameInput(
        win=ImuWindow(t=a["win_t"], w=a["win_w"], a=a["win_a"]),
        t_new=a["t_new"], ids=a["ids"], uv=a["uv"], uvn=a["uvn"],
        mask=a["mask"])
    run = runner.SimRun(frames=frames, gt_q=a["gt_q"], gt_p=a["gt_p"],
                        gt_v=a["gt_v"])
    # run_filter reads only these fields of the simulator
    sim = types.SimpleNamespace(
        bias_g_traj=a["bias_g0"][None], bias_a_traj=a["bias_a0"][None],
        cam_R_ItoC=a["cam_R_ItoC"], cam_p_IinC=a["cam_p_IinC"],
        cam_intr=a["cam_intr"])
    cfg = FilterConfig(**cfg_kw)
    tri_opts = tri.TriangulationOptions()
    state, outs = jax.jit(lambda r: runner.run_filter(
        cfg, tri_opts, sim, None, r, max_tracks=MAX_TRACKS))(run)
    qs, ps, covs6 = (np.asarray(outs[0]), np.asarray(outs[1]),
                     np.asarray(outs[3]))
    rmse, nees = pose_metrics(
        qs, ps, covs6, a["gt_q"], a["gt_p"],
        lambda q: lie.quat_2_rot(jnp.asarray(q)),
        lambda R: lie.log_so3(jnp.asarray(R)))
    diag = outs[4]
    meta = {"frames": os.path.basename(frames_path), "cfg": cfg_kw,
            "seed": SEED, "max_tracks": MAX_TRACKS,
            "tri_opts": "TriangulationOptions()"}
    extra = {}
    if cfg.joint_update_form == "newton" and cfg.joint_vision_update:
        extra["ref_newton_resid"] = np.asarray(diag.newton_resid)
    np.savez_compressed(
        path, ref_q=qs, ref_p=ps, ref_n_msckf=np.asarray(diag.n_msckf),
        ref_n_slam=np.asarray(diag.n_slam),
        ref_n_slam_used=np.asarray(diag.n_slam_used),
        ref_rmse=np.float64(rmse), ref_nees=np.float64(nees),
        ref_covs6=covs6,
        ref_finite=np.bool_(np.isfinite(np.asarray(state.cov)).all()),
        **extra, meta=np.asarray(json.dumps(meta)))
    print(json.dumps({
        "path": path, "bytes": os.path.getsize(path),
        "frames": int(qs.shape[0]), "rmse": rmse, "nees": nees,
        "n_msckf_mean": float(np.mean(diag.n_msckf)),
        "n_slam_mean": float(np.mean(diag.n_slam)),
        "n_slam_used_mean": float(np.mean(diag.n_slam_used)),
        "finite": bool(np.isfinite(np.asarray(state.cov)).all())}))


def port_traj(meta):
    """The (times, R, p) trajectory that `meta["traj"]` names when
    `convert.stage_stream` cannot read it from a file (the stop-and-go
    trajectory, chip_smoke.py's copy), else None."""
    import torch

    spec = meta.get("traj") or {}
    if "stop_and_go" not in spec:
        return None
    from chip_smoke import stop_and_go_trajectory

    params = meta["sim"]
    return tuple(torch.as_tensor(a) for a in stop_and_go_trajectory(
        params["duration"] + 2.0 * params["start_offset"] + 2.0,
        **spec["stop_and_go"]))


def jax_run_on_port_stream(meta):
    """The port's CPU staging of `meta`'s stream, and JAX's run_filter on
    it: (run, digest, reference arrays)."""
    import types

    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.eval import metrics
    from open_vins_tpu.models import manager, runner
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu.ops import lie
    from open_vins_tpu_torch import convert

    sim, _, run_t = convert.stage_stream(meta, "cpu", traj=port_traj(meta))
    a = convert.frames_to_numpy(run_t.frames)
    frames = manager.FrameInput(
        win=ImuWindow(t=a["win_t"], w=a["win_w"], a=a["win_a"]),
        t_new=a["t_new"], ids=a["ids"], uv=a["uv"], uvn=a["uvn"],
        mask=a["mask"])
    gt = {k: getattr(run_t, k).numpy() for k in ("gt_q", "gt_p", "gt_v")}
    run = runner.SimRun(frames=frames, **gt)
    # run_filter reads only these fields of the simulator
    sim_ns = types.SimpleNamespace(**{
        k: getattr(sim, k).numpy() for k in ("bias_g_traj", "bias_a_traj",
                                             "cam_R_ItoC", "cam_p_IinC",
                                             "cam_intr")})
    cfg = FilterConfig(**meta["cfg"])
    state, outs = jax.jit(lambda r: runner.run_filter(
        cfg, tri.TriangulationOptions(), sim_ns, None, r,
        max_tracks=meta["max_tracks"]))(run)
    qs, ps, covs6 = (np.asarray(outs[0]), np.asarray(outs[1]),
                     np.asarray(outs[3]))
    R = np.asarray(jax.vmap(lie.quat_2_rot)(jnp.asarray(
        np.concatenate([qs, gt["gt_q"][1:]]))))
    R_est, R_gt = R[:len(qs)], R[len(qs):]
    gt_p = gt["gt_p"][1:]
    rmse, nees = pose_metrics(
        qs, ps, covs6, gt["gt_q"], gt["gt_p"],
        lambda q: lie.quat_2_rot(jnp.asarray(q)),
        lambda R: lie.log_so3(jnp.asarray(R)))
    ori, pos = metrics.ate(ps, R_est.transpose(0, 2, 1), gt_p,
                           R_gt.transpose(0, 2, 1), method="posyaw")
    n = len(gt_p)
    sl = slice(n // 4, n)
    _, _, full = metrics.nees(ps[sl], R_est[sl], gt_p[sl], R_gt[sl],
                              covs6[sl])
    diag = outs[4]
    ref = dict(
        ref_q=qs, ref_p=ps, ref_n_msckf=np.asarray(diag.n_msckf),
        ref_n_slam=np.asarray(diag.n_slam),
        ref_n_slam_used=np.asarray(diag.n_slam_used),
        ref_rmse=np.float64(rmse), ref_nees=np.float64(nees),
        ref_ate_pos_m=np.float64(pos.rmse), ref_ate_ori_deg=np.float64(ori.rmse),
        ref_nees_full=np.float64(full.mean),
        ref_finite=np.bool_(np.isfinite(np.asarray(state.cov)).all()))
    return run_t, convert.staging_digest(run_t), ref


def write_sim_reference(path, meta):
    run, digest, ref = jax_run_on_port_stream(meta)
    np.savez_compressed(path, **ref,
                        **{f"digest_{k}": v for k, v in digest.items()},
                        meta=np.asarray(json.dumps(meta)))
    print(json.dumps({
        "path": path, "bytes": os.path.getsize(path),
        "frames": int(ref["ref_q"].shape[0]),
        "state_dim": _cfg_dim(meta["cfg"]),
        **{k: float(v) for k, v in ref.items() if v.ndim == 0},
        "n_slam_mean": float(ref["ref_n_slam"].mean()),
        "n_msckf_mean": float(ref["ref_n_msckf"].mean()),
        "zupt_frames": zupt_frames(ref["ref_n_msckf"],
                                   ref["ref_n_slam_used"])}))


class _SimFields(NamedTuple):
    """What the JAX `run_filter` reads of a simulator (a pytree, so that
    `jax.vmap` maps it over streams)."""

    bias_g_traj: object
    bias_a_traj: object
    cam_R_ItoC: object
    cam_p_IinC: object
    cam_intr: object


def jax_ensemble_on_port_streams(meta):
    """The port's CPU staging of `meta`'s streams (`runner.stage_ensemble`)
    and `jax.jit(jax.vmap(runner.run_filter))` on them, as
    bench.py:227-236 runs the ensemble: (runs, digest, reference arrays)."""
    import jax
    import torch

    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.models import manager, runner
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.models import runner as trunner
    from open_vins_tpu_torch.sim import simulator as tsim

    calibs, runs_t = trunner.stage_ensemble(tsim.SimParams(**meta["sim"]),
                                            meta["seeds"], "cpu")
    a = convert.run_to_numpy(runs_t)
    frames = manager.FrameInput(
        win=ImuWindow(t=a["win_t"], w=a["win_w"], a=a["win_a"]),
        t_new=a["t_new"], ids=a["ids"], uv=a["uv"], uvn=a["uvn"],
        mask=a["mask"])
    run = runner.SimRun(frames=frames, gt_q=a["gt_q"], gt_p=a["gt_p"],
                        gt_v=a["gt_v"])
    c = {k: v.numpy() for k, v in calibs.items()}
    sims = _SimFields(bias_g_traj=c["bias_g0"][:, None],
                      bias_a_traj=c["bias_a0"][:, None],
                      cam_R_ItoC=c["cam_R_ItoC"], cam_p_IinC=c["cam_p_IinC"],
                      cam_intr=c["cam_intr"])
    cfg = FilterConfig(**meta["cfg"])
    state, outs = jax.jit(jax.vmap(lambda s, r: runner.run_filter(
        cfg, tri.TriangulationOptions(), s, None, r,
        max_tracks=meta["max_tracks"])))(sims, run)
    qs, ps, covs6 = (np.asarray(outs[0]), np.asarray(outs[1]),
                     np.asarray(outs[3]))
    rmse, nees = np.asarray([trunner.pose_metrics(
        *(torch.as_tensor(x[b]) for x in (qs, ps, covs6)),
        runs_t.gt_q[b], runs_t.gt_p[b]) for b in range(len(qs))]).T
    diag = outs[4]
    ref = dict(
        ref_p=ps, ref_rmse=rmse, ref_nees=nees,
        ref_n_slam_mean=np.asarray(diag.n_slam).mean(axis=1),
        ref_n_msckf_mean=np.asarray(diag.n_msckf).mean(axis=1),
        ref_rmse_median=np.float64(np.median(rmse)),
        ref_nees_seed_mean=np.float64(nees.mean()),
        ref_nees_seed_std=np.float64(nees.std()),
        ref_finite=np.bool_(np.isfinite(np.asarray(state.cov)).all()))
    return runs_t, convert.ensemble_digest(runs_t), ref


def write_ensemble_reference(path=ENSEMBLE_REF, meta=ENSEMBLE_META):
    _, digest, ref = jax_ensemble_on_port_streams(meta)
    np.savez_compressed(path, **ref,
                        **{f"digest_{k}": v for k, v in digest.items()},
                        meta=np.asarray(json.dumps(meta)))
    print(json.dumps({
        "path": path, "bytes": os.path.getsize(path),
        "streams": len(meta["seeds"]), "frames": int(ref["ref_p"].shape[1]),
        **{k: (v.tolist() if v.ndim else v.item()) for k, v in ref.items()
           if k != "ref_p"}}))


def tracksim_meta(meta=RENDERED_META):
    """The rendered stream's TrackSIM staging: the same map and motion with
    pixel noise."""
    return dict(meta, sim=dict(meta["sim"],
                               sigma_pix=meta["tracksim_sigma_pix"]))


def jax_sim_of_port(sim):
    """The JAX package's SimData built from the port's simulator (spline,
    map, calibration, start time, bias walks; the noise keys are unused
    by rendering and by the rendered runs)."""
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.sim import bspline, simulator

    a = {k: jnp.asarray(v.numpy()) for k, v in sim.items()
         if k != "spline"}
    key = jax.random.PRNGKey(0)
    return simulator.SimData(
        spline=bspline.Bspline(**{k: jnp.asarray(v.numpy())
                                  for k, v in sim.spline.items()}),
        map_pts=a["map_pts"], cam_intr=a["cam_intr"],
        cam_R_ItoC=a["cam_R_ItoC"], cam_p_IinC=a["cam_p_IinC"],
        calib_dt=a["calib_dt"], bias_g_traj=a["bias_g_traj"],
        bias_a_traj=a["bias_a_traj"], gravity=a["gravity"],
        t_start=a["t_start"], key_w=key, key_a=key, key_pix=key)


def jax_run_of_port(run_t):
    """The JAX package's SimRun holding the port's staged frames."""
    from open_vins_tpu.models import manager, runner
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu_torch import convert

    a = convert.run_to_numpy(run_t)
    frames = manager.FrameInput(
        win=ImuWindow(t=a["win_t"], w=a["win_w"], a=a["win_a"]),
        t_new=a["t_new"], ids=a["ids"], uv=a["uv"], uvn=a["uvn"],
        mask=a["mask"])
    return runner.SimRun(frames=frames, gt_q=a["gt_q"], gt_p=a["gt_p"],
                         gt_v=a["gt_v"])


def jax_run_filter_rendered_seeded(cfg, tri_opts, sim, params, run,
                                   klt_params, max_tracks, tracker_seed):
    """runner.py:167-214 of the JAX package (`run_filter_rendered`) with
    the tracker's PRNG seeded `tracker_seed` instead of 0."""
    import jax
    import jax.numpy as jnp

    from open_vins_tpu.frontend import tracker
    from open_vins_tpu.models import feature_table as jft
    from open_vins_tpu.models import manager, runner

    state = manager.initialize_from_gt(
        cfg, run.gt_q[0], run.gt_p[0], run.gt_v[0], sim.bias_g_traj[0],
        sim.bias_a_traj[0], jnp.asarray(0.0),
        calib_ext_q=jax.vmap(runner._rot2q)(sim.cam_R_ItoC),
        calib_ext_p=sim.cam_p_IinC, calib_intr=sim.cam_intr)
    table = jft.init_table(cfg, max_tracks)
    tstate = tracker.init_tracker(params.height, params.width,
                                  klt_params.num_features, seed=tracker_seed)
    tstate, *_ = runner._render_and_track(tstate, sim, params, klt_params,
                                          jnp.asarray(0), True, "STRETCH")

    def body(carry, inp):
        st, tb, trk = carry
        fr, k = inp
        trk, ids, uv, uvn, mask = runner._render_and_track(
            trk, sim, params, klt_params, k, False, "STRETCH")
        fr = fr._replace(ids=ids, uv=uv, uvn=uvn, mask=mask)
        st, tb, diag = manager.step_frame(st, tb, cfg, tri_opts, fr)
        return (st, tb, trk), (st.q, st.p, st.v, st.cov[:6, :6], diag)

    n = run.frames.t_new.shape[0]
    (state, table, tstate), outs = jax.lax.scan(
        body, (state, table, tstate), (run.frames, jnp.arange(1, n + 1)))
    return (state, table, tstate), outs


def jax_tracker_recorded(sim, params, kp, n):
    """JAX's tracker as `run_filter_rendered` runs it (primed on frame 0,
    then frames 1..n), recording the hypothesis sets of every RANSAC call
    in call order: `ransac_fundamental` is wrapped to draw the same Gumbel
    top-k from its key and hand it to a host callback before deciding as
    before.  Returns (sets [calls, 64, 8], ids [n, C, P], uv [n, C, P, 2],
    mask [n, C, P]) as numpy."""
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from open_vins_tpu.frontend import ransac as jransac
    from open_vins_tpu.frontend import tracker as jtracker
    from open_vins_tpu.models import runner as jrun
    from test_torch_frontend import draw_jax_sets

    calls = []
    decide = jransac.ransac_fundamental

    def recorded(p0, p1, mask, key, thresh, num_hyp=64):
        jax.debug.callback(lambda s: calls.append(np.asarray(s)),
                           draw_jax_sets(key, mask, num_hyp),
                           ordered=True)
        return decide(p0, p1, mask, key, thresh, num_hyp)

    # the tracker's jitted steps are traced anew with the wrapper, and
    # afterwards without it
    jax.clear_caches()
    with mock.patch.object(jransac, "ransac_fundamental", recorded):
        step = jax.jit(lambda ts, k, first: jrun._render_and_track(
            ts, sim, params, kp, k, first, "STRETCH"), static_argnums=2)
        ts = jtracker.init_tracker(params.height, params.width,
                                   kp.num_features)
        ts, *_ = step(ts, jnp.asarray(0), True)
        packets = []
        for k in range(1, n + 1):
            ts, ids, uv, _, mask = step(ts, jnp.asarray(k), False)
            packets.append((np.asarray(ids), np.asarray(uv),
                            np.asarray(mask)))
        jax.effects_barrier()
    jax.clear_caches()
    return (np.stack(calls), *(np.stack(x) for x in zip(*packets)))


def jax_rendered_references(meta=RENDERED_META):
    """The port's CPU staging of the rendered stream and every JAX
    reference of the rendered phases on it: (digest, arrays)."""
    import jax
    import jax.numpy as jnp
    import torch

    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.frontend import descriptor as jdesc
    from open_vins_tpu.frontend import klt as jklt
    from open_vins_tpu.models import runner as jrun
    from open_vins_tpu.models import triangulation as jtri
    from open_vins_tpu.sim import render as jrender
    from open_vins_tpu.sim import simulator as jsimulator
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.models import runner as trun

    sim_t, params_t, run_t = convert.stage_stream(meta, "cpu")
    params = jsimulator.SimParams(**meta["sim"])
    sim, run = jax_sim_of_port(sim_t), jax_run_of_port(run_t)
    kp = jklt.KltParams(**meta["klt"])
    n_frames = jsimulator.n_cam_frames(params)
    out = {}

    from chip_smoke import RENDER_MOMENTS, render_moments

    # per-frame render moments of both cameras (float64)
    rend = jax.jit(lambda s, k, c: jrender.render_frame(s, params, k, cam=c),
                   static_argnums=2)
    moments = np.stack([np.stack([
        render_moments(np.asarray(rend(sim, k, c), np.float64))
        for c in range(params.num_cams)]) for k in range(n_frames)])
    for i, name in enumerate(RENDER_MOMENTS):
        out[f"ref_render_{name}"] = moments[..., i]

    # the tracker alone on the port's CPU-rendered images
    n_trk = meta["tracker_frames"]
    imgs_t = trun.render_frames(sim_t, params_t, n_trk, device="cpu")
    _, counts = jax.jit(lambda im: jrun.run_tracker_staged(
        im, sim, params, kp))(jnp.asarray(imgs_t.numpy()))
    out["ref_tracker_counts"] = np.asarray(counts)

    # the descriptor tracker on the left eye's first frames: as the JAX
    # package has it, and with the inherited ids scattered from the matched
    # rows only (the port's semantics; test_torch_tracker.py's copy)
    from test_torch_tracker import jax_desc_track_frame_matched_scatter

    from chip_smoke import inherited_counts

    for key, fn in (("desc", jdesc.track_frame),
                    ("desc_matched_scatter",
                     jax_desc_track_frame_matched_scatter)):
        step = jax.jit(fn, static_argnames=("params", "first_frame"))
        dst = jdesc.init_tracker(kp.num_features)
        d_ids, d_valid = [], []
        for k in range(meta["descriptor_frames"]):
            dst, ids, _, _, valid = step(
                dst, jnp.asarray(imgs_t[k, 0].numpy()), sim.cam_intr[0], kp,
                first_frame=k == 0)
            d_ids.append(np.asarray(ids))
            d_valid.append(np.asarray(valid))
        out[f"ref_{key}_counts"] = np.asarray(inherited_counts(
            np.stack(d_ids), np.stack(d_valid)))
    del imgs_t

    # the tracker's first frames with JAX's hypothesis sets recorded
    sets, ids, uv, mask = jax_tracker_recorded(sim, params, kp,
                                               meta["replay_frames"])
    out.update(ref_replay_sets=sets.astype(np.int16), ref_replay_ids=ids,
               ref_replay_uv=uv, ref_replay_mask=mask)

    # the images->pose pipeline, and the same with the tracker seeded 1
    cfg = FilterConfig(**meta["cfg"])
    tri_opts = jtri.TriangulationOptions()
    for key, fn in (("", lambda s, r: jrun.run_filter_rendered(
            cfg, tri_opts, s, params, r, kp,
            max_tracks=meta["max_tracks"])),
                    ("seed1_", lambda s, r: jax_run_filter_rendered_seeded(
                        cfg, tri_opts, s, params, r, kp, meta["max_tracks"],
                        1))):
        (state, _, _), outs = jax.jit(fn)(sim, run)
        qs, ps, covs6 = (np.asarray(outs[0]), np.asarray(outs[1]),
                         np.asarray(outs[3]))
        rmse, nees = trun.pose_metrics(
            *(torch.as_tensor(x) for x in (qs, ps, covs6)), run_t.gt_q,
            run_t.gt_p)
        diag = outs[4]
        out.update({
            f"ref_{key}p": ps, f"ref_{key}q": qs,
            f"ref_{key}rmse": np.float64(rmse),
            f"ref_{key}nees": np.float64(nees),
            f"ref_{key}n_tracks": np.asarray(diag.n_tracks),
            f"ref_{key}n_msckf": np.asarray(diag.n_msckf),
            f"ref_{key}n_slam": np.asarray(diag.n_slam),
            f"ref_{key}n_slam_used": np.asarray(diag.n_slam_used),
            f"ref_{key}finite": np.bool_(
                np.isfinite(np.asarray(state.cov)).all())})

    # the stereo estimator on the same stream's TrackSIM frames
    _, _, ts = jax_run_on_port_stream(tracksim_meta(meta))
    out.update({f"ref_tracksim_{k[4:]}": v for k, v in ts.items()})
    return convert.staging_digest(run_t), out


def write_rendered_reference(path=RENDERED_REF, meta=RENDERED_META):
    digest, ref = jax_rendered_references(meta)
    np.savez_compressed(path, **ref,
                        **{f"digest_{k}": v for k, v in digest.items()},
                        meta=np.asarray(json.dumps(meta)))
    print(json.dumps({
        "path": path, "bytes": os.path.getsize(path),
        **{k: float(v) for k, v in ref.items() if v.ndim == 0},
        "tracker_counts_mean": float(ref["ref_tracker_counts"].mean()),
        "desc_counts_mean": float(ref["ref_desc_counts"].mean()),
        "desc_matched_scatter_counts_mean": float(
            ref["ref_desc_matched_scatter_counts"].mean()),
        "n_slam_mean": float(ref["ref_n_slam"].mean()),
        "seed1_n_slam_mean": float(ref["ref_seed1_n_slam"].mean())}))


def write_static_reference(path=STATIC_REF):
    """JAX's `try_static_init` on tests/test_torch_init.py's windows (those
    of tests/test_init.py), waiting for the jerk and not: `{case}_t`,
    `{case}_w`, `{case}_a`, `{case}_mask` and `{case}_{jerk|still}_*` (the
    StaticInitResult)."""
    import jax.numpy as jnp

    from open_vins_tpu.init import static_init
    from test_init import OPTS
    from test_torch_init import STATIC_CASES, _static_inputs

    arrays, summary = {}, {}
    for name in STATIC_CASES:
        tt, w, a, m = _static_inputs(name)
        arrays.update({f"{name}_t": tt, f"{name}_w": w, f"{name}_a": a,
                       f"{name}_mask": m})
        for wait in (True, False):
            tag = f"{name}_{'jerk' if wait else 'still'}"
            res = static_init.try_static_init(
                OPTS._replace(wait_for_jerk=wait), jnp.asarray(tt),
                jnp.asarray(w), jnp.asarray(a), jnp.asarray(m),
                float(tt[-1]))
            arrays.update({f"{tag}_{k}": np.asarray(v)
                           for k, v in res._asdict().items()})
            summary[tag] = bool(res.success)
    meta = {"opts": dict(OPTS._asdict()), "cases": list(STATIC_CASES)}
    np.savez_compressed(path, **arrays, meta=np.asarray(json.dumps(meta)))
    print(json.dumps({"path": path, "bytes": os.path.getsize(path),
                      **summary}))


def dyninit_inputs():
    """name -> JAX DynInitInput of DYNINIT_CASES, built as
    tests/test_dynamic_init.py builds them."""
    import jax.numpy as jnp

    from open_vins_tpu.sim import simulator
    from test_dynamic_init import PARAMS, TestDegenerateGeometry, build_input

    out = {}
    for name, (seed, const, n_pose, window, no_feats) in \
            DYNINIT_CASES.items():
        params = PARAMS._replace(duration=6.0) if const else PARAMS
        traj = TestDegenerateGeometry._const_accel_traj() if const else None
        sim = simulator.build(params, seed=seed, traj=traj)
        inp = build_input(sim, params, n_pose=n_pose, window=window)
        if no_feats:
            inp = inp._replace(obs_mask=jnp.zeros_like(inp.obs_mask))
        out[name] = inp
    return out


def write_dyninit_reference(path=DYNINIT_REF):
    """JAX's jitted `initialize` on each problem of DYNINIT_CASES, and on
    each it accepts also its eager (op-by-op) run: the reference's own
    spread.  Stores `{case}_in_*` (the DynInitInput), `{case}_jit_*` and
    `{case}_eager_*` (the DynInitResult)."""
    import time

    import jax

    from open_vins_tpu.init import dynamic_init

    opts = dynamic_init.DynamicInitOptions()
    arrays, summary = {}, {}
    for name, inp in dyninit_inputs().items():
        arrays.update({f"{name}_in_{k}": np.asarray(v)
                       for k, v in inp._asdict().items()})
        t0 = time.time()
        res = jax.jit(lambda i: dynamic_init.initialize(i, opts))(inp)
        arrays.update({f"{name}_jit_{k}": np.asarray(v)
                       for k, v in res._asdict().items()})
        summary[name] = {"success": bool(res.success),
                         "shape": list(np.asarray(inp.uvn).shape),
                         "seconds": time.time() - t0}
        if bool(res.success):
            res = dynamic_init.initialize(inp, opts)
            arrays.update({f"{name}_eager_{k}": np.asarray(v)
                           for k, v in res._asdict().items()})
            summary[name]["eager_success"] = bool(res.success)
    meta = {"cases": {k: list(v) for k, v in DYNINIT_CASES.items()},
            "opts": "DynamicInitOptions()"}
    np.savez_compressed(path, **arrays, meta=np.asarray(json.dumps(meta)))
    print(json.dumps({"path": path, "bytes": os.path.getsize(path),
                      **summary}))


def v102_autoinit_meta():
    return dict(v102_meta(), max_search_s=40.0,
                catchup_frames=CATCHUP_FRAMES)


def jax_auto_init_on_port_stream(meta):
    """JAX's `auto_init_state` (examples/run_benchmark_suite.py:126-230) on
    the port's CPU staging of `meta`'s stream, every routed attempt
    recorded; then JAX's `run_filter_from` from that state over the whole
    replay and `background.catch_up` from it over the next
    `catchup_frames` camera times.  Returns the reference arrays."""
    import importlib
    import types

    import jax
    import jax.numpy as jnp

    from open_vins_tpu.core.layout import FilterConfig
    from open_vins_tpu.init import background, router
    from open_vins_tpu.models import manager, runner
    from open_vins_tpu.models import triangulation as tri
    from open_vins_tpu.models.propagator import ImuWindow
    from open_vins_tpu.ops import lie
    from open_vins_tpu.sim import simulator
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.models import runner as trunner

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    suite = importlib.import_module("run_benchmark_suite")
    sim_t, _, run_t = convert.stage_stream(meta, "cpu")
    a = convert.frames_to_numpy(run_t.frames)
    frames = manager.FrameInput(
        win=ImuWindow(t=a["win_t"], w=a["win_w"], a=a["win_a"]),
        t_new=a["t_new"], ids=a["ids"], uv=a["uv"], uvn=a["uvn"],
        mask=a["mask"])
    gt = {k: getattr(run_t, k).numpy() for k in ("gt_q", "gt_p", "gt_v")}
    run = runner.SimRun(frames=frames, **gt)
    sim = types.SimpleNamespace(**{
        k: jnp.asarray(getattr(sim_t, k).numpy())
        for k in ("cam_R_ItoC", "cam_p_IinC", "cam_intr")})
    params = simulator.SimParams(**meta["sim"])
    cfg = FilterConfig(**meta["cfg"])

    calls = []
    try_init = router.try_initialize

    def recording(*args, **kw):
        kind, res = try_init(*args, **kw)
        calls.append((float(args[4]), kw.get("dyn_input"), kind, res))
        return kind, res

    router.try_initialize = recording
    try:
        st0, k0, kind, t_init = suite.auto_init_state(
            run, sim, cfg, params, max_search_s=meta["max_search_s"])
    finally:
        router.try_initialize = try_init
    out = {"ref_k0": np.int64(k0), "ref_kind": np.asarray(kind),
           "ref_t_init": np.float64(t_init),
           "ref_attempts": np.int64(len(calls)),
           "ref_attempt_t": np.asarray([c[0] for c in calls]),
           "ref_attempt_kinds": np.asarray([c[2] for c in calls])}
    out.update({f"state0_{k}": np.asarray(v)
                for k, v in st0._asdict().items()})
    if kind == "dynamic":
        inp, res = calls[-1][1], calls[-1][3]
        out.update({f"dyn_in_{k}": np.asarray(v)
                    for k, v in inp._asdict().items()})
        out.update({f"dyn_res_{k}": np.asarray(v)
                    for k, v in res._asdict().items()})

    # tests/test_corpus_replay.py:133-143's gates on the init state
    R_i = np.asarray(lie.quat_2_rot(st0.q))
    R_t = np.asarray(lie.quat_2_rot(jnp.asarray(gt["gt_q"][k0])))
    g_i, g_t = R_i @ np.array([0.0, 0.0, 1.0]), R_t @ np.array([0.0, 0, 1])
    out["ref_init_gravity_err_deg"] = np.float64(np.degrees(np.arccos(
        np.clip(g_i @ g_t, -1.0, 1.0))))
    out["ref_init_speed_err"] = np.float64(abs(
        np.linalg.norm(np.asarray(st0.v)) - np.linalg.norm(gt["gt_v"][k0])))

    sim_ns = types.SimpleNamespace(bias_g_traj=None, bias_a_traj=None)
    st, fouts = jax.jit(lambda s0, k: runner.run_filter_from(
        cfg, tri.TriangulationOptions(), sim_ns, params, run, s0, k,
        max_tracks=meta["max_tracks"]))(st0, jnp.asarray(k0, jnp.int32))
    qs, ps, covs6 = (np.asarray(fouts[0]), np.asarray(fouts[1]),
                     np.asarray(fouts[3]))
    from chip_smoke import init_replay_metrics

    ate_p, ate_o, nees = init_replay_metrics(qs, ps, covs6, gt["gt_q"],
                                             gt["gt_p"], k0)
    out.update(ref_p=ps, ref_q=qs, ref_ate_pos_m=np.float64(ate_p),
               ref_ate_ori_deg=np.float64(ate_o),
               ref_nees_full=np.float64(nees),
               ref_finite=np.bool_(np.isfinite(np.asarray(st.cov)).all()))

    # the catch-up over the camera times queued behind the attempt
    queued = [float(x) for x in a["t_new"][k0:k0 + meta["catchup_frames"]]]
    make_window = trunner.window_packer(*trunner.imu_stream(run_t))
    caught = background.catch_up(st0, cfg, queued, make_window,
                                 params.imu_rate)
    out["ref_catchup_t"] = np.asarray(queued)
    out.update({f"catchup_{k}": np.asarray(v)
                for k, v in caught._asdict().items()})
    return out


def write_autoinit_reference(path=V102_AUTOINIT_REF):
    meta = v102_autoinit_meta()
    ref = jax_auto_init_on_port_stream(meta)
    np.savez_compressed(path, **ref, meta=np.asarray(json.dumps(meta)))
    print(json.dumps({"path": path, "bytes": os.path.getsize(path),
                      **{k: (v.item() if v.ndim == 0 else None)
                         for k, v in ref.items() if k.startswith("ref_")
                         and v.ndim == 0}}))


def _cfg_dim(cfg):
    from open_vins_tpu_torch.core.layout import FilterConfig

    return FilterConfig(**cfg).state_dim


@pytest.mark.slow
@pytest.mark.parametrize("which", ["largemap", "v102", "zupt"])
def test_sim_refs_match_fresh_run(which):
    """The committed reference equals a fresh run: the port's CPU staging
    reproduces the digest (ids and masks exactly, floats to 1e-5), and
    JAX's run on it the per-frame positions to 1e-4 m."""
    from open_vins_tpu_torch import convert

    path, meta = {"largemap": (LARGEMAP_REF, LARGEMAP_META),
                  "v102": (V102_REF, v102_meta()),
                  "zupt": (ZUPT_REF, ZUPT_META)}[which]
    ref = convert.load_reference(path)
    assert ref["meta"] == json.loads(json.dumps(meta))
    _, digest, fresh = jax_run_on_port_stream(meta)
    for k, v in digest.items():
        want = ref[f"digest_{k}"]
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, rtol=0, atol=1e-5,
                                       err_msg=k)
    np.testing.assert_allclose(fresh["ref_p"], ref["ref_p"], rtol=0,
                               atol=1e-4)
    assert fresh["ref_finite"]


@pytest.mark.slow
def test_fixture_matches_fresh_staging():
    """The committed frames equal a fresh JAX staging (ids and masks exactly;
    floats to 1e-6 relative, since XLA's CPU code for the simulator's
    transcendental functions may round differently on another host ISA)."""
    _, _, _, arrays = stage_arrays()
    with np.load(FIXTURE) as z:
        meta = json.loads(str(z["meta"]))
        assert meta["sim"] == SIM and meta["cfg"] == CFG
        assert meta["seed"] == SEED and meta["max_tracks"] == MAX_TRACKS
        for k in STAGED_KEYS:
            got, want = z[k], arrays[k]
            assert got.shape == want.shape and got.dtype == want.dtype, k
            if got.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
        assert z["ref_q"].shape == (arrays["t_new"].shape[0], 4)
        assert np.isfinite(z["ref_rmse"]) and np.isfinite(z["ref_nees"])
    with np.load(OPPOINT_REF) as z:
        meta = json.loads(str(z["meta"]))
        assert meta["cfg"] == OPPOINT_CFG
        assert meta["frames"] == os.path.basename(FIXTURE)
        assert meta["seed"] == SEED and meta["max_tracks"] == MAX_TRACKS
        n = arrays["t_new"].shape[0]
        assert z["ref_p"].shape == (n, 3) and z["ref_n_slam"].shape == (n,)
        assert z["ref_n_slam"].mean() > 0
        assert np.isfinite(z["ref_rmse"]) and np.isfinite(z["ref_nees"])


@pytest.mark.slow
def test_rendered_ref_matches_fresh_run():
    """The committed rendered reference equals a fresh derivation: the
    port's CPU staging reproduces the digest, JAX's render moments agree to
    1e-6 relative, its tracker and descriptor counts and its recorded
    hypothesis sets, ids and masks exactly, its packets' points to 1e-4 px
    and its pipelines' positions to 1e-4 m."""
    from open_vins_tpu_torch import convert

    ref = convert.load_reference(RENDERED_REF)
    assert ref["meta"] == json.loads(json.dumps(RENDERED_META))
    digest, fresh = jax_rendered_references(RENDERED_META)
    for k, v in digest.items():
        want = ref[f"digest_{k}"]
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, rtol=0, atol=1e-5,
                                       err_msg=k)
    for k, v in fresh.items():
        if (k.endswith("counts") or k.startswith("ref_n_") or "_n_" in k
                or (k.startswith("ref_replay") and v.dtype.kind in "biu")):
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        elif k == "ref_replay_uv":
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        elif k.startswith("ref_render"):
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, err_msg=k)
        elif k.endswith("_p") or k.endswith("_q"):
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-4,
                                       err_msg=k)
    assert ref["ref_finite"] and ref["ref_seed1_finite"]


def zupt_frames(n_msckf, n_slam_used, first=30):
    """Frames consumed by a ZUPT from frame `first` on: no MSCKF feature and
    no landmark used (tests/test_slam_stack.py:120-124)."""
    n_msckf, n_slam_used = np.asarray(n_msckf), np.asarray(n_slam_used)
    return int(((n_msckf[first:] == 0) & (n_slam_used[first:] == 0)).sum())


def write_forms_references():
    for path, cfg_kw in FORM_REFS.values():
        write_oppoint_reference(path, cfg_kw=cfg_kw)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FORM_REFS))
def test_forms_refs_match_fresh_run(name, tmp_path):
    """Each form's committed reference equals a fresh JAX run on the
    fixture's frames: positions to 1e-4 m, counts exactly."""
    from open_vins_tpu_torch import convert

    path, cfg_kw = FORM_REFS[name]
    ref = convert.load_reference(path)
    assert ref["meta"]["cfg"] == cfg_kw
    fresh = tmp_path / "fresh.npz"
    write_oppoint_reference(str(fresh), cfg_kw=cfg_kw)
    new = convert.load_reference(fresh)
    np.testing.assert_allclose(new["ref_p"], ref["ref_p"], rtol=0, atol=1e-4)
    for k in ("ref_n_msckf", "ref_n_slam", "ref_n_slam_used"):
        np.testing.assert_array_equal(new[k], ref[k], err_msg=k)
    assert ref["ref_finite"] and ref["ref_rmse"] < 0.05


@pytest.mark.slow
@pytest.mark.parametrize("name", ["static", "dyninit", "autoinit",
                                  *SINGLE_REFS, "aruco"])
def test_init_refs_match_fresh_run(name, tmp_path):
    """The references of the initialization, single-depth and aruco checks
    equal a fresh derivation: flags, routes, counts and integers exactly,
    floats within 1e-4 of each array's max (XLA's CPU code may round
    differently on another host ISA)."""
    fresh = str(tmp_path / "fresh.npz")
    path = {"static": STATIC_REF, "dyninit": DYNINIT_REF,
            "autoinit": V102_AUTOINIT_REF, "aruco": ARUCO_REF,
            **{k: v[0] for k, v in SINGLE_REFS.items()}}[name]
    if name == "static":
        write_static_reference(fresh)
    elif name == "dyninit":
        write_dyninit_reference(fresh)
    elif name == "autoinit":
        write_autoinit_reference(fresh)
    elif name == "aruco":
        write_sim_reference(fresh, ARUCO_META)
    else:
        write_oppoint_reference(fresh, cfg_kw=SINGLE_REFS[name][1])
    with np.load(path) as z, np.load(fresh) as f:
        assert set(z.files) == set(f.files)
        for k in z.files:
            a, b = z[k], f[k]
            if a.dtype.kind in "biuUS" or k == "meta":
                np.testing.assert_array_equal(b, a, err_msg=k)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=1e-4 * max(np.abs(a).max(), 1e-30),
                    err_msg=k)


def test_stop_and_go_copy_matches_test_slam_stack():
    """chip_smoke.py's numpy copy of the stop-and-go trajectory equals
    tests/test_slam_stack.py's JAX original."""
    from chip_smoke import stop_and_go_trajectory
    from test_slam_stack import stop_and_go_trajectory as jax_traj

    for got, want in zip(stop_and_go_trajectory(28.0), jax_traj(28.0)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-6)


if __name__ == "__main__":
    if {"--write", "--write-oppoint", "--write-sim-refs",
            "--write-ensemble-ref", "--write-forms-ref",
            "--write-zupt-ref", "--write-rendered-ref",
            "--write-single-ref", "--write-aruco-ref",
            "--write-dyninit-ref", "--write-autoinit-ref",
            "--write-static-ref"} & set(sys.argv):
        import jax

        # stage on the CPU, as the tests re-stage it
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, ROOT)
        if "--write" in sys.argv:
            write_fixture()
        if "--write" in sys.argv or "--write-oppoint" in sys.argv:
            write_oppoint_reference()
        if "--write-sim-refs" in sys.argv:
            write_sim_reference(LARGEMAP_REF, LARGEMAP_META)
            write_sim_reference(V102_REF, v102_meta())
        if "--write-ensemble-ref" in sys.argv:
            write_ensemble_reference()
        if "--write-forms-ref" in sys.argv:
            write_forms_references()
        if "--write-zupt-ref" in sys.argv:
            write_sim_reference(ZUPT_REF, ZUPT_META)
        if "--write-rendered-ref" in sys.argv:
            write_rendered_reference()
        if "--write-single-ref" in sys.argv:
            for path, cfg_kw in SINGLE_REFS.values():
                write_oppoint_reference(path, cfg_kw=cfg_kw)
        if "--write-aruco-ref" in sys.argv:
            write_sim_reference(ARUCO_REF, ARUCO_META)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        if "--write-static-ref" in sys.argv:
            write_static_reference()
        if "--write-dyninit-ref" in sys.argv:
            write_dyninit_reference()
        if "--write-autoinit-ref" in sys.argv:
            write_autoinit_reference()
    else:
        print(__doc__)
