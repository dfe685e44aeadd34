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
"""

from __future__ import annotations

import json
import os
import sys

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


def write_oppoint_reference(path=OPPOINT_REF, frames_path=FIXTURE):
    """Run JAX's operating point over the committed frames of `frames_path`
    (the very arrays the port replays) and save the small reference file."""
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
    cfg = FilterConfig(**OPPOINT_CFG)
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
    meta = {"frames": os.path.basename(frames_path), "cfg": OPPOINT_CFG,
            "seed": SEED, "max_tracks": MAX_TRACKS,
            "tri_opts": "TriangulationOptions()"}
    np.savez_compressed(
        path, ref_q=qs, ref_p=ps, ref_n_msckf=np.asarray(diag.n_msckf),
        ref_n_slam=np.asarray(diag.n_slam),
        ref_n_slam_used=np.asarray(diag.n_slam_used),
        ref_rmse=np.float64(rmse), ref_nees=np.float64(nees),
        meta=np.asarray(json.dumps(meta)))
    print(json.dumps({
        "path": path, "bytes": os.path.getsize(path),
        "frames": int(qs.shape[0]), "rmse": rmse, "nees": nees,
        "n_msckf_mean": float(np.mean(diag.n_msckf)),
        "n_slam_mean": float(np.mean(diag.n_slam)),
        "n_slam_used_mean": float(np.mean(diag.n_slam_used)),
        "finite": bool(np.isfinite(np.asarray(state.cov)).all())}))


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


if __name__ == "__main__":
    if "--write" in sys.argv or "--write-oppoint" in sys.argv:
        import jax

        # stage on the CPU, as the test re-stages it
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, ROOT)
        if "--write" in sys.argv:
            write_fixture()
        write_oppoint_reference()
    else:
        print(__doc__)
