"""Multi-rank dry run: every path of the parallel layer over N ranks.

Counterpart of `__graft_entry__.dryrun_multichip`, the repository's
multi-device check, on `torch.distributed`:

1. the filter ensemble over ranks: each rank stages its own stream (seed =
   rank) and steps it through `manager.step_frame`, whose every EKF update
   launches `symmetric_downdate` on CUDA; one all_reduce gives the
   ensemble-mean position.  At the bench's operating point (11 clones, 50
   SLAM landmarks, 200 points, <= 40 MSCKF features, ACI², the joint "qr"
   update), or with `small` at the graft problem's sizes.  It also times
   the ensemble's passes against rank 0 stepping alone;
2. the row-sharded EKF update (`parallel/sharded_ekf.py`) at the large
   map's D (`FilterConfig(max_clones=30, max_slam=400, num_cams=1,
   max_obs_per_feature=30)`, D = 1434) with the reference dry run's
   synthetic system (H [128, D] from `np.random.default_rng(0)`), held
   against the dense update on rank 0;
3. the distributed Schur BA (`parallel/distributed_ba.py`) on
   `make_ba_problem(L=4·N)`'s problem, two steps.

    python -m open_vins_tpu_torch.parallel.dryrun N [--device cpu|cuda]
        [--backend gloo|nccl] [--small]

The ranks are processes started with `mesh.spawn` on this host; the
backend is gloo unless told (gloo runs CPU ranks, and several ranks on one
card; nccl needs a card per rank).  Where the ranks share the host (always)
or a card, the ensemble's timing measures their contention, not a scaling,
and says so.

`run_tasks` runs given paths on spawned ranks with given inputs
(`sharded_task`, `ba_task`) and returns the gathered results, which the
tests and `chip_smoke.py` hold against the single-rank results.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core import ekf
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import init_state
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import manager, runner
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.ops import kernels
from open_vins_tpu_torch.parallel import distributed_ba as dba
from open_vins_tpu_torch.parallel import mesh, sharded_ekf
from open_vins_tpu_torch.sim import simulator

# the bench's operating point (bench.py:94-96) and the graft problem's
# sizes (__graft_entry__._build_problem's defaults)
OPPOINT = dict(max_clones=11, num_pts=200, map_size=1024, max_slam=50,
               max_msckf=40, integration="analytical")
SMALL = dict(max_clones=5, num_pts=12, map_size=128, max_slam=0,
             max_msckf=8, integration="rk4")
LARGE_MAP = FilterConfig(max_clones=30, max_slam=400, num_cams=1,
                         max_obs_per_feature=30)
SHARDED_ROWS = 128


def build_problem(max_clones=5, num_pts=12, duration=1.0, map_size=128,
                  max_slam=0, max_msckf=8, integration="rk4", seed=0,
                  device=None):
    """`__graft_entry__._build_problem` in the port: a 1 s stream (100 Hz
    IMU, 10 Hz camera) staged by the port's simulator on `device` (None =
    CUDA), the filter started from groundtruth.  Returns (cfg, tri_opts,
    state, table, run)."""
    params = simulator.SimParams(imu_rate=100.0, cam_rate=10.0, num_cams=1,
                                 num_pts=num_pts, map_size=map_size,
                                 duration=duration)
    cfg = FilterConfig(max_clones=max_clones, max_slam=max_slam, num_cams=1,
                       max_msckf_in_update=max_msckf, integration=integration)
    sim = simulator.build(params, seed=seed, device=device)
    run = runner.stage_run(sim, params)
    state = runner._initial_state(cfg, runner.sim_calib(sim), run)
    table = ft.init_table(cfg, 64, state.cov.device)
    return cfg, tri.TriangulationOptions(max_runs=2), state, table, run


def sharded_system(cfg=LARGE_MAP, m=SHARDED_ROWS):
    """The reference dry run's synthetic update at `cfg`'s D: (state as
    numpy arrays with P = 0.1·I, H [m, D], res [m], r_diag [m])."""
    D = cfg.state_dim
    rng = np.random.default_rng(0)
    H = (rng.normal(size=(m, D)) * 0.2).astype(np.float32)
    res = (rng.normal(size=m) * 0.01).astype(np.float32)
    r = np.full((m,), 0.01, np.float32)
    st = convert.state_to_numpy(init_state(cfg, "cpu"))
    st["cov"] = (np.eye(D) * 0.1).astype(np.float32)
    return st, H, res, r


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ensemble(rank, world, dev, sizes, reps):
    """Part 1 on this rank: its stream over all frames, the ensemble mean,
    the downdate launches of the checked pass (summed over ranks) and the
    pass times."""
    cfg, opts, state, table, run = build_problem(**sizes, seed=rank,
                                                 device=dev)
    n_frames = run.frames.t_new.shape[0]
    frames = [runner.frame_at(run.frames, k) for k in range(n_frames)]

    def stream():
        st, tb = state, table
        for fr in frames:
            st, tb, _ = manager.step_frame(st, tb, cfg, opts, fr)
        return st

    stream()  # warm-up: kernel libraries, cuBLAS and cuSOLVER handles
    _sync(dev)
    kernels.symmetric_downdate.launches = 0
    st = stream()
    launches = torch.tensor([float(kernels.symmetric_downdate.launches)],
                            device=dev)
    finite = torch.isfinite(st.cov).all() & torch.isfinite(st.p).all()
    stats = torch.cat([st.p, launches, (~finite).to(st.p.dtype)[None]])
    dist.all_reduce(stats)
    token = torch.zeros(1, device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        stream()
        dist.all_reduce(token)
    _sync(dev)
    dt_ens = (time.perf_counter() - t0) / reps
    dist.barrier()
    dt_one = 0.0
    if rank == 0:
        t0 = time.perf_counter()
        for _ in range(reps):
            stream()
        _sync(dev)
        dt_one = (time.perf_counter() - t0) / reps
    dist.barrier()
    return {"mean_p": (stats[:3] / world).cpu().numpy(),
            "launches": int(stats[3]), "non_finite_ranks": int(stats[4]),
            "frames": n_frames, "state_dim": cfg.state_dim,
            "dt_ensemble": dt_ens, "dt_single": dt_one}


def _sharded(rank, world, dev, state_np, H, res, r, cfg, dense):
    """Part 2 on this rank: the row-sharded update; rank 0 gathers the
    padded covariance and, with `dense`, the dense plain update on its own
    device beside it."""
    st = sharded_ekf.shard_state(convert.state_from_numpy(state_np, dev),
                                 device=dev)
    Ht, rt, rdt = (torch.as_tensor(a, device=dev) for a in (H, res, r))
    out = sharded_ekf.sharded_ekf_update(None, cfg)(st, Ht, rt, rdt)
    cov = sharded_ekf.gather_cov(out.cov)
    result = convert.state_to_numpy(out.replace(cov=cov))
    if dense and rank == 0:
        full = convert.state_from_numpy(state_np, dev)
        dx, want_cov = ekf.kalman_update_math(full.cov, Ht, rt, rdt,
                                              fuse_downdate=False)
        want = ekf.boxplus(full, cfg, dx).replace(cov=want_cov)
        result["dense"] = convert.state_to_numpy(want)
    return result


def _ba(rank, world, dev, prob_np, iters, step_only):
    """Part 3 on this rank: its landmark shard refined (or one step); the
    landmarks gathered, the reprojection RMS before and after."""
    prob = dba.BAProblem(**{k: torch.as_tensor(v) for k, v in
                            prob_np.items()})
    prob = dba.shard_problem(prob, device=dev)
    e0 = dba.reprojection_rmse(prob)
    if step_only:
        prob2, dx = dba.ba_step(prob)
        norms = torch.linalg.vector_norm(dx)[None]
    else:
        prob2, norms = dba.refine(prob, iters=iters)
    e1 = dba.reprojection_rmse(prob2)
    return {"R": prob2.R.cpu().numpy(), "p": prob2.p.cpu().numpy(),
            "landmarks": dba.gather_landmarks(prob2.landmarks).cpu().numpy(),
            "norms": norms.cpu().numpy(), "rmse_before": float(e0),
            "rmse_after": float(e1)}


_TASKS = {"ensemble": _ensemble, "sharded": _sharded, "ba": _ba}


def _rank_main(rank, world, device, tasks, out_dir):
    """A rank's program: each task of `tasks` ((name, kwargs) pairs) in
    order; rank 0 saves the i-th task's result as `out_dir/<i>.pt`."""
    dev = mesh.rank_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.cuda.set_device(dev)
    for i, (name, kwargs) in enumerate(tasks):
        result = _TASKS[name](rank, world, dev, **kwargs)
        if rank == 0:
            torch.save(result, os.path.join(out_dir, f"{i}.pt"))


def run_tasks(n_ranks, backend, tasks, device=None):
    """Run `tasks` ((name, kwargs) pairs; names "ensemble", "sharded",
    "ba") in order on `n_ranks` spawned ranks of one group; returns rank
    0's results, in task order."""
    out_dir = tempfile.mkdtemp(prefix="ovt_dryrun_")
    try:
        mesh.spawn(_rank_main, n_ranks, backend,
                   args=(device, tasks, out_dir))
        return [torch.load(os.path.join(out_dir, f"{i}.pt"),
                           weights_only=False) for i in range(len(tasks))]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def sharded_task(state_np, H, res, r_diag, cfg, dense=False):
    """A task of `run_tasks`: the row-sharded update of a state (numpy
    arrays, as `convert.state_to_numpy` gives).  Its result is the new
    state as numpy arrays, `cov` the gathered padded covariance [Dp, Dp]
    (with `dense`, rank 0's dense plain update under "dense")."""
    return ("sharded", dict(state_np=state_np, H=H, res=res, r=r_diag,
                            cfg=cfg, dense=dense))


def ba_task(prob_np, iters=2, step_only=False):
    """A task of `run_tasks`: `distributed_ba.refine` (or one `ba_step`) of
    a whole problem (numpy arrays by field), its landmarks sharded over the
    ranks.  Its result: R, p, the gathered landmarks, the step norms and
    the RMS before and after."""
    return ("ba", dict(prob_np=prob_np, iters=iters, step_only=step_only))


def run(n_ranks, device=None, backend="gloo", small=False, reps=3):
    """The three parts on n spawned ranks of one group; prints a line per
    part and raises if a check fails.  Returns {part: rank 0's result}."""
    dev = mesh.rank_device(device)  # raises before spawning without CUDA
    prob, _ = dba.make_ba_problem(L=4 * n_ranks, device="cpu")
    st, H, res, r = sharded_system()
    ens, sh, ba = run_tasks(n_ranks, backend, [
        ("ensemble", dict(sizes=SMALL if small else OPPOINT, reps=reps)),
        sharded_task(st, H, res, r, LARGE_MAP, dense=True),
        ba_task({k: v.numpy() for k, v in prob.items()})], device)

    if ens["non_finite_ranks"] or not np.isfinite(ens["mean_p"]).all():
        raise AssertionError("non-finite ensemble step")
    if ens["launches"] < n_ranks * ens["frames"] and dev.type == "cuda":
        raise AssertionError(f"symmetric_downdate launched {ens['launches']}"
                             f" times in {n_ranks} x {ens['frames']} frames")
    size = ("graft sizes: 5 clones / 12 pts / MSCKF only" if small else
            "operating point: 11 clones / 50 slam / 200 pts / joint update")
    print(f"dryrun: ensemble over {n_ranks} ranks OK ({size}; "
          f"{ens['frames']} frames per rank)", flush=True)
    agg = n_ranks * ens["frames"] / ens["dt_ensemble"]
    single = ens["frames"] / ens["dt_single"]
    shared = dev.type == "cpu" or n_ranks > torch.cuda.device_count()
    where = ("share one host's cores" if dev.type == "cpu" else
             "share one host and its card" if shared else "share one host")
    print(f"dryrun: ensemble timing (host-bound, {n_ranks} ranks {where} "
          f"— not a hardware scaling measurement): agg {agg:.1f} steps/s, "
          f"single {single:.1f} steps/s; correctness OK", flush=True)

    D = LARGE_MAP.state_dim
    cov = sh["cov"]
    if not np.isfinite(cov).all() or np.abs(cov[D:]).max(initial=0.0) != 0:
        raise AssertionError("sharded update: non-finite or padding touched")
    gap = float(np.abs(cov[:D, :D] - sh["dense"]["cov"]).max())
    if gap > 1e-4:
        raise AssertionError(f"sharded update {gap} from the dense update")
    print(f"dryrun: sharded-covariance EKF update OK (D = {D} over "
          f"{n_ranks} ranks, {gap:.2e} from the dense update)", flush=True)

    if not (np.isfinite(ba["p"]).all() and np.isfinite(ba["landmarks"]).all()):
        raise AssertionError("distributed BA: non-finite result")
    print(f"dryrun: distributed Schur BA OK; {n_ranks} ranks, all paths "
          f"validated", flush=True)
    return {"ensemble": ens, "sharded": sh, "ba": ba}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    ap.add_argument("--backend", default="gloo", choices=mesh.BACKENDS)
    ap.add_argument("--small", action="store_true",
                    help="the ensemble at the graft problem's sizes")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed passes of the ensemble and of one rank")
    args = ap.parse_args(argv)
    run(args.n_ranks, args.device, args.backend, args.small, args.reps)


if __name__ == "__main__":
    sys.exit(main())
