"""Carrying state and staged runs across as numpy arrays.

The dictionaries are keyed by the JAX package's field names, so a test can
feed both packages the same state (`dict(zip(st._fields, map(np.asarray,
st)))` on the JAX side).  Frame batches flatten the IMU window as `win_t`,
`win_w`, `win_a`.  The dynamic initializer's problem and solution
(`DynInitInput`, `DynInitResult`) cross under their JAX field names too.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.state import VioState
from open_vins_tpu_torch.init.dynamic_init import DynInitInput, DynInitResult
from open_vins_tpu_torch.models.feature_table import FeatureTable
from open_vins_tpu_torch.models.manager import FrameInput
from open_vins_tpu_torch.models.propagator import ImuWindow
from open_vins_tpu_torch.models import runner
from open_vins_tpu_torch.models.runner import SimCalib, SimRun
from open_vins_tpu_torch.ops import lie
from open_vins_tpu_torch.sim import simulator, trajectories
from open_vins_tpu_torch.sim.simulator import CalibDraws, SimDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAME_KEYS = ("win_t", "win_w", "win_a", "t_new", "ids", "uv", "uvn", "mask")


def _tensor(a, device):
    return torch.as_tensor(np.array(a), device=device)  # writable copy


def _from_numpy(cls, arrays, device):
    return cls(**{f.name: _tensor(arrays[f.name], device)
                  for f in dataclasses.fields(cls)})


def _to_numpy(record):
    return {k: v.detach().cpu().numpy() for k, v in record.items()}


def state_from_numpy(arrays, device=None) -> VioState:
    return _from_numpy(VioState, arrays, resolve_device(device))


def table_from_numpy(arrays, device=None) -> FeatureTable:
    return _from_numpy(FeatureTable, arrays, resolve_device(device))


def frames_from_numpy(arrays, device=None) -> FrameInput:
    """One frame or a batch of frames (leading axis) from FRAME_KEYS."""
    dev = resolve_device(device)
    t = {k: _tensor(arrays[k], dev) for k in FRAME_KEYS}
    return FrameInput(win=ImuWindow(t=t["win_t"], w=t["win_w"], a=t["win_a"]),
                      t_new=t["t_new"], ids=t["ids"], uv=t["uv"],
                      uvn=t["uvn"], mask=t["mask"])


def dyn_input_from_numpy(arrays, device=None) -> DynInitInput:
    """A JAX `DynInitInput` (`dict(zip(inp._fields, map(np.asarray,
    inp)))`) as the port's record on `device`."""
    return _from_numpy(DynInitInput, arrays, resolve_device(device))


def dyn_result_from_numpy(arrays, device=None) -> DynInitResult:
    return _from_numpy(DynInitResult, arrays, resolve_device(device))


def dyn_input_to_numpy(inp: DynInitInput) -> dict:
    return _to_numpy(inp)


def dyn_result_to_numpy(res: DynInitResult) -> dict:
    return _to_numpy(res)


def state_to_numpy(state: VioState) -> dict:
    return _to_numpy(state)


def table_to_numpy(table: FeatureTable) -> dict:
    return _to_numpy(table)


def frames_to_numpy(frames: FrameInput) -> dict:
    out = {f"win_{k}": v.cpu().numpy() for k, v in frames.win.items()}
    out.update({k: v.cpu().numpy() for k, v in frames.items() if k != "win"})
    return out


def run_to_numpy(run: SimRun) -> dict:
    """A staged run's frames (FRAME_KEYS) and groundtruth (`gt_q`, `gt_p`,
    `gt_v`) as numpy arrays; a run stacked over streams keeps its leading
    stream axis (what the JAX package's vmapped `run_filter` takes)."""
    out = frames_to_numpy(run.frames)
    out.update({k: getattr(run, k).cpu().numpy()
                for k in ("gt_q", "gt_p", "gt_v")})
    return out


def sim_draws_from_numpy(arrays) -> SimDraws:
    """A simulator's unit draws (SimDraws field names) as CPU tensors:
    floats as float32, the map's camera indices as int32."""
    return SimDraws(**{
        f.name: torch.as_tensor(np.array(
            arrays[f.name],
            dtype=np.int32 if f.name == "map_cam" else np.float32))
        for f in dataclasses.fields(SimDraws)})


def sim_draws_to_numpy(draws: SimDraws) -> dict:
    return _to_numpy(draws)


def calib_draws_from_numpy(arrays) -> CalibDraws:
    return CalibDraws(**{f.name: torch.as_tensor(np.array(
        arrays[f.name], dtype=np.float32))
        for f in dataclasses.fields(CalibDraws)})


def calib_draws_to_numpy(draws: CalibDraws) -> dict:
    return _to_numpy(draws)


def load_reference(path) -> dict:
    """The JAX run stored in an `.npz` (a staged-run file or a `*_ref.npz`
    beside one): its per-frame `ref_*` arrays, its scalar float `ref_*`
    (`ref_rmse`, `ref_nees`, ...) as Python floats (an ensemble's file
    holds RMSE and NEES per stream: then arrays [B]), `meta` (the
    configuration, decoded from JSON) and, where the file has one, the
    staging digest as `digest_*` (`staging_digest`; an ensemble's
    file stacks one per stream, `ensemble_digest`)."""
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files
               if k.startswith("ref_") or k.startswith("digest_")}
        ref["meta"] = json.loads(str(z["meta"]))
    for k, v in ref.items():
        if k.startswith("ref_") and v.ndim == 0 and v.dtype.kind == "f":
            ref[k] = float(v)
    return ref


def load_staged_run(path, device=None):
    """(SimRun, SimCalib, reference) from a staged-run `.npz` (see
    tests/test_torch_fixture.py); `reference` is `load_reference(path)`:
    the JAX run's per-frame `ref_q`/`ref_p`, `ref_n_msckf`, its
    `ref_rmse`/`ref_nees` and `meta` (the simulator and filter
    configuration)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    run = SimRun(frames=frames_from_numpy(arrays, dev),
                 gt_q=_tensor(arrays["gt_q"], dev),
                 gt_p=_tensor(arrays["gt_p"], dev),
                 gt_v=_tensor(arrays["gt_v"], dev))
    calib = SimCalib(**{f.name: _tensor(arrays[f.name], dev)
                        for f in dataclasses.fields(SimCalib)})
    return run, calib, load_reference(path)


def stage_stream(meta, device=None, traj=None):
    """(sim, params, run): the port's simulator built from `meta` (a
    reference file's configuration: `sim` holds the SimParams fields,
    `seed` the draw seed, `traj` None for the sine trajectory or
    {"file": path relative to the repository root, "n_ctrl", "dt"} for a
    padded trajectory file, `calib` None for `simulator.default_calib` or
    `calib_from_meta`'s dict) and its whole stream staged on `device`.  A
    given `traj` (times, R_ItoG, p) is used instead of `meta["traj"]`."""
    dev = resolve_device(device)
    params = simulator.SimParams(**meta["sim"])
    if traj is None and meta.get("traj"):
        spec = meta["traj"]
        traj, _ = trajectories.load_trajectory_padded(
            os.path.join(ROOT, spec["file"]), spec["n_ctrl"], dt=spec["dt"],
            device=dev)
    calib = meta.get("calib")
    sim = simulator.build(params, seed=meta["seed"], traj=traj,
                          calib=calib and calib_from_meta(calib, dev),
                          draws=simulator.draw(params, meta["seed"]),
                          device=dev)
    return sim, params, runner.stage_run(sim, params)


def calib_from_meta(calib, device=None):
    """(intr [N, 8], R_ItoC [N, 3, 3], p_IinC [N, 3]) from a configuration's
    `calib` dict: `intr` [N, 8], `rot` [N, 3] (each camera's R_ItoC as
    exp_so3 of the vector) and `p` [N, 3]."""
    dev = resolve_device(device)
    rot = torch.as_tensor(calib["rot"], dtype=torch.float32, device=dev)
    return (torch.as_tensor(calib["intr"], dtype=torch.float32, device=dev),
            lie.exp_so3(rot),
            torch.as_tensor(calib["p"], dtype=torch.float32, device=dev))


def staging_digest(run: SimRun) -> dict:
    """A staged stream's fingerprint: the groundtruth positions and
    quaternions of every frame, and ids, mask and uv of the first, middle
    and last frame (as numpy arrays)."""
    n = run.frames.t_new.shape[0]
    k = torch.tensor([0, n // 2, n - 1], device=run.frames.ids.device)
    out = {"gt_p": run.gt_p, "gt_q": run.gt_q, "frames": k,
           "ids": run.frames.ids[k], "mask": run.frames.mask[k],
           "uv": run.frames.uv[k]}
    return {key: v.detach().cpu().numpy() for key, v in out.items()}


def ensemble_digest(runs: SimRun) -> dict:
    """`staging_digest` of every stream of a run stacked over streams, each
    array stacked along a leading stream axis."""
    per = [staging_digest(runner.record_at(runs, b))
           for b in range(runs.gt_p.shape[0])]
    return {k: np.stack([d[k] for d in per]) for k in per[0]}
