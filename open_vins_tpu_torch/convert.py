"""Carrying state and staged runs across as numpy arrays.

The dictionaries are keyed by the JAX package's field names, so a test can
feed both packages the same state (`dict(zip(st._fields, map(np.asarray,
st)))` on the JAX side).  Frame batches flatten the IMU window as `win_t`,
`win_w`, `win_a`.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.state import VioState
from open_vins_tpu_torch.models.feature_table import FeatureTable
from open_vins_tpu_torch.models.manager import FrameInput
from open_vins_tpu_torch.models.propagator import ImuWindow
from open_vins_tpu_torch.models.runner import SimCalib, SimRun

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


def state_to_numpy(state: VioState) -> dict:
    return _to_numpy(state)


def table_to_numpy(table: FeatureTable) -> dict:
    return _to_numpy(table)


def frames_to_numpy(frames: FrameInput) -> dict:
    out = {f"win_{k}": v.cpu().numpy() for k, v in frames.win.items()}
    out.update({k: v.cpu().numpy() for k, v in frames.items() if k != "win"})
    return out


def load_reference(path) -> dict:
    """The JAX run stored in an `.npz` (a staged-run file or a `*_ref.npz`
    beside one): its per-frame `ref_*` arrays, `ref_rmse`/`ref_nees` as
    floats and `meta` (the configuration, decoded from JSON)."""
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
        ref["meta"] = json.loads(str(z["meta"]))
    ref["ref_rmse"] = float(ref["ref_rmse"])
    ref["ref_nees"] = float(ref["ref_nees"])
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
