"""Per-frame stage timing: the reference's timing-CSV observability channel.

Counterpart of `open_vins_tpu/utils/timing.py`, with the same CSV schema
(`COLUMNS`, a `#` header, 9 decimals), and of the reference's opt-in
timing records (VioManager.cpp:104-122,631-644: per-frame CSV of
{tracking, propagation, msckf update, slam update+init, re-tri/marg,
total}) consumed by the ov_eval timing tools.

CUDA runs asynchronously: without a synchronization at a stage boundary
the host clock reads when the stage's kernels were launched, not when they
ran.  `FrameTimer` takes the device the stages run on and, for a CUDA
device, calls `torch.cuda.synchronize()` before every reading of the clock
(the counterpart of the `block_until_ready` that the JAX package asks of
its callers); for a CPU device it reads the clock alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device

COLUMNS = ["timestamp", "tracking", "propagation", "msckf", "slam",
           "retri_marg", "total"]


class FrameTimer:
    """Accumulates stage durations for one frame; writes CSV rows.

    `device` (None = CUDA) is where the timed work runs: a CUDA device is
    synchronized at every stage boundary."""

    def __init__(self, path=None, device=None):
        self.path = path
        dev = resolve_device(device)
        self._sync = dev.type == "cuda"
        self._f = open(path, "w") if path else None
        if self._f:
            self._f.write("#" + ",".join(COLUMNS) + "\n")
        self._t0 = None
        self._stages = {}
        self._mark = None

    def _now(self):
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def start_frame(self):
        self._t0 = self._now()
        self._mark = self._t0
        self._stages = {c: 0.0 for c in COLUMNS[1:-1]}

    def stage(self, name):
        now = self._now()
        if self._mark is not None and name in self._stages:
            self._stages[name] += now - self._mark
        self._mark = now

    def end_frame(self, timestamp):
        total = self._now() - self._t0
        row = [timestamp] + [self._stages[c] for c in COLUMNS[1:-1]] + [total]
        if self._f:
            self._f.write(",".join(f"{v:.9f}" for v in row) + "\n")
        return total

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def load_timing_csv(path):
    """-> dict column -> array of floats (Loader::load_timing parity)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split(",")])
    arr = np.asarray(rows)
    return {c: arr[:, i] for i, c in enumerate(COLUMNS)}
