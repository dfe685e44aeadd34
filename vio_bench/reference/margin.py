"""How near one reference step came to deciding otherwise.

Each gate of the step (triangulation's condition and depth tests, the
observation depth test, the χ² gates, delayed init's gates) notes
how far its values lie from its threshold, relative to the threshold and in
units of a tolerance: the program computes the same gate in float32, so a
value nearer its threshold than that can fall on either side there.  The
harness resets the record before each reference step and reads the
smallest note after it (`vio_bench/check.py`).
"""

from __future__ import annotations

import math

import torch

# relative tolerances by gate: the float32 value's plausible error
CHI2 = 1e-3
COND = 5e-2  # the 3x3 normal matrix's condition number, up to 1e4
DEPTH = 1e-3

_record = {"worst": math.inf, "gate": "", "near": 0}


def reset():
    _record.update(worst=math.inf, gate="", near=0)


def note(gate: str, value, threshold, mask, tol: float):
    """Record min |value / threshold − 1| / tol over the entries of
    `mask`, and count the entries under 1."""
    value = torch.as_tensor(value)
    rel = (value / threshold - 1.0).abs() / tol
    rel = torch.where(mask & torch.isfinite(rel), rel, math.inf)
    m = float(rel.min()) if rel.numel() else math.inf
    if m < _record["worst"]:
        _record.update(worst=m, gate=gate)
    _record["near"] += int((rel < 1.0).sum())


def worst():
    """(smallest note since the last reset, its gate)."""
    return _record["worst"], _record["gate"]


def near_count() -> int:
    """The decisions since the last reset that lay within tolerance."""
    return _record["near"]
