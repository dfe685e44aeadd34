"""Spans of the port and device-level tracing via torch.profiler (Chrome /
Perfetto traces).

Counterpart of `open_vins_tpu/utils/profiling.py`, which captures an XLA
profiler trace.  The reference's observability story is a per-frame timing
CSV plus offline timing tools (ov_msckf/src/core/VioManager.cpp:104-122 CSV
+ ov_eval timing_* binaries); `utils/timing.py` reproduces that channel.
This module adds what ran, by two sinks of one span helper:

- `annotate(name)` is the port's only span.  Under a `torch.profiler`
  capture (`trace(logdir)` below, or any `torch.profiler.profile`) it opens
  a `record_function` range, on the profiler's clock, which is the clock of
  the CUDA kernels in the same trace: spans and kernels share one timeline.
- Inside `host_clock()` it also adds its host duration
  (`time.perf_counter_ns`, no synchronize: dispatch plus any blocking on a
  full launch queue) to an in-memory dict of name -> [total ns, count].
  The step's leaf spans do not nest, so each of their totals is the span's
  self time; a span that encloses another (a flag read inside a path's
  span) counts the inner one's time too.
- With neither sink on, `annotate` returns one shared no-op context
  manager; its cost is one check of the profiler's flag and one of the
  clock's.

`trace(logdir)` captures the host's operator spans and, on a CUDA device,
every kernel with its device time, written as a Chrome trace
(`*.pt.trace.json`) into the log directory, viewable in Perfetto or
`chrome://tracing`.

The port's span names:
- `ovt.step.<stage>` in `models/manager.step_frame`: the seven leaf spans
  that cover the MSCKF-only step (`manager.LEAF_SPANS`: marginalize,
  propagate, table, triangulate, linearize, compress, ekf_update), and the
  top-level spans of the other paths (`manager.PATH_SPANS`: zupt,
  slam_update, delayed_init, joint_update);
- the host reads of a device flag: `zupt.flag_read`
  (`manager.ZUPT_FLAG_READ`), `delayed_init.flag_read`
  (`updater_slam.INIT_FLAG_READ`) and `init.success_read`
  (`init/router.INIT_SUCCESS_READ`).

Usage:
    with trace("runs/trace"):
        with annotate("step"):
            state, table, diag = manager.step_frame(...)

    with host_clock() as totals:  # {"ovt.step.propagate": [ns, n], ...}
        state, table, diag = manager.step_frame(...)

Notes:
- Wrap a steady-state run: the first calls of a run load cuBLAS and
  cuSOLVER and build the port's kernels, which a trace would show as such.
- The trace holds CUDA activity only where CUDA is available.
- A span inside a `torch.func.vmap`'d function opens once per call, not
  once per stream.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
# the active host clock's totals (name -> [total ns, count]), or None
_clock = None


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager: capture a torch.profiler trace into `logdir`.

    Degrades to a no-op (with a warning) if the profiler cannot start, so
    callers can leave `--profile` flags wired unconditionally."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log = logging.getLogger(__name__)
    try:
        prof = profile(activities=activities,
                       on_trace_ready=torch.profiler.tensorboard_trace_handler(
                           logdir))
        prof.__enter__()
    except Exception as e:  # pragma: no cover - backend-dependent
        log.warning("torch.profiler failed to start (%s); profiling "
                    "disabled", e)
        yield None
        return
    try:
        yield logdir
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        except Exception as e:  # pragma: no cover - backend-dependent
            log.warning("torch.profiler failed to stop: %s", e)


@contextlib.contextmanager
def host_clock(totals: dict | None = None):
    """Context manager: every `annotate` span inside it adds its host
    nanoseconds and one count to `totals[name]` ([total ns, count]; a new
    dict when None), which it yields.  Pass the same dict again to add
    more calls to it.  The clock takes no synchronize."""
    global _clock
    totals = {} if totals is None else totals
    outer, _clock = _clock, totals
    try:
        yield totals
    finally:
        _clock = outer


class _Clocked:
    """A span inside `host_clock()`: its host ns into the clock's totals,
    inside a profiler range when the profiler records."""

    __slots__ = ("name", "totals", "range", "t0")

    def __init__(self, name, totals, recording):
        self.name = name
        self.totals = totals
        self.range = torch.profiler.record_function(name) if recording \
            else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        entry = self.totals.setdefault(self.name, [0, 0])
        entry[0] += dt
        entry[1] += 1
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The span `name` (the module docstring): a profiler range while a
    capture records, a host-clock entry inside `host_clock()`, else the
    shared no-op."""
    recording = _profiling()
    if _clock is None:
        return torch.profiler.record_function(name) if recording else _OFF
    return _Clocked(name, _clock, recording)
