"""Device-level tracing via torch.profiler (Chrome / Perfetto traces).

Counterpart of `open_vins_tpu/utils/profiling.py`, which captures an XLA
profiler trace.  The reference's observability story is a per-frame timing
CSV plus offline timing tools (ov_msckf/src/core/VioManager.cpp:104-122 CSV
+ ov_eval timing_* binaries); `utils/timing.py` reproduces that channel.
This module adds a capture of what ran: the host's operator spans and, on
a CUDA device, every kernel with its device time, written as a Chrome
trace (`*.pt.trace.json`) into the log directory, viewable in Perfetto or
`chrome://tracing`.

Usage:
    with trace("runs/trace"):
        with annotate("step"):
            state, table, diag = manager.step_frame(...)

Notes:
- Wrap a steady-state run: the first calls of a run load cuBLAS and
  cuSOLVER and build the port's kernels, which a trace would show as such.
- The trace holds CUDA activity only where CUDA is available.
"""

from __future__ import annotations

import contextlib
import logging


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager: capture a torch.profiler trace into `logdir`.

    Degrades to a no-op (with a warning) if the profiler cannot start, so
    callers can leave `--profile` flags wired unconditionally."""
    import torch
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


def annotate(name: str):
    """A labelled host-side range inside a capture (record_function)."""
    import torch

    return torch.profiler.record_function(name)
