"""Reduction of a `torch.profiler` trace, read in memory (no Chrome trace is
written): the device's busy time as the union of its kernel spans, launches,
idle gaps by what the host was doing, and the device time of the kernels
launched under a named operator's profiler range.

The arithmetic of the union of kernel spans and of the idle share is
copied from `tools/torch_main_path_profile.py`.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# the harness's profiler range around each step call
STEP_RANGE = "vio_bench.step"


@dataclass
class Trace:
    """What the metric readers take from one profiled block of steps.
    Times in seconds."""

    steps: int
    window_s: float  # first profiled step call to the last kernel's end
    busy_s: float  # union of kernel spans inside the window
    kernels: int  # kernel launches (copies and fills not counted)
    kernel_time: dict = field(default_factory=dict)  # name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # host op -> seconds
    op_device_s: dict = field(default_factory=dict)  # op suffix -> seconds


def _union(spans):
    """Total length of the union of [start, end) spans."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(spans, lo, hi):
    """[start, end) gaps of [lo, hi) that no span covers."""
    out, t = [], lo
    for s, e in sorted(spans):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def _host_op_at(cpu, times):
    """For each time (sorted), the name of the innermost host op running
    at it, or "none": one sweep over the ops (sorted by start, nested as
    a call tree) with a stack of the open ones."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(cpu) and cpu[i][0] <= t:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "none")
    return out


def reduce(prof, steps: int, ops=()) -> Trace | None:
    """A Trace of a finished profiler over `steps` harness steps, with the
    device time of the kernels launched inside each operator range whose
    name ends with one of `ops`.  None when the trace holds no kernel."""
    events = prof.profiler.kineto_results.events()
    kern, cpu, step_ranges = [], [], []
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            # device work: kernels, copies and fills; not the mirrored
            # record_function ranges
            if not e.is_user_annotation():
                kern.append((e.start_ns(), e.end_ns(), e.name(),
                             e.linked_correlation_id()))
            continue
        s, t = e.start_ns(), e.end_ns()
        if e.name() == STEP_RANGE:
            step_ranges.append((s, t, e.start_thread_id()))
        cpu.append((s, t, e.name(), e.start_thread_id(), e.correlation_id()))
    if not kern or not step_ranges:
        return None
    lo = min(s for s, _, _ in step_ranges)
    hi = max(max(e for _, e, _ in step_ranges), max(k[1] for k in kern))
    spans = [(max(s, lo), min(e, hi)) for s, e, _, _ in kern
             if e > lo and s < hi]
    busy = _union(spans)
    ktime = defaultdict(float)
    for s, e, n, _ in kern:
        ktime[n] += (e - s) * 1e-9
    # idle gaps by the host op running on the step thread at their start
    tid = step_ranges[0][2]
    host = sorted((s, t, n) for s, t, n, th, _ in cpu
                  if th == tid and not n.startswith("cuda"))
    gaps = _gaps(spans, lo, hi)
    idle = defaultdict(float)
    for (a, b), n in zip(gaps, _host_op_at(host, [g[0] for g in gaps])):
        idle[n] += (b - a) * 1e-9
    # device time under operator ranges (children of the range included)
    op_s = {}
    for suffix in ops:
        ranges = [(s, t, th) for s, t, n, th, _ in cpu if n.endswith(suffix)]
        corr = {c for s, t, n, th, c in cpu
                if any(th == rth and rs <= s and t <= rt
                       for rs, rt, rth in ranges)}
        hit = [(s, e) for s, e, _, lc in kern if lc in corr]
        if hit:
            op_s[suffix] = sum(e - s for s, e in hit) * 1e-9
    return Trace(steps=steps, window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                 kernels=sum(1 for k in kern if lo <= k[0] < hi
                             and not k[2].startswith(("Memcpy", "Memset"))),
                 kernel_time=dict(ktime), idle_by_host=dict(idle),
                 op_device_s=op_s)


def top(d: dict, n: int = 10, width: int = 100):
    """The n largest entries of a name -> seconds dict, as [name, s], each
    name cut to `width` characters."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
