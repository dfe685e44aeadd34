"""The step's spans (`utils/profiling.annotate`, `manager.LEAF_SPANS` and
`manager.PATH_SPANS`) on the CPU, at B = 2 streams of the `msckf_sim20`
fixture stepped by `runner.ensemble_step` from frame 12, past the first
marginalization:

(a) coverage: every aten op that the batched step dispatches lies in
    exactly one span: one of the seven leaf spans on the MSCKF-only path,
    a leaf or a path span on the joint "qr" path (the operating point)
    and with ZUPT, where the joint reduction's span
    (`ovt.step.joint_reduce`, opened once a step) nests inside
    `ovt.step.joint_update`, so its ops lie in exactly those two.  The
    exceptions are vmap's own boundary ops (`VMAP_BOUNDARY`: the unbatched
    outputs expanded to the batch), which lie outside every span;
(b) the step's outputs are bitwise the same with the profiler and the host
    clock both on as with both off;
(c) with nothing recording, `annotate` returns the shared no-op and calls
    no `torch.profiler` function;
(d) `host_clock()` records the seven leaf spans, each a whole number of
    times a step, within the wall time of the calls, and nothing once it
    is off.
"""

import time

import pytest
import torch
import torch.utils._pytree as pytree

from open_vins_tpu_torch import convert
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.init import router
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import manager, runner
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.models import updater_slam
from open_vins_tpu_torch.utils import profiling
from test_torch_fixture import CFG, MAX_TRACKS, OPPOINT_CFG
from torch_port_helpers import FIXTURE

B = 2
FRAME = 12  # frames 0-11 fill the 11-clone window; 12 marginalizes
VMAP_BOUNDARY = {"aten::expand", "aten::as_strided"}
CONFIGS = {"msckf": CFG, "qr": OPPOINT_CFG,
           "zupt": dict(OPPOINT_CFG, use_zupt=True)}
STEP_RANGE = "test.step"
# the span that nests, and the one it nests in
NESTED = {"ovt.step.joint_reduce": "ovt.step.joint_update"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    return convert.load_staged_run(FIXTURE, "cpu")[:2]


def _problem(run, name):
    """(step, state, table, frames) of B copies of the fixture's stream at
    FRAME, the state stepped there unbatched."""
    frames, calib = run
    cfg = FilterConfig(**CONFIGS[name])
    opts = tri.TriangulationOptions()
    state = runner._initial_state(cfg, calib, frames)
    table = ft.init_table(cfg, MAX_TRACKS, "cpu")
    for k in range(FRAME):
        state, table, _ = manager.step_frame(state, table, cfg, opts,
                                             runner.frame_at(frames.frames,
                                                             k))

    def stack(rec):
        return pytree.tree_map(lambda a: torch.stack([a] * B), rec)

    fr = [stack(runner.frame_at(frames.frames, k))
          for k in range(FRAME, FRAME + 3)]
    return runner.ensemble_step(cfg, opts), stack(state), stack(table), fr


@pytest.fixture(scope="module")
def msckf(run):
    return _problem(run, "msckf")


def _profiled(step, state, table, frame):
    """(outputs, host events (start, end, name) sorted) of one step call."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STEP_RANGE):
            out = step(state, table, frame)
    events = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events())
    return out, events


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spans_cover_the_step(run, msckf, name):
    step, state, table, frames = (msckf if name == "msckf"
                                  else _problem(run, name))
    allowed = set(manager.LEAF_SPANS)
    if name != "msckf":
        allowed |= set(manager.PATH_SPANS)
    out, events = _profiled(step, state, table, frames[0])
    (c0, c1), = [(s, e) for s, e, n in events if n == STEP_RANGE]
    spans = [(s, e, n) for s, e, n in events if n.startswith("ovt.")]
    assert {n for _, _, n in spans} <= allowed
    if name == "msckf":
        # the window was full and the update used features
        assert int(state.n_clones[0]) == CFG["max_clones"]
        assert (out[2].n_msckf > 0).all()
        assert {n for _, _, n in spans} == allowed
    else:
        # the joint "qr" step reduces its stack once
        assert [n for _, _, n in spans].count("ovt.step.joint_reduce") == 1
    lo, hi = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    ops = [(s, e, n) for s, e, n in events
           if n.startswith("aten::") and c0 <= s and e <= c1]
    assert len(ops) > 1000
    for s, e, n in ops:
        inside = [m for a, b, m in spans if a <= s and e <= b]
        if not inside and n in VMAP_BOUNDARY:
            assert s >= hi or e <= lo, (n, "inside the step's spans")
            continue
        nested = [m for m in inside if m in NESTED]
        if nested:
            assert sorted(inside) == sorted([*nested, NESTED[nested[0]]]), (
                n, inside)
            continue
        assert len(inside) == 1, (n, inside)


def test_outputs_bitwise_with_recorders_on(msckf):
    step, state, table, frames = msckf
    off = step(state, table, frames[0])
    with profiling.host_clock() as totals:
        on, _ = _profiled(step, state, table, frames[0])
    assert set(manager.LEAF_SPANS) <= set(totals)
    for a, b in zip(pytree.tree_leaves(off), pytree.tree_leaves(on)):
        assert torch.equal(a, b)


def test_off_path_calls_no_profiler(msckf, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function called with nothing on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    span = profiling.annotate("ovt.step.propagate")
    assert span is profiling.annotate("other") is profiling._OFF
    with span:
        pass
    step, state, table, frames = msckf
    step(state, table, frames[0])
    # the flag reads keep their names and go through the same helper
    assert (manager.ZUPT_FLAG_READ, updater_slam.INIT_FLAG_READ,
            router.INIT_SUCCESS_READ) == ("zupt.flag_read",
                                          "delayed_init.flag_read",
                                          "init.success_read")
    with profiling.host_clock() as totals:
        with profiling.annotate(manager.ZUPT_FLAG_READ):
            pass
    assert totals[manager.ZUPT_FLAG_READ][1] == 1


def test_host_clock_totals(msckf):
    step, state, table, frames = msckf
    n = len(frames)
    totals = {}
    wall = 0
    for fr in frames:
        t0 = time.perf_counter_ns()
        with profiling.host_clock(totals):
            state, table, _ = step(state, table, fr)
        wall += time.perf_counter_ns() - t0
    assert set(totals) == set(manager.LEAF_SPANS)
    per_step = {k: c // n for k, (_, c) in totals.items()}
    assert all(c == per_step[k] * n for k, (_, c) in totals.items())
    assert per_step["ovt.step.table"] == 3  # ingest, triage, clean-up
    assert all(per_step[k] == 1 for k in manager.LEAF_SPANS
               if k != "ovt.step.table")
    assert all(ns > 0 for ns, _ in totals.values())
    assert sum(ns for ns, _ in totals.values()) <= wall
    # off: nothing more is recorded
    before = {k: list(v) for k, v in totals.items()}
    step(state, table, frames[0])
    assert totals == before and profiling._clock is None
