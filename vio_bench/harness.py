"""One run of one benchmark cell: set-up, the measured window, the traced
block, the comparison that decides `correct`, and the result line.

Everything a cell is made of is found by name from `BENCHMARK.json`: its
configuration file (`configs/<config>.json`: filter, triangulation,
simulator, track table, the limits of the comparison), its traffic file
(`traffic/<traffic>.json`: streams, warm-up, samples, profiled steps) and
one reader per per-layer metric (`metrics/<name>.py`).  Nothing here names
a cell, a configuration or a stream count.

The window steps every stream one frame per step (`program.Program.step`),
keeps each step's outputs on the device, records a CUDA event after each
step and takes no host read and no synchronize between its two ends.  A
pass of the streams that ends inside the window restarts from the start
state that set-up built.  Where the window ends before a step sampled for
the comparison, the streams step on after it, outside the measurement,
until that step is done.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from vio_bench import check, gen, trace
from vio_bench.program import Program
from vio_bench.reference.feature_table import empty_table
from vio_bench.reference.layout import FilterConfig

FORBIDDEN = ("jax", "jaxlib", "flax", "open_vins_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell as BENCHMARK.json and its files define it."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json
    per_layer: list
    readers: dict  # per-layer name -> module


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    bench = root / spec["paths"][0]
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    readers = {}
    for m in per_layer:
        path = bench / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"vio_bench.metrics.{m['name']}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        readers[m["name"]] = mod
    return Cell(name, config, traffic, e2e, per_layer, readers)


@dataclass
class Run:
    """What the metric readers read of one run."""

    n_streams: int
    state_dim: int
    update_cols: int
    ensemble_start_s: float
    host_step_s_unprofiled: list = field(default_factory=list)
    trace: trace.Trace | None = None
    downdate_calls: int = 0


def _update_cols(config: dict) -> int:
    """Columns of the one EKF update a frame makes: the joint update's SLAM
    support, or the MSCKF update's camera support."""
    cfg = FilterConfig(**config["filter"])
    ranges = (cfg.slam_meas_support_ranges if cfg.max_slam > 0
              else cfg.cam_meas_support_ranges)
    return sum(b - a for a, b in ranges), cfg.state_dim


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def samples(seed: int, n_streams: int, traffic: dict, n_steps: int,
            skip=range(0)):
    """(stream indices, window steps) whose answers are compared, drawn
    from the seed: `check.streams` streams and `check.steps` steps among
    the `n_steps` that the window is expected to hold (the first step
    always), none in `skip` (the profiled block, whose launches the
    snapshots would join)."""
    rnd = random.Random(seed)
    c = traffic["check"]
    streams = sorted(rnd.sample(range(n_streams), min(c["streams"],
                                                      n_streams)))
    pool = [i for i in range(1, max(2, n_steps)) if i not in skip]
    steps = sorted({0, *rnd.sample(pool, min(c["steps"] - 1, len(pool)))})
    return streams, steps


def run_cell(root: Path, name: str, seed: int, seconds: int, traced: bool,
             dev: torch.device, t_proc0: float, log=print):
    """One run: the result line's object."""
    cell = load_cell(root, name)
    config, traffic = cell.config, cell.traffic
    sim = gen.Sim.from_dict(config["sim"])
    B = int(traffic["streams"])
    warm = int(traffic["warmup_frames"])
    n_prof = int(traffic["profile_steps"])
    ops = [getattr(r, "OP") for r in cell.readers.values() if hasattr(r, "OP")]
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)

    # set-up: inputs, the start of every stream, the warm-up
    t = time.perf_counter()
    streams = gen.make_streams(sim, B, seed, dev,
                               chunk=int(traffic.get("chunk", 32)))
    _sync(dev)
    gen_s = time.perf_counter() - t
    prog = Program(config)
    calibs, runs = prog.records(streams)
    K = streams.n_frames
    prof_at = int(traffic["profile_from"]) if traced else -1
    _sync(dev)
    t = time.perf_counter()
    state, table = prog.start(calibs, runs)
    _sync(dev)
    cols, D = _update_cols(config)
    run = Run(n_streams=B, state_dim=D, update_cols=cols,
              ensemble_start_s=time.perf_counter() - t)
    start = (prog.copy(state), prog.copy(table))
    # the landmark slots' ids over the passes' frames, which the per-frame
    # outputs do not show (`compare`); none without landmarks
    ids = []
    n_ids = (min(int(traffic["check"]["pass_frames"]), K)
             if FilterConfig(**config["filter"]).max_slam > 0 else 0)
    # the warm-up's last steps, timed alone, size the draw of the samples
    warm_outs, warm_s = [], []
    k = 0
    for _ in range(warm):
        t = time.perf_counter()
        state, table, diag = prog.step(state, table, runs, k)
        warm_outs.append(prog.outputs(state, diag))
        if len(ids) < n_ids:
            ids.append(state.slam_id.clone())
        _sync(dev)
        warm_s.append(time.perf_counter() - t)
        k += 1
    n_expected = int(seconds / max(min(warm_s[-2:]), 1e-3))
    s_idx, s_steps = samples(seed, B, traffic, n_expected,
                             range(prof_at, prof_at + n_prof) if traced
                             else range(0))
    idx = torch.tensor(s_idx, device=dev)
    start_snap = prog.snapshot(*start, idx)
    _sync(dev)
    setup_s = time.perf_counter() - t_proc0
    log(f"set-up {setup_s:.2f} s: inputs {gen_s:.2f} s, ensemble_start "
        f"{run.ensemble_start_s:.2f} s", file=sys.stderr)

    # the window
    outs, frames, snaps, post, events, host = [], [], {}, {}, [], []
    prof = done = None
    launches0 = 0
    step = 0

    def advance():
        """Frame k of every stream, with the snapshots of a sampled step:
        the host seconds of the step's call."""
        nonlocal state, table, k, step
        if k == K:
            state, table = prog.copy(start[0]), prog.copy(start[1])
            k = 0
        if step in s_steps:
            snaps[step] = prog.snapshot(state, table, idx)
        h0 = time.perf_counter()
        with torch.profiler.record_function(trace.STEP_RANGE):
            state, table, diag = prog.step(state, table, runs, k)
        host_s = time.perf_counter() - h0
        if step in snaps:
            post[step] = prog.snapshot(state, table, idx)
        outs.append(prog.outputs(state, diag))
        if len(ids) < n_ids:
            ids.append(state.slam_id.clone())
        frames.append(k)
        k += 1
        step += 1
        return host_s

    if dev.type == "cuda":
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if step == prof_at:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            launches0 = prog.downdate_launches()
        at = step
        host_s = advance()
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if prof is not None and at == prof_at + n_prof - 1:
            prof.__exit__(None, None, None)
            run.downdate_calls = prog.downdate_launches() - launches0
            done, prof = prof, None
        elif not (prof_at <= at < prof_at + n_prof):
            host.append(host_s)
    _sync(dev)
    window_s = time.perf_counter() - t0
    n_window = len(outs)
    if prof is not None:  # the window ended inside the profiled block
        prof.__exit__(None, None, None)
    while step <= s_steps[-1]:  # sampled steps that the window missed
        advance()
    _sync(dev)
    if done is not None:
        run.trace = trace.reduce(done, n_prof, ops)
        t = run.trace
        log(f"trace: {n_prof} steps, " + ("no device events" if t is None
            else f"{t.kernels} kernels, busy {t.busy_s} s of {t.window_s} s"
            f", {run.downdate_calls} downdate calls, {t.op_device_s}"),
            file=sys.stderr)
    run.host_step_s_unprofiled = host
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    log(f"window: {n_window} steps, then {len(outs) - n_window} to the last "
        f"sample; samples drawn over {n_expected} steps: {s_steps}",
        file=sys.stderr)
    del state, table, start, prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare(config, traffic, streams, warm_outs + outs, frames,
                      snaps, post, start_snap, s_idx, log, ids)
    limits = config["check"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    attempted = B * n_window
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            "stream_frames_per_s": B * n_window / window_s,
            "step_ms_p95": (_p95(step_ms) if step_ms else None),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": int(numbers["nonfinite"]), "metrics": metrics,
              "device": device}
    if traced:
        t = run.trace
        device["busy_s"] = t.busy_s if t else 0.0
        device["window_s"] = t.window_s if t else 0.0
        if t:
            result["breakdown"] = {"device_ops": trace.top(t.kernel_time),
                                   "idle_gaps": trace.top(t.idle_by_host)}
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    return result


def _p95(values):
    """The 95th percentile, linear between order statistics."""
    v = sorted(values)
    x = 0.95 * (len(v) - 1)
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def compare(config, traffic, streams, all_outs, frames, snaps, post,
            start_snap, s_idx, log, slam_ids=()):
    """The compared numbers (`vio_bench.check`).  `all_outs`: the
    per-frame outputs of the warm-up's steps, then of the window's;
    `slam_ids`: the landmark slots' ids [B, L] of the first steps (empty
    without landmarks)."""
    finite = torch.stack([
        torch.stack([torch.isfinite(x).reshape(x.shape[0], -1).all(1)
                     for x in o[:4]]).all(0) for o in all_outs])
    nonfinite = int((~finite).sum())
    start_gap = 0.0
    st0, tb0 = ({k: v.to("cpu") for k, v in d.items()} for d in start_snap)
    cfg = FilterConfig(**config["filter"])
    for j, b in enumerate(s_idx):
        start_gap = max(start_gap, check.start_gap(
            {k: st0[k][j] for k in ("q", "p", "v", "cov")},
            {k: v[j] for k, v in tb0.items()},
            check.reference_start(config, streams, b),
            empty_table(cfg, int(config["max_tracks"]))))

    def sampled(out):
        return [x.index_select(0, torch.tensor(s_idx, device=x.device))
                .to("cpu") for x in out]

    # the passes from the start, the reference alone
    t = time.perf_counter()
    n_pass = min(int(traffic["check"]["pass_frames"]), streams.n_frames,
                 len(all_outs))
    pass_outs = [sampled(o) for o in all_outs[:n_pass]]
    pass_ids = sampled(slam_ids[:n_pass])
    p_gaps, p_covs, stops, p_decision = [], [], [], 0
    for j, b in enumerate(s_idx):
        stop = None
        for f, (r_st, r_diag, near, n_near) in enumerate(
                check.reference_pass(config, streams, b, n_pass)):
            out = [x[j] for x in pass_outs[f]]
            g, c, counts = check.step_gaps(out, r_st, r_diag)
            moved = (check.landmark_moves(pass_ids[f][j], out[5], r_st,
                                          r_diag) if pass_ids else 0)
            if counts or moved:
                stop = (b, f, round(near, 3), moved, n_near)
                p_decision += near >= 1.0 or moved > 2 * n_near
                break
            p_gaps.append(g)
            p_covs.append(c)
        if stop:
            stops.append(stop)
    uncompared = len(s_idx) * n_pass - len(p_gaps)
    log(f"passes: {len(p_gaps)} frames of {len(s_idx)} streams compared, "
        f"{uncompared} not; stopped at (stream, frame, nearest gate in "
        f"tolerances, landmarks moved, decisions near) {stops}; in "
        f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    if len(p_gaps) <= uncompared:
        p_gaps, p_covs = [math.inf], [math.inf]

    # the sampled steps, from the program's own state
    window_outs = all_outs[len(all_outs) - len(frames):]
    gaps, covs, decision, undecided, worst = [], [], 0, 0, None
    t = time.perf_counter()
    for step in sorted(snaps):
        st, tb = ({k: v.to("cpu") for k, v in d.items()}
                  for d in snaps[step])
        pst, ptb = ({k: v.to("cpu") for k, v in d.items()}
                    for d in post[step])
        out = sampled(window_outs[step])
        for j, b in enumerate(s_idx):
            r_st, r_tb, r_diag, near = check.reference_step(
                config, {k: v[j] for k, v in st.items()},
                {k: v[j] for k, v in tb.items()},
                check.frame_input(streams, b, frames[step]))
            g, c, counts = check.step_gaps([x[j] for x in out], r_st, r_diag)
            same = not counts and check.same_outcome(
                {k: v[j] for k, v in pst.items()},
                {k: v[j] for k, v in ptb.items()}, r_st, r_tb)
            if not same:
                if near < 1.0:
                    undecided += 1
                else:
                    decision += 1
                continue
            gaps.append(g)
            covs.append(c)
            if worst is None or g > worst[0]:
                worst = (g, c, b, step, frames[step])
    log(f"reference: {len(gaps)} samples agree, {decision} differ, "
        f"{undecided} undecided, in {time.perf_counter() - t:.1f} s; "
        f"largest gap (sigma, cov, stream, step, frame): {worst}",
        file=sys.stderr)
    if len(gaps) <= undecided:  # too few samples decided: none checked
        gaps, covs = [math.inf], [math.inf]
    return {"state_gap_sigma": max(gaps), "cov_gap": max(covs),
            "pass_gap_sigma": max(p_gaps), "pass_cov_gap": max(p_covs),
            "decision_gap": decision + p_decision, "start_gap": start_gap,
            "nonfinite": nonfinite}


def emit(result: dict):
    """The compared numbers with their limits as the last lines of
    standard error, the result as the last line of standard output."""
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def loaded_forbidden():
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
