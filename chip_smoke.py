"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds (any failure raises,
so the exit code is not 0):

1. environment: torch / CUDA versions and the card's
   `nvidia-smi --query-gpu=name,power.limit` line;
2. build: every CUDA kernel of the port from the sources in the checkout,
   one nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes it is timed at and at edge shapes (checked only), with the least
   time the card could take and two times of the kernel and of the nearest
   single PyTorch call: `device_ms`, a CUDA graph of 50 calls replayed
   between one event pair (kernel and library call in turns), and
   `call_ms`, one event pair around each eager call, which is what the
   eager main path pays (host dispatch included).  `symmetric_downdate` at
   the reference's oracle shapes, the main paths' (120, 81) and (270, 231)
   and the large map's (1434, 231); `householder_qr_blocks` at the oracle
   shapes and the row blocks of the MSCKF-only stack (760 × 121) and of the
   operating point's joint stack (1174 × 271);
4. the MSCKF-only closed loop (11 clones, 200 points, <= 40 MSCKF features
   per update, 20 Hz camera / 200 Hz IMU, rk4) over the 399 staged frames
   of `open_vins_tpu_torch/data/msckf_sim20_seed0.npz`, after a 40-frame
   warm-up;
5. the TSQR path on real stacks: the operating point stepped frame by frame,
   and at three frames with the window full and landmarks in use the joint
   stack is built from the frame's pre-update state by the manager's own
   functions and compressed by `compress_system` (the Householder TSQR,
   through `householder_qr_blocks`), against `compress_system_ranges`
   (the filter's CholeskyQR2) on the same stack: same information and the
   same EKF update;
6. the operating point's closed loop (bench.py:94-96: 11 clones, 50 SLAM
   landmarks, <= 40 MSCKF features, ACI², the joint "qr" update) over the
   same 399 frames, through `runner.run_filter`.

Each closed loop sets the kernels' launch counts to 0 just before its timed
run and reads them just after; it must pass the health gate (finite
covariance, RMSE < 0.05 m, 0.2 < NEES < 30) and land within 0.01 m RMSE of
the JAX run on the same frames.  The line before the last lists every
kernel's numbers; the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "open_vins_tpu_torch", "data")
FIXTURE = os.path.join(DATA, "msckf_sim20_seed0.npz")
OPPOINT_REF = os.path.join(DATA, "oppoint_sim20_seed0_ref.npz")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 non-tensor
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

DOWNDATE_SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81),
                   (270, 231), (1434, 231)]
DOWNDATE_EDGE_SHAPES = [(1, 5), (1, 0), (33, 20), (33, 0)]  # checked only
OPPOINT_SHAPE = (270, 231)  # D and support width at the operating point
# (label, g, B, n) of the QR blocks: the JAX oracle shapes, then the stacks'
# blocks as update_helper._tsqr_r cuts them (B = 2n rounded up to 32)
QR_SHAPES = [("oracle", 3, 256, 128), ("oracle", 3, 512, 128),
             ("oracle", 3, 384, 256), ("msckf_stack", 760, 256, 121),
             ("oppoint_stack", 1174, 544, 271)]
# checked only: n < 32 (one ragged panel), B = n, g = 1 at the stack's n,
# a block taller than the register panel's 640 rows
QR_EDGE_SHAPES = [("edge", 2, 40, 15), ("edge", 1, 71, 71),
                  ("edge", 1, 544, 271), ("edge", 1, 704, 96)]
QR_ELEMENT_TOL = 1e-5  # × max|R|: the same reflectors, sums in another order
RMSE_GATE_M = 0.05
REF_RMSE_SPREAD_M = 0.01
MSCKF_WARM_FRAMES = 40
TSQR_FRAMES = (20, 30, 40)  # window full, 32-50 landmarks in use


def emit(obj):
    print(json.dumps(obj), flush=True)


def call_ms(fn, n_runs=200, n_warm=20):
    """Median of per-call CUDA-event times of `fn` (ms): one event pair
    around each eager call, so a short kernel reads the host's dispatch."""
    import torch

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fns, n_calls=50, n_rounds=6):
    """Device time per call (ms) of each function of `fns` (name -> fn): the
    function's n_calls calls are captured in one CUDA graph, and the graphs
    are replayed in turns (forward, then backward order) between one event
    pair each; median over n_rounds of replay time / n_calls.  Inputs stay
    in the 50 MB L2 between calls, as they do for the eager caller."""
    import torch

    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n_calls):
                fn()
        graphs[name] = graph
    names = list(graphs)
    for name in names:
        graphs[name].replay()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(n_rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graphs[name].replay()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / n_calls)
    del graphs
    return {name: statistics.median(t) for name, t in times.items()}


def _times(row, kernel, library, plain, n_call=200, n_plain=200):
    """Device and per-call times of a kernel and its library call, the
    plain version's per-call time and the bound's share of the kernel's
    device time, into `row` (which holds bound_ms)."""
    dev = device_ms({"kernel": kernel, "library": library})
    row["device_ms"] = dev["kernel"]
    row["call_ms"] = call_ms(kernel, n_runs=n_call, n_warm=3)
    row["library_device_ms"] = dev["library"]
    row["library_call_ms"] = call_ms(library, n_runs=n_call, n_warm=3)
    row["plain_ms"] = call_ms(plain, n_runs=n_plain, n_warm=1)
    row["bound_share"] = row["bound_ms"] / row["device_ms"]


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build():
    from open_vins_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})


def _bound(n_bytes, n_ops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the f32 operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def downdate_bound_ms(D, m, same):
    """Inputs read once (K = PHt counts once), output written once.  With
    K = PHt the product K·Kᵀ is symmetric and only its D(D+1)/2 upper
    entries are needed: D·(D+1)·m f32 operations; else 2·D²·m."""
    return _bound(4 * (D * D + (1 if same else 2) * D * m + D * D),
                  (D * (D + 1.0) if same else 2.0 * D * D) * m)


def qr_bound_ms(g, B, n):
    """A read once, R written once, (2·B·n² − ⅔·n³)·g f32 operations."""
    return _bound(4 * g * (B * n + n * n),
                  g * (2.0 * B * n * n - 2.0 / 3.0 * n ** 3))


def phase_downdate():
    """symmetric_downdate against its plain version at every shape."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for D, m in DOWNDATE_SHAPES + DOWNDATE_EDGE_SHAPES:
        for same in (True, False):
            A = torch.randn(D, D, device="cuda", generator=gen)
            P = (A + A.T) / 2
            K = torch.randn(D, m, device="cuda", generator=gen) / m ** 0.5
            PHt = K if same else (torch.randn(D, m, device="cuda",
                                              generator=gen) / m ** 0.5)
            out = kernels.symmetric_downdate(P, K, PHt)
            ref = kernels.symmetric_downdate_ref(P, K, PHt)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
            symmetric = bool(torch.equal(out, out.T))
            row = {"phase": "kernel", "name": "symmetric_downdate",
                   "D": D, "m": m, "K_is_PHt": same, "max_abs_err": err,
                   "tol": tol, "exactly_symmetric": symmetric}
            if not (err <= tol and symmetric and torch.isfinite(out).all()):
                emit(row)
                raise AssertionError(f"symmetric_downdate disagrees at "
                                     f"D={D}, m={m}, K_is_PHt={same}")
            if (D, m) in DOWNDATE_SHAPES:
                row["bound_ms"], row["bound_by"] = downdate_bound_ms(D, m,
                                                                     same)
                _times(row, lambda: kernels.symmetric_downdate(P, K, PHt),
                       lambda: torch.addmm(P, K, PHt.mT, alpha=-1),
                       lambda: kernels.symmetric_downdate_ref(P, K, PHt))
            emit(row)
            rows[(D, m, same)] = row
    emit({"phase": "kernel_downdate", "seconds": time.perf_counter() - t0})
    return rows


def _qr_input(label, g_or_m, B, n, gen):
    """Row blocks [g, B, n]: the oracle's Gaussian blocks with the last 7
    rows and 5 columns zeroed, or a Gaussian stack of m rows with the joint
    stack's zero columns (IMU block, IMU-intrinsic tail) padded with zero
    rows and cut into blocks, as update_helper._tsqr_r does."""
    import torch

    if label in ("oracle", "edge"):
        A = torch.randn(g_or_m, B, n, device="cuda", generator=gen)
        A[:, -7:, :] = 0.0
        A[:, :, -5:] = 0.0
        return A
    m = g_or_m
    g = -(-m // B)
    A = torch.zeros(g * B, n, device="cuda")
    A[:m] = torch.randn(m, n, device="cuda", generator=gen)
    A[:, :15] = 0.0
    A[:, n - 25:n - 1] = 0.0
    return A.reshape(g, B, n).contiguous()


def phase_qr():
    """householder_qr_blocks against its plain version at every shape:
    RᵀR = AᵀA per block (tests/test_pallas_kernels.py's atol = rtol =
    2e-3), an exactly-zero strict lower triangle, and element-wise agreement
    with the plain version at QR_ELEMENT_TOL·max|R|."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, g_or_m, B, n in QR_SHAPES + QR_EDGE_SHAPES:
        A = _qr_input(label, g_or_m, B, n, gen)
        g = A.shape[0]
        R = kernels.householder_qr_blocks(A)
        ref = kernels.householder_qr_blocks_ref(A)
        torch.cuda.synchronize()
        err = (R - ref).abs().max().item()
        tol = QR_ELEMENT_TOL * ref.abs().max().item()
        A64, R64 = A.double(), R.double()
        G, G2 = A64.mT @ A64, R64.mT @ R64
        gram_ok = bool(((G2 - G).abs() <= 2e-3 + 2e-3 * G.abs()).all())
        tril_zero = bool((torch.tril(R, -1) == 0).all())
        row = {"phase": "kernel", "name": "householder_qr_blocks",
               "input": label, "g": g, "B": B, "n": n, "max_abs_err": err,
               "tol": tol, "gram_ok": gram_ok,
               "gram_max_abs_err": (G2 - G).abs().max().item(),
               "strict_lower_zero": tril_zero}
        if not (err <= tol and gram_ok and tril_zero
                and torch.isfinite(R).all()):
            emit(row)
            raise AssertionError(f"householder_qr_blocks disagrees at "
                                 f"{label} [g, B, n] = {[g, B, n]}")
        if label != "edge":
            row["bound_ms"], row["bound_by"] = qr_bound_ms(g, B, n)
            _times(row, lambda: kernels.householder_qr_blocks(A),
                   lambda: torch.linalg.qr(A, mode="r"),
                   lambda: kernels.householder_qr_blocks_ref(A),
                   n_call=20, n_plain=5)
            rows[(label, B, n)] = row
        emit(row)
    emit({"phase": "kernel_qr", "seconds": time.perf_counter() - t0})
    return rows


def _prefix(run, n):
    """The first n frames of a staged run."""
    from open_vins_tpu_torch.models import runner

    frames = run.frames
    f = type(frames)(**{k: (type(v)(**{a: b[:n] for a, b in v.items()})
                            if k == "win" else v[:n])
                        for k, v in frames.items()})
    return runner.SimRun(frames=f, gt_q=run.gt_q[:n + 1],
                         gt_p=run.gt_p[:n + 1], gt_v=run.gt_v[:n + 1])


def _closed_loop(name, cfg, run, calib, ref, max_tracks):
    """One timed `runner.run_filter` pass with the launch counts set to 0
    just before it and read just after; the health gate and the JAX check."""
    import torch

    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels

    n_frames = run.frames.t_new.shape[0]
    kernels.symmetric_downdate.launches = 0
    kernels.householder_qr_blocks.launches = 0
    t0 = time.perf_counter()
    state, outs = runner.run_filter(cfg, tri.TriangulationOptions(), calib,
                                    run, max_tracks=max_tracks,
                                    device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"symmetric_downdate": kernels.symmetric_downdate.launches,
                "householder_qr_blocks":
                    kernels.householder_qr_blocks.launches}

    qs, ps, _, covs6, diag = outs
    rmse, nees = runner.pose_metrics(qs, ps, covs6, run.gt_q, run.gt_p)
    finite = bool(torch.isfinite(state.cov).all().item())
    gap = float((ps.cpu() - torch.as_tensor(ref["ref_p"])).norm(dim=1).max())
    row = {"phase": name, "frames": n_frames,
           "frames_per_s": n_frames / seconds, "seconds": seconds,
           "rmse_m": rmse, "nees": nees, "finite": finite,
           "jax_rmse_m": ref["ref_rmse"], "jax_nees": ref["ref_nees"],
           "max_position_gap_to_jax_m": gap,
           "n_msckf_mean": float(diag.n_msckf.float().mean()),
           "n_slam_mean": float(diag.n_slam.float().mean()),
           "n_slam_used_mean": float(diag.n_slam_used.float().mean()),
           "launches": launches}
    emit(row)
    healthy = finite and rmse < RMSE_GATE_M and 0.2 < nees < 30.0
    if not healthy:
        raise AssertionError(f"{name}: health gate failed")
    if abs(rmse - ref["ref_rmse"]) > REF_RMSE_SPREAD_M:
        raise AssertionError(f"{name}: RMSE {rmse} is more than "
                             f"{REF_RMSE_SPREAD_M} m from the JAX run's "
                             f"{ref['ref_rmse']}")
    if launches["symmetric_downdate"] < n_frames:
        raise AssertionError(f"{name}: symmetric_downdate launched "
                             f"{launches['symmetric_downdate']} times over "
                             f"{n_frames} frames")
    return row


def phase_msckf_path(run, calib, ref):
    """The MSCKF-only closed loop, after a short warm-up prefix (cuBLAS /
    cuSOLVER handles, the allocator)."""
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri

    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    t0 = time.perf_counter()
    runner.run_filter(cfg, tri.TriangulationOptions(), calib,
                      _prefix(run, MSCKF_WARM_FRAMES),
                      max_tracks=meta["max_tracks"], device="cuda")
    warm_s = time.perf_counter() - t0
    row = _closed_loop("main_path_msckf", cfg, run, calib, ref,
                       meta["max_tracks"])
    emit({"phase": "main_path_msckf_total",
          "seconds": warm_s + row["seconds"], "warm_up_seconds": warm_s})
    return row


def _tsqr_check(state, cfg, H, res):
    """compress_system (TSQR) against compress_system_ranges on one stack:
    tests/test_compress.py's information check (HᵀH at atol 2e-2, rtol
    1e-3; Hᵀres at atol 5e-3, rtol 1e-3) and update check (ekf_update both
    ways: p within 2e-4, cov within 2e-3).  The information check reads the
    information of the stack with unit-norm columns, G_ij / √(G⁰_ii G⁰_jj)
    with G⁰ = [H | res]ᵀ[H | res] of the raw stack: a real stack's Gram
    entries reach 1e7 (pixel rows over depths of metres), and f32 holds them
    only to about 1e-7 of √(G_ii G_jj); compression commutes with column
    scaling, so the normalized check is the test's own on a well-scaled
    stack.  Returns the row of numbers."""
    import torch

    from open_vins_tpu_torch.core import ekf
    from open_vins_tpu_torch.models import update_helper as uh
    from open_vins_tpu_torch.ops import kernels

    D = cfg.state_dim
    ranges = cfg.slam_meas_support_ranges
    before = kernels.householder_qr_blocks.launches
    Hq, rq = uh.compress_system(H, res, D)
    launches = kernels.householder_qr_blocks.launches - before
    Hr, rr = uh.compress_system_ranges(H, res, ranges, D)
    s_q = ekf.ekf_update(state, cfg, Hq, rq, torch.ones_like(rq))
    s_r = ekf.ekf_update(state, cfg, Hr, rr, torch.ones_like(rr),
                         ranges=ranges)

    A0 = torch.cat([H, res[:, None]], dim=1).double()
    g0 = (A0 * A0).sum(dim=0)
    scale = torch.where(g0 > 0, g0.rsqrt(), 0.0)  # unit-norm columns
    sH, sr = scale[:D], scale[D]

    def info(Hc, rc):
        Hs = Hc.double() * sH
        return Hs.T @ Hs, Hs.T @ (rc.double() * sr)

    (GH_q, Gr_q), (GH_r, Gr_r) = info(Hq, rq), info(Hr, rr)

    def excess(a, b, atol, rtol):
        """max of |a − b| − (atol + rtol·|b|): ≤ 0 passes."""
        return ((a - b).abs() - (atol + rtol * b.abs())).max().item()

    return {
        "rows": H.shape[0], "cols": D + 1, "qr_launches": launches,
        "info_HtH_excess": excess(GH_q, GH_r, 2e-2, 1e-3),
        "info_Htres_excess": excess(Gr_q, Gr_r, 5e-3, 1e-3),
        "info_HtH_max_abs_err": (GH_q - GH_r).abs().max().item(),
        "info_Htres_max_abs_err": (Gr_q - Gr_r).abs().max().item(),
        "update_p_gap": (s_q.p - s_r.p).abs().max().item(),
        "update_cov_gap": (s_q.cov - s_r.cov).abs().max().item(),
        "finite": bool(torch.isfinite(Hq).all() and torch.isfinite(rq).all()),
    }


def phase_tsqr(run, calib, ref):
    """The operating point stepped to the last of TSQR_FRAMES; at each of
    them the joint stack from the frame's pre-update state goes through
    the TSQR compression and is held against compress_system_ranges."""
    import torch

    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import feature_table as ft
    from open_vins_tpu_torch.models import manager, runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels, lie

    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    opts = tri.TriangulationOptions()
    t0 = time.perf_counter()
    state = manager.initialize_from_gt(
        cfg, run.gt_q[0], run.gt_p[0], run.gt_v[0], calib.bias_g0,
        calib.bias_a0, 0.0, calib_ext_q=lie.rot_2_quat(calib.cam_R_ItoC),
        calib_ext_p=calib.cam_p_IinC, calib_intr=calib.cam_intr)
    table = ft.init_table(cfg, meta["max_tracks"], "cuda")
    kernels.householder_qr_blocks.launches = 0
    checks = []
    for k in range(max(TSQR_FRAMES) + 1):
        frame = runner.frame_at(run.frames, k)
        if k in TSQR_FRAMES:
            st, tb, reserved = manager.pre_update(state, table, cfg, frame)
            st, _, H, res, _, _ = manager.build_joint_system(
                st, cfg, tb, opts, reserved)
            row = _tsqr_check(st, cfg, H, res)
            row.update(frame=k, n_slam=int(st.slam_valid.sum()))
            checks.append(row)
            emit({"phase": "tsqr_stack", **row})
        state, table, _ = manager.step_frame(state, table, cfg, opts, frame)
    torch.cuda.synchronize()
    launches = kernels.householder_qr_blocks.launches
    emit({"phase": "tsqr", "seconds": time.perf_counter() - t0,
          "frames": TSQR_FRAMES, "launches": launches})
    for row in checks:
        ok = (row["finite"] and row["qr_launches"] == 1
              and row["rows"] >= 4 * row["cols"] and row["n_slam"] > 0
              and row["info_HtH_excess"] <= 0
              and row["info_Htres_excess"] <= 0
              and row["update_p_gap"] <= 2e-4
              and row["update_cov_gap"] <= 2e-3)
        if not ok:
            raise AssertionError(f"TSQR check failed at frame {row['frame']}:"
                                 f" {row}")
    return launches


def phase_oppoint_path(run, calib):
    """The operating point's closed loop (phase_tsqr ran its first frames
    before, so the code path is warm)."""
    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig

    ref = convert.load_reference(OPPOINT_REF)
    meta = ref["meta"]
    row = _closed_loop("main_path_oppoint", FilterConfig(**meta["cfg"]), run,
                       calib, ref, meta["max_tracks"])
    if not row["n_slam_mean"] > 0:
        raise AssertionError("SLAM did not engage on the operating point")
    return row


def _kernel_numbers(row):
    """A kernel's numbers for the kernels line: `ms` and `library_ms` are
    device times (`device_ms`); the per-call times stand beside them."""
    return {"max_abs_err": row["max_abs_err"], "ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_device_ms"],
            "device_ms": row["device_ms"], "call_ms": row["call_ms"],
            "library_call_ms": row["library_call_ms"],
            "bound_share": row["bound_share"]}


def main():
    import torch

    import open_vins_tpu_torch  # noqa: F401  (the port, from this checkout)
    from open_vins_tpu_torch import convert

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    dd_rows = phase_downdate()
    qr_rows = phase_qr()
    run, calib, ref = convert.load_staged_run(FIXTURE, device="cuda")
    phase_msckf_path(run, calib, ref)
    tsqr_launches = phase_tsqr(run, calib, convert.load_reference(
        OPPOINT_REF))
    op_row = phase_oppoint_path(run, calib)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    dd = dd_rows[OPPOINT_SHAPE + (True,)]
    qr = qr_rows[("oppoint_stack", 544, 271)]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "symmetric_downdate", "route": "cuda",
        "source": "open_vins_tpu_torch/ops/csrc/symmetric_downdate.cu",
        "replaces": "open_vins_tpu/ops/pallas_kernels.py:32",
        "launches": op_row["launches"]["symmetric_downdate"],
        **_kernel_numbers(dd),
    }, {
        "name": "householder_qr_blocks", "route": "cuda",
        "source": "open_vins_tpu_torch/ops/csrc/householder_qr_blocks.cu",
        "replaces": "open_vins_tpu/ops/pallas_kernels.py:115",
        "launches": tsqr_launches,
        **_kernel_numbers(qr),
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
