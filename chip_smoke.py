"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the exit code
is not 0):

1. environment: torch / CUDA versions and the card's
   `nvidia-smi --query-gpu=name,power.limit` line;
2. build: every CUDA kernel of the port, from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape and the reference's oracle shapes, with CUDA-event timings of
   the kernel, the plain version and the nearest single PyTorch call;
4. the main path: the MSCKF-only closed loop (11 clones, 200 points, <= 40
   MSCKF features per update, 20 Hz camera / 200 Hz IMU, rk4) over the 399
   staged frames of `open_vins_tpu_torch/data/msckf_sim20_seed0.npz`, with
   the launch counts set to 0 just before the timed pass and read after it.
   It must pass the health gate (finite covariance, RMSE < 0.05 m,
   0.2 < NEES < 30) and land within 0.01 m RMSE of the JAX run on the same
   frames.

The line before the last lists every kernel's numbers; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "open_vins_tpu_torch", "data",
                       "msckf_sim20_seed0.npz")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 non-tensor
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

DOWNDATE_SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81),
                   (270, 231), (1434, 231)]
MAIN_SHAPE = (120, 81)  # D and support width of the MSCKF-only main path
RMSE_GATE_M = 0.05
REF_RMSE_SPREAD_M = 0.01


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, n_runs=200, n_warm=20):
    """Median of per-call CUDA-event times of `fn` (ms)."""
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


def downdate_bound_ms(D, m, same):
    """Least time on the card: inputs read once (K = PHt counts once),
    output written once, 2·D²·m f32 operations."""
    n_bytes = 4 * (D * D + (1 if same else 2) * D * m + D * D)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * D * D * m / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels():
    """symmetric_downdate against its plain version at every shape."""
    import torch

    from open_vins_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for D, m in DOWNDATE_SHAPES:
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
            row["ms"] = cuda_time_ms(
                lambda: kernels.symmetric_downdate(P, K, PHt))
            row["plain_ms"] = cuda_time_ms(
                lambda: kernels.symmetric_downdate_ref(P, K, PHt))
            row["library_ms"] = cuda_time_ms(
                lambda: torch.addmm(P, K, PHt.mT, alpha=-1))
            row["bound_ms"], row["bound_by"] = downdate_bound_ms(D, m, same)
            emit(row)
            rows[(D, m, same)] = row
    return rows


def phase_main_path():
    """The MSCKF-only closed loop on the card, through the user's entry
    points (convert.load_staged_run → runner.run_filter)."""
    import torch

    from open_vins_tpu_torch import convert
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import runner
    from open_vins_tpu_torch.models import triangulation as tri
    from open_vins_tpu_torch.ops import kernels

    run, calib, ref = convert.load_staged_run(FIXTURE, device="cuda")
    meta = ref["meta"]
    cfg = FilterConfig(**meta["cfg"])
    tri_opts = tri.TriangulationOptions()
    n_frames = run.frames.t_new.shape[0]

    def drive():
        state, outs = runner.run_filter(cfg, tri_opts, calib, run,
                                        max_tracks=meta["max_tracks"],
                                        device="cuda")
        torch.cuda.synchronize()
        return state, outs

    drive()  # warm-up pass (cuBLAS / cuSOLVER handles, allocator)
    kernels.symmetric_downdate.launches = 0
    t0 = time.perf_counter()
    state, outs = drive()
    seconds = time.perf_counter() - t0
    launches = kernels.symmetric_downdate.launches

    qs, ps, _, covs6, diag = outs
    rmse, nees = runner.pose_metrics(qs, ps, covs6, run.gt_q, run.gt_p)
    finite = bool(torch.isfinite(state.cov).all().item())
    gap = float((ps.cpu() - torch.as_tensor(ref["ref_p"])).norm(dim=1).max())
    row = {"phase": "main_path", "frames": n_frames,
           "frames_per_s": n_frames / seconds, "seconds": seconds,
           "rmse_m": rmse, "nees": nees, "finite": finite,
           "jax_rmse_m": ref["ref_rmse"], "jax_nees": ref["ref_nees"],
           "max_position_gap_to_jax_m": gap,
           "n_msckf_mean": float(diag.n_msckf.float().mean()),
           "launches": {"symmetric_downdate": launches}}
    emit(row)
    healthy = finite and rmse < RMSE_GATE_M and 0.2 < nees < 30.0
    if not healthy:
        raise AssertionError(f"health gate failed: {row}")
    if abs(rmse - ref["ref_rmse"]) > REF_RMSE_SPREAD_M:
        raise AssertionError(f"RMSE {rmse} is more than {REF_RMSE_SPREAD_M} m"
                             f" from the JAX run's {ref['ref_rmse']}")
    if launches < n_frames:
        raise AssertionError(f"symmetric_downdate launched {launches} times "
                             f"over {n_frames} frames")
    return launches


def main():
    import torch

    import open_vins_tpu_torch  # noqa: F401  (the port, from this checkout)

    smi = phase_environment()
    phase_build()
    kernel_rows = phase_kernels()
    launches = phase_main_path()
    main_row = kernel_rows[MAIN_SHAPE + (True,)]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "symmetric_downdate", "route": "cuda",
        "source": "open_vins_tpu_torch/ops/csrc/symmetric_downdate.cu",
        "replaces": "open_vins_tpu/ops/pallas_kernels.py:32",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
