"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `ops/csrc/<name>.cu` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>_<hash>.so <name>.cu

The library lands in `build/torch_kernels/` under the checkout (git-ignored)
at first use, named by a hash of its source and flags, so an edited source
rebuilds.  `build_all()` starts one nvcc per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C signatures of the kernels' entry points: (symbol, argtypes)
_SIGNATURES = {
    "symmetric_downdate": (
        "symmetric_downdate_f32",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    ),
    "householder_qr_blocks": (
        "householder_qr_blocks_f32",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    ),
    "imu_rk4_window": (
        "imu_rk4_window_f32",
        [ctypes.c_void_p, ctypes.c_longlong] * 5
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
        + [ctypes.c_void_p],
    ),
    "msckf_linearize": (
        "msckf_linearize_f32",
        [ctypes.c_void_p, ctypes.c_longlong] * 13 + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 21 + [ctypes.c_float, ctypes.c_void_p],
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the CUDA home that
    PyTorch's own extension builder finds."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (Popen or None, tmp path, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def build_all(names=None) -> dict[str, Path]:
    """Build every kernel (or `names`), one nvcc per source in parallel."""
    names = list(_SIGNATURES) if names is None else list(names)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
