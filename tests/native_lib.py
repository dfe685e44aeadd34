"""The JAX package's native library (`open_vins_tpu.utils.native`), built
once for every test process that needs it.

Several pytest-xdist workers collect the files that use the library at the
same time.  `ensure_built` lets one of them build it under an exclusive
file lock while the others wait, then load; so each file decides whether
to skip only after the build has finished, and every worker decides alike.
A library left incomplete by an earlier build (one that lacks a symbol the
wrapper binds, such as `euroc_open`) is built again from a clean build
directory.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import sys

from open_vins_tpu.utils import native

# symbols of both sources of the library (sensor_hub.cpp, euroc_loader.cpp)
EXPECTED = ("hub_create", "euroc_open", "euroc_prefetch_get")
_BUILD_DIR = os.path.dirname(native._SO)
_LOCK = os.path.join(os.path.dirname(_BUILD_DIR), "build.lock")


def complete(path: str = native._SO) -> bool:
    """Whether the library at `path` loads and exports every expected
    symbol, asked of a child process (loading it here would pin this copy
    of the file in the process)."""
    if not os.path.exists(path):
        return False
    probe = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
             "[getattr(lib, s) for s in sys.argv[2:]]")
    return subprocess.run([sys.executable, "-c", probe, path, *EXPECTED],
                          capture_output=True).returncode == 0


def ensure_built() -> bool:
    """Build the library unless a complete one is there, one process at a
    time; True when a complete library is there afterwards."""
    with open(_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not complete():
                shutil.rmtree(_BUILD_DIR, ignore_errors=True)
                try:
                    native.build(force=True)
                except Exception:
                    pass
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return native.available() and complete()
