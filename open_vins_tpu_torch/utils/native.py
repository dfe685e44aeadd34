"""ctypes bindings for the native host runtime (libovt_native.so).

Counterpart of `open_vins_tpu/utils/native.py`: the C++ sensor hub (IMU
ring buffer + window packing, the ROS-shell + select_imu_readings role) and
the EuRoC ASL dataset loader, built from the repository's own
`native/sensor_hub.cpp` and `native/euroc_loader.cpp` into the port's own
build directory, `build/torch_native/` under the checkout (the JAX
package builds into `native/build/`).  The library links OpenCV's C++
core, imgcodecs and imgproc, so it builds only where those are installed;
`available()` gates usage, and `propagator.make_window` remains the
pure-Python path.  The arrays it hands out are numpy arrays on the host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BUILD = os.path.join(_REPO, "build", "torch_native")
_SO = os.path.join(_BUILD, "libovt_native.so")


def build(force=False):
    """Build the native library with cmake+ninja (one-time)."""
    if os.path.exists(_SO) and not force:
        return _SO
    src = os.path.join(_REPO, "native")
    subprocess.run(["cmake", "-S", src, "-B", _BUILD, "-G", "Ninja"],
                   check=True, capture_output=True)
    subprocess.run(["cmake", "--build", _BUILD], check=True,
                   capture_output=True)
    return _SO


def _lib():
    global _LIB
    if _LIB is None:
        if not os.path.exists(_SO):
            raise FileNotFoundError(
                f"{_SO} not built — run open_vins_tpu_torch.utils.native.build()"
            )
        lib = ctypes.CDLL(_SO)
        lib.hub_create.restype = ctypes.c_void_p
        lib.hub_destroy.argtypes = [ctypes.c_void_p]
        lib.hub_feed_imu.argtypes = [
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        lib.hub_imu_count.argtypes = [ctypes.c_void_p]
        lib.hub_imu_count.restype = ctypes.c_int
        lib.hub_newest_imu_time.argtypes = [ctypes.c_void_p]
        lib.hub_newest_imu_time.restype = ctypes.c_double
        lib.hub_make_window.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.hub_make_window.restype = ctypes.c_int
        lib.hub_prune.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.euroc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.euroc_open.restype = ctypes.c_void_p
        lib.euroc_close.argtypes = [ctypes.c_void_p]
        lib.euroc_imu_count.argtypes = [ctypes.c_void_p]
        lib.euroc_imu_count.restype = ctypes.c_int
        lib.euroc_imu_data.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_double)] * 3
        lib.euroc_cam_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.euroc_cam_count.restype = ctypes.c_int
        lib.euroc_cam_times.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.euroc_load_image.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.euroc_load_image.restype = ctypes.c_int
        lib.euroc_prefetch_start.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.euroc_prefetch_start.restype = ctypes.c_int
        lib.euroc_prefetch_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.euroc_prefetch_get.restype = ctypes.c_int
        lib.euroc_prefetch_stop.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available():
    return os.path.exists(_SO)


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class SensorHub:
    """Native IMU buffer + window packer (ROS1Visualizer + select_imu_readings
    parity)."""

    def __init__(self):
        self._h = _lib().hub_create()

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().hub_destroy(self._h)
            self._h = None

    def feed_imu(self, t, w, a):
        w = np.ascontiguousarray(w, dtype=np.float64)
        a = np.ascontiguousarray(a, dtype=np.float64)
        _lib().hub_feed_imu(self._h, float(t), _dp(w), _dp(a))

    def imu_count(self):
        return _lib().hub_imu_count(self._h)

    def newest_time(self):
        return _lib().hub_newest_imu_time(self._h)

    def make_window(self, t0, t1, K):
        """Returns (n_real, t [K], w [K,3], a [K,3]) or (0, None...)"""
        t = np.zeros(K, dtype=np.float64)
        w = np.zeros((K, 3), dtype=np.float64)
        a = np.zeros((K, 3), dtype=np.float64)
        n = _lib().hub_make_window(
            self._h, float(t0), float(t1), K, _dp(t), _dp(w), _dp(a))
        if n <= 0:
            return n, None, None, None
        return n, t, w, a

    def prune(self, t):
        _lib().hub_prune(self._h, float(t))


class EurocDataset:
    """Native EuRoC ASL reader (rosbag/DatasetReader ingestion parity)."""

    def __init__(self, root, num_cams=2, max_h=1024, max_w=1536):
        self._h = _lib().euroc_open(root.encode(), num_cams)
        if not self._h:
            raise FileNotFoundError(f"not an EuRoC dataset: {root}")
        self.max_h, self.max_w = max_h, max_w

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().euroc_close(self._h)
            self._h = None

    def imu(self):
        n = _lib().euroc_imu_count(self._h)
        t = np.zeros(n, dtype=np.float64)
        w = np.zeros((n, 3), dtype=np.float64)
        a = np.zeros((n, 3), dtype=np.float64)
        _lib().euroc_imu_data(self._h, _dp(t), _dp(w), _dp(a))
        return t, w, a

    def cam_times(self, cam):
        n = _lib().euroc_cam_count(self._h, cam)
        t = np.zeros(n, dtype=np.float64)
        _lib().euroc_cam_times(self._h, cam, _dp(t))
        return t

    def load_image(self, cam, idx):
        return self._fetch(_lib().euroc_load_image, cam, idx)

    def _fetch(self, fn, cam, idx):
        buf = np.zeros((self.max_h, self.max_w), dtype=np.float32)
        oh = ctypes.c_int()
        ow = ctypes.c_int()
        ok = fn(self._h, cam, idx,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.max_h, self.max_w, ctypes.byref(oh), ctypes.byref(ow))
        if not ok:
            return None
        return buf[: oh.value, : ow.value].copy()

    def prefetch_start(self, num_cams=1, start=0, depth=4):
        """Spawn the native decode-ahead worker (frames [start, end) in
        order, `depth` slots ahead).  The threaded-ingestion analog of the
        reference's multi-threaded camera subscription
        (ROS1Visualizer.cpp:451-487)."""
        return bool(_lib().euroc_prefetch_start(self._h, num_cams, start,
                                                depth))

    def prefetch_get(self, cam, idx):
        """Blocking fetch of a prefetched frame; in-order consumption,
        cameras of one index fetched 0..N-1 (the last fetch releases the
        slot).  Falls back to a synchronous decode on re-reads or when the
        prefetcher is not running."""
        return self._fetch(_lib().euroc_prefetch_get, cam, idx)

    def prefetch_stop(self):
        _lib().euroc_prefetch_stop(self._h)
