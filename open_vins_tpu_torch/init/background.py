"""Background initialization with the camera catch-up replay.

Counterpart of `open_vins_tpu/init/background.py`
(VioManager::try_to_initialize, VioManagerHelper.cpp:78-188): the attempt
runs on a worker thread so that the camera stream is never blocked; the
camera times that arrive while it runs are queued, and once an attempt
succeeds `catch_up` moves the state over them by propagate-and-clone
(clone_rate-spaced, VioManagerHelper.cpp:156-163) before filtering goes on.
The worker launches its device work on the default stream, as the main
thread does.
"""

from __future__ import annotations

import threading
import time

import torch

from open_vins_tpu_torch.models import manager
from open_vins_tpu_torch.models.propagator import ImuWindow


class BackgroundInitializer:
    """Initialization attempts on a detached thread.

    Per camera frame before init: ``done = bg.try_to_initialize(t_cam,
    attempt_fn)``, with attempt_fn() -> (kind, res) a closure over a
    snapshot of the IMU and track history (e.g. `router.try_initialize`).
    True once an attempt has succeeded; while one is in flight the frame
    time is queued for the catch-up.

    Unlike the reference's worker, which turns any exception of an attempt
    into "none", an exception raised by an attempt is kept in `error` and
    re-raised on the caller's thread by the next `try_to_initialize` or
    `join`: a failed kernel build or a CUDA fault must not look like "not
    initialized yet".  An attempt that returns "none" stays "none"."""

    def __init__(self):
        self._lock = threading.Lock()
        self._running = False
        self._queue = []  # camera times seen while an attempt runs
        self.result = None  # (kind, res, t_attempt)
        self.error = None  # the exception of the last attempt, if any

    def _raise_error(self):
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def try_to_initialize(self, t_cam: float, attempt_fn) -> bool:
        with self._lock:
            self._raise_error()
            if self._running:
                self._queue.append(float(t_cam))
                return False
            if self.result is not None:
                return True
            if attempt_fn is None:  # probe only: nothing to launch
                return False
            self._running = True

        def worker():
            kind, res, err = "none", None, None
            try:
                kind, res = attempt_fn()
            except Exception as e:  # handed to the caller's thread
                err = e
            with self._lock:
                if err is not None:
                    self.error = err
                    self._queue.clear()
                elif kind != "none":
                    self.result = (kind, res, float(t_cam))
                else:
                    self._queue.clear()
                self._running = False

        threading.Thread(target=worker, daemon=True).start()
        return False

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._running

    def join(self, timeout=None):
        """Block until no attempt is in flight (the single-threaded replay
        mode, the reference's use_multi_threading_subs=false), then re-raise
        the attempt's exception, if it raised one."""
        t0 = time.time()
        while True:
            with self._lock:
                if not self._running:
                    self._raise_error()
                    return
            if timeout is not None and time.time() - t0 > timeout:
                return
            time.sleep(0.002)

    def queued_times(self, t_init: float):
        """The queued camera times after t_init (the queue is emptied)."""
        with self._lock:
            ts = [t for t in self._queue if t > t_init]
            self._queue.clear()
        return ts


def catch_up(state, cfg, queued_ts, make_window, imu_rate: float):
    """Move the initialized state over the queued camera times by
    `manager.propagate_and_clone`, clone_rate-spaced
    (VioManagerHelper.cpp:156-163): with many frames queued only every
    (len / max_clones + 1)-th is cloned, so the window is not filled with
    stale clones.  `make_window(t0, t1, K) -> (n, t[K], w[K, 3], a[K, 3])`
    is the SensorHub packer (padded rows are dt = 0 no-ops); each window is
    sized from its own span.  Runs on the state's device."""
    if not queued_ts:
        return state
    dev = state.cov.device
    clone_rate = len(queued_ts) // max(cfg.max_clones, 1) + 1
    t_prev = float(state.t)
    for t in queued_ts[::clone_rate]:
        if t <= t_prev:
            continue
        K = int((t - t_prev) * imu_rate) + 8
        n, wt, ww, wa = make_window(t_prev, t, K)
        if n <= 0:
            continue
        win = ImuWindow(*(torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in (wt, ww, wa)))
        state = manager.propagate_and_clone(state, cfg, win, t)
        t_prev = t
    return state
