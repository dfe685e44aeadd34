"""Tracked-feature debug images: a copy of
`open_vins_tpu/frontend/visualization.py` (TrackBase::display_active /
display_history parity, ov_core/src/track/TrackBase.cpp:30-150).

Host-side numpy/OpenCV: the device pipeline stays pure; the (ids, uv,
mask) packet may be tensors on any device, which are copied to the host
here, and the image a numpy array or a tensor.  Colors follow the
reference: active features as filled circles (blue→red by track age when
history is given), history trails as fading polylines.
"""

from __future__ import annotations

import numpy as np


def _host(a):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_u8_bgr(img):
    """float [H,W] in [0,1] (or uint8) -> BGR uint8 canvas."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img, img, img], axis=-1)
    return np.ascontiguousarray(img)


def draw_active(img, uv, mask, ids=None, radius=4):
    """Render currently tracked features onto the image.

    Args:
      img: [H, W] float or uint8 grayscale.
      uv: [P, 2] pixel positions; mask: [P] validity.
      ids: optional [P] — stable per-feature colors keyed by id.
    Returns a [H, W, 3] uint8 BGR debug image (display_active parity).
    """
    import cv2

    canvas = _to_u8_bgr(img)
    uv = _host(uv)
    mask = _host(mask).astype(bool)
    ids = _host(ids) if ids is not None else np.arange(len(uv))
    h, w = canvas.shape[:2]
    for k in np.where(mask)[0]:
        x, y = int(round(float(uv[k, 0]))), int(round(float(uv[k, 1])))
        if not (0 <= x < w and 0 <= y < h):
            continue
        rng = np.random.default_rng(int(ids[k]) % (2**31))
        color = tuple(int(c) for c in rng.integers(60, 255, size=3))
        cv2.circle(canvas, (x, y), radius, color, -1)
        cv2.circle(canvas, (x, y), radius + 1, (0, 0, 0), 1)
    return canvas


def draw_history(img, trails, max_len=15):
    """Render feature track history as fading trails.

    Args:
      trails: dict id -> [[u, v], ...] (oldest first) or list of arrays.
    Returns a BGR uint8 image (display_history parity)."""
    import cv2

    canvas = _to_u8_bgr(img)
    items = trails.items() if isinstance(trails, dict) else enumerate(trails)
    for fid, pts in items:
        pts = np.asarray(_host(pts), dtype=np.float64)
        if len(pts) < 2:
            continue
        pts = pts[-max_len:]
        rng = np.random.default_rng(int(fid) % (2**31))
        color = np.array([int(c) for c in rng.integers(60, 255, size=3)])
        n = len(pts)
        for i in range(n - 1):
            fade = 0.3 + 0.7 * (i + 1) / n
            c = tuple(int(v) for v in (color * fade))
            p0 = (int(round(pts[i, 0])), int(round(pts[i, 1])))
            p1 = (int(round(pts[i + 1, 0])), int(round(pts[i + 1, 1])))
            cv2.line(canvas, p0, p1, c, 1, cv2.LINE_AA)
        cv2.circle(canvas, (int(round(pts[-1, 0])), int(round(pts[-1, 1]))),
                   3, tuple(int(v) for v in color), -1)
    return canvas


class TrackVisualizer:
    """Stateful helper: feeds per-frame (ids, uv, mask), keeps trails, and
    writes display_active/display_history composites to a directory."""

    def __init__(self, out_dir, every=10, max_trail=15):
        import os

        self.out_dir = out_dir
        self.every = max(1, int(every))
        self.max_trail = max_trail
        self.trails = {}
        self.frame = 0
        os.makedirs(out_dir, exist_ok=True)

    def feed(self, img, ids, uv, mask):
        import os

        import cv2

        ids = _host(ids)
        uv = _host(uv)
        mask = _host(mask).astype(bool)
        live = set()
        for k in np.where(mask)[0]:
            fid = int(ids[k])
            if fid < 0:
                continue
            live.add(fid)
            self.trails.setdefault(fid, []).append(
                [float(uv[k, 0]), float(uv[k, 1])])
            self.trails[fid] = self.trails[fid][-self.max_trail:]
        for fid in [f for f in self.trails if f not in live]:
            del self.trails[fid]
        if self.frame % self.every == 0:
            canvas = draw_history(img, self.trails, self.max_trail)
            cv2.imwrite(os.path.join(self.out_dir,
                                     f"track_{self.frame:06d}.png"), canvas)
        self.frame += 1
