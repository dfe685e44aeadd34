"""ArUco tag tracking front-end.

Counterpart of `open_vins_tpu/frontend/aruco.py`.  Capability parity with ov_core::TrackAruco (TrackAruco.cpp:31-243): OpenCV
aruco detection producing 4 corner features per tag with deterministic ids
(feature id = 4*tag_id + corner, bounded by 4*max_tags — the reference's
"featid <= 4*max_aruco" contract), optional downsized detection, emitting
FrameInput-compatible fixed-shape packets.

Like the reference, detection runs on the host with OpenCV (tag decoding is
branch-heavy bit logic); the packet's arrays become tensors on the
caller's device, where they enter the port's tracker packets, and the
undistortion of corners uses the port's camera model for consistency with
the filter.
"""

from __future__ import annotations

import numpy as np
import torch

from open_vins_tpu_torch import resolve_device

try:
    import cv2

    _HAS_ARUCO = hasattr(cv2, "aruco")
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_ARUCO = False


def available() -> bool:
    return _HAS_ARUCO


class ArucoTracker:
    """Host-side tag detector with stable corner feature ids."""

    def __init__(self, max_tags=1024, dictionary="DICT_6X6_250",
                 downsize=False):
        if not _HAS_ARUCO:
            raise RuntimeError("OpenCV aruco module not available")
        self.max_tags = max_tags
        self.downsize = downsize
        d = getattr(cv2.aruco, dictionary)
        self._dict = cv2.aruco.getPredefinedDictionary(d)
        self._params = cv2.aruco.DetectorParameters()
        self._detector = cv2.aruco.ArucoDetector(self._dict, self._params)

    def detect(self, img_u8, num_slots, device=None):
        """Detect tags in a grayscale uint8 image (numpy, on the host).

        Returns (ids [num_slots] int32, uv [num_slots, 2] float32,
        mask [num_slots] bool) as tensors on `device` (None = CUDA) with
        feature id = 4*tag_id + corner_index (TrackAruco id contract).
        """
        dev = resolve_device(device)
        img = img_u8
        scale = 1.0
        if self.downsize:
            img = cv2.resize(img_u8, (img_u8.shape[1] // 2,
                                      img_u8.shape[0] // 2))
            scale = 2.0
        corners, tag_ids, _ = self._detector.detectMarkers(img)
        ids = np.full(num_slots, -1, np.int32)
        uv = np.zeros((num_slots, 2), np.float32)
        mask = np.zeros(num_slots, bool)
        k = 0
        if tag_ids is not None:
            for tag, quad in zip(tag_ids.reshape(-1), corners):
                if tag >= self.max_tags:
                    continue
                for c in range(4):
                    if k >= num_slots:
                        break
                    ids[k] = 4 * int(tag) + c
                    uv[k] = quad.reshape(4, 2)[c] * scale
                    mask[k] = True
                    k += 1
        return (torch.as_tensor(ids, device=dev),
                torch.as_tensor(uv, device=dev),
                torch.as_tensor(mask, device=dev))


def render_marker(tag_id, size_px=120, dictionary="DICT_6X6_250"):
    """Render a marker image (testing aid)."""
    d = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, dictionary))
    return cv2.aruco.generateImageMarker(d, tag_id, size_px)
