"""The port's host-side helpers against the JAX package's: the native
sensor hub and EuRoC loader (`utils/native.py`, ctypes over the repo's
`native/*.cpp`, built into the port's own `build/torch_native/`), the aruco
tag detector (`frontend/aruco.py`) and the debug images
(`frontend/visualization.py`).

The inputs are those of tests/test_native.py (the synthetic ASL tree) and
tests/test_aruco.py (`render_marker` scenes).  The native library links
OpenCV's C++ libraries and the helpers import
`cv2`: each group skips where its library is absent, as the JAX package's
tests do (tests/test_native.py, tests/test_aruco.py).  Windows, IMU
arrays and decoded images must be equal to the JAX wrapper's on the same
inputs; the sensor hub's window also matches the port's pure-Python
`propagator.make_window` (1e-9 s on times, 1e-6 on samples, as
tests/test_native.py holds JAX's).  Detections on `render_marker` scenes
must carry JAX's ids, masks and corners exactly, and the drawn images must
be equal byte for byte.
"""

import numpy as np
import pytest
import torch

from open_vins_tpu.frontend import aruco as jaruco
from open_vins_tpu_torch.frontend import aruco as taruco
from open_vins_tpu_torch.utils import native as tnative
from test_aruco import scene_with_markers
from test_native import TestEurocLoader


@pytest.fixture(scope="module")
def jnative():
    """Both packages' native libraries, built here if need be (in the one
    worker that runs this file, not at collection); the JAX package's
    wrapper is returned.  Skips where the library cannot be built."""
    from open_vins_tpu.utils import native as jnative

    for mod in (tnative, jnative):
        if not mod.available():
            try:
                mod.build()
            except Exception:
                pass
    if not (tnative.available() and jnative.available()):
        pytest.skip("native library not built")
    return jnative


needs_aruco = pytest.mark.skipif(not taruco.available(),
                                 reason="cv2.aruco not available")


def _imu_stream(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, 2.0, 0.005)
    return t, rng.normal(size=(len(t), 3)), rng.normal(size=(len(t), 3))


def test_library_builds_into_port_directory(jnative):
    assert tnative._SO.endswith("build/torch_native/libovt_native.so")
    assert "native/build" not in tnative._SO


@pytest.mark.parametrize("window", [(0.5012, 0.5523, 16), (1.2, 1.31, 32),
                                    (0.05, 0.5, 96)])
def test_sensor_hub_matches_jax_and_make_window(jnative, window):
    from open_vins_tpu_torch.models.propagator import make_window

    t, w, a = _imu_stream()
    hubs = (tnative.SensorHub(), jnative.SensorHub())
    for hub in hubs:
        for i in range(len(t)):
            hub.feed_imu(t[i], w[i], a[i])
    t0, t1, K = window
    got, want = (hub.make_window(t0, t1, K) for hub in hubs)
    assert got[0] == want[0] and got[0] > 2
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x, y)
    ref = make_window(t, w, a, t0, t1, K, device="cpu")
    np.testing.assert_allclose(got[1], ref.t.numpy(), atol=1e-9)
    np.testing.assert_allclose(got[2], ref.w.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[3], ref.a.numpy(), atol=1e-6)
    for hub in hubs:
        hub.prune(1.0)
    assert hubs[0].imu_count() == hubs[1].imu_count() < len(t)


def test_euroc_dataset_matches_jax(jnative, tmp_path):
    TestEurocLoader()._make_tree(str(tmp_path))
    got = tnative.EurocDataset(str(tmp_path), num_cams=1)
    want = jnative.EurocDataset(str(tmp_path), num_cams=1)
    for x, y in zip(got.imu(), want.imu()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got.cam_times(0), want.cam_times(0))
    for i in range(3):
        np.testing.assert_array_equal(got.load_image(0, i),
                                      want.load_image(0, i))
    assert got.prefetch_start(num_cams=1, start=0, depth=2)
    for i in range(3):
        np.testing.assert_array_equal(got.prefetch_get(0, i),
                                      want.load_image(0, i))
    got.prefetch_stop()
    with pytest.raises(FileNotFoundError):
        tnative.EurocDataset(str(tmp_path / "missing"))


@needs_aruco
@pytest.mark.parametrize("scene", ["two_tags", "shifted", "downsized",
                                   "empty", "over_max_tags"])
def test_aruco_detections_match_jax(scene):
    kw, img, slots = {}, scene_with_markers(), 64
    if scene == "shifted":
        img = np.roll(scene_with_markers(tags=(3,)), 15, axis=1)
    elif scene == "downsized":
        kw = dict(downsize=True)
        img = scene_with_markers(size=160)
    elif scene == "empty":
        img = np.full((240, 320), 128, np.uint8)
    elif scene == "over_max_tags":
        kw, slots = dict(max_tags=10), 6
    ids, uv, mask = taruco.ArucoTracker(**kw).detect(img, slots,
                                                     device="cpu")
    ids_j, uv_j, mask_j = jaruco.ArucoTracker(**kw).detect(img, slots)
    assert ids.dtype == torch.int32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(mask.numpy(), mask_j)
    np.testing.assert_array_equal(uv.numpy(), uv_j)
    if scene == "two_tags":
        assert set((ids[mask] // 4).tolist()) == {7, 23}
    if scene == "over_max_tags":
        assert set((ids[mask] // 4).tolist()) <= {7}


@needs_aruco
def test_visualization_matches_jax(tmp_path):
    from open_vins_tpu.frontend import visualization as jvis
    from open_vins_tpu_torch.frontend import visualization as tvis

    rng = np.random.default_rng(4)
    img = rng.random((120, 160)).astype(np.float32)
    uv = rng.uniform(-5, 165, size=(30, 2)).astype(np.float32)
    mask = rng.random(30) < 0.8
    ids = rng.integers(0, 1000, 30).astype(np.int32)
    got = tvis.draw_active(torch.as_tensor(img), torch.as_tensor(uv),
                           torch.as_tensor(mask), torch.as_tensor(ids))
    np.testing.assert_array_equal(got, jvis.draw_active(img, uv, mask, ids))
    trails = {int(i): rng.uniform(0, 150, size=(n, 2))
              for i, n in zip(ids[:6], (1, 2, 5, 9, 20, 3))}
    np.testing.assert_array_equal(tvis.draw_history(img, trails),
                                  jvis.draw_history(img, trails))
    viz_t = tvis.TrackVisualizer(str(tmp_path / "port"), every=2)
    viz_j = jvis.TrackVisualizer(str(tmp_path / "jax"), every=2)
    for k in range(5):
        step = (uv + k).astype(np.float32)
        viz_t.feed(torch.as_tensor(img), torch.as_tensor(ids),
                   torch.as_tensor(step), torch.as_tensor(mask))
        viz_j.feed(img, ids, step, mask)
    assert viz_t.trails == viz_j.trails
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["track_000000.png", "track_000002.png",
                     "track_000004.png"]
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes())
