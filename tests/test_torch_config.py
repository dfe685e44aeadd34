"""The port's YAML config loader (`utils/config.py`) and
`manager.seed_imu_intrinsics` against the JAX package's.

Each case writes a three-file config tree (estimator_config.yaml and the two
kalibr files it names) to a temporary directory, as tests/test_config.py
does, and loads it with both packages.  The records must be equal field for
field: FilterConfig and TriangulationOptions by field, the camera arrays
exactly (both compute them in numpy), the tracker, init and output records
exactly; the IMU sensor-frame quaternions, which each package converts
with its own f32 `rot_2_quat`, to 1e-7.  A missing required key raises
KeyError in both, and an unknown key is warned about, once, in both.
`seed_imu_intrinsics` must give JAX's state leaves to 1e-7.
"""

import logging

import numpy as np
import pytest
import torch

from open_vins_tpu.utils import config as jconfig
from open_vins_tpu_torch.core.state import init_state as tinit_state
from open_vins_tpu_torch.models import manager as tman
from open_vins_tpu_torch.utils import config as tconfig

QUAT_TOL = 1e-7

IMU = (
    "imu0:\n"
    "  accelerometer_noise_density: 2.0000e-3\n"
    "  accelerometer_random_walk: 3.0000e-3\n"
    "  gyroscope_noise_density: 1.6968e-04\n"
    "  gyroscope_random_walk: 1.9393e-05\n"
    "  update_rate: 200.0\n")

EUROC_CAMS = (
    "%YAML:1.0\n"
    "cam0:\n"
    "  T_imu_cam:\n"
    "    - [0.0148655429818, -0.999880929698, 0.00414029679422, "
    "-0.0216401454975]\n"
    "    - [0.999557249008, 0.0149672133247, 0.025715529948, "
    "-0.064676986768]\n"
    "    - [-0.0257744366974, 0.00375618835797, 0.999660727178, "
    "0.00981073058949]\n"
    "    - [0.0, 0.0, 0.0, 1.0]\n"
    "  distortion_coeffs: [-0.28340811, 0.07395907, 0.00019359, "
    "1.76187114e-05]\n"
    "  distortion_model: radtan\n"
    "  intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
    "  resolution: [752, 480]\n"
    "cam1:\n"
    "  T_imu_cam:\n"
    "    - [0.0125552670891, -0.999755099723, 0.0182237714554, "
    "-0.0198435579556]\n"
    "    - [0.999598781151, 0.0130119051815, 0.0251588363115, "
    "0.0453689425024]\n"
    "    - [-0.0253898008918, 0.0179005838253, 0.999517347078, "
    "0.00786212447038]\n"
    "    - [0.0, 0.0, 0.0, 1.0]\n"
    "  distortion_coeffs: [-0.28368365, 0.07451284, -0.00010473, "
    "-3.55590700e-05]\n"
    "  distortion_model: radtan\n"
    "  intrinsics: [457.587, 456.134, 379.999, 255.238]\n"
    "  resolution: [752, 480]\n")

EQUI_CAM = (
    "cam0:\n"
    "  T_cam_imu:\n"
    "    - [-0.9995250378696743, 0.0293228325, -0.0109264107, 0.0474976877]\n"
    "    - [0.0075019185074052, -0.1217278346, -0.9925350515, -0.0475375]\n"
    "    - [-0.0304333617, -0.9921309815, 0.1214562064, -0.0467261]\n"
    "    - [0.0, 0.0, 0.0, 1.0]\n"
    "  distortion_coeffs: [0.0034823894, 0.0007150348, -0.0020532361, "
    "0.0002029367]\n"
    "  distortion_model: equidistant\n"
    "  intrinsics: [190.978, 190.973, 254.932, 256.897]\n"
    "  resolution: [512, 512]\n")

EUROC_EST = (
    "%YAML:1.0\n"
    "verbosity: \"INFO\"\n"
    "use_fej: true\n"
    "integration: \"rk4\"\n"
    "use_stereo: true\n"
    "max_cameras: 2\n"
    "calib_cam_extrinsics: true\n"
    "calib_cam_intrinsics: true\n"
    "calib_cam_timeoffset: true\n"
    "calib_imu_intrinsics: false\n"
    "calib_imu_g_sensitivity: false\n"
    "max_clones: 11\n"
    "max_slam: 50\n"
    "max_slam_in_update: 25\n"
    "max_msckf_in_update: 40\n"
    "dt_slam_delay: 1\n"
    "gravity_mag: 9.81\n"
    "feat_rep_msckf: \"GLOBAL_3D\"\n"
    "feat_rep_slam: \"ANCHORED_MSCKF_INVERSE_DEPTH\"\n"
    "feat_rep_aruco: \"ANCHORED_MSCKF_INVERSE_DEPTH\"\n"
    "try_zupt: true\n"
    "zupt_chi2_multipler: 0\n"
    "zupt_max_velocity: 0.1\n"
    "zupt_noise_multiplier: 10\n"
    "zupt_max_disparity: 0.5\n"
    "zupt_only_at_beginning: false\n"
    "init_window_time: 2.0\n"
    "init_imu_thresh: 1.5\n"
    "init_max_disparity: 10.0\n"
    "init_max_features: 50\n"
    "init_dyn_use: false\n"
    "init_dyn_mle_opt_calib: false\n"
    "init_dyn_mle_max_iter: 50\n"
    "init_dyn_mle_max_time: 0.05\n"
    "init_dyn_mle_max_threads: 6\n"
    "init_dyn_num_pose: 6\n"
    "init_dyn_min_deg: 10.0\n"
    "init_dyn_inflation_ori: 10\n"
    "init_dyn_inflation_vel: 100\n"
    "init_dyn_inflation_bg: 10\n"
    "init_dyn_inflation_ba: 100\n"
    "init_dyn_min_rec_cond: 1e-12\n"
    "init_dyn_bias_g: [0.0, 0.0, 0.0]\n"
    "init_dyn_bias_a: [0.0, 0.0, 0.0]\n"
    "record_timing_information: false\n"
    "record_timing_filepath: \"timing.txt\"\n"
    "save_total_state: false\n"
    "use_klt: true\n"
    "num_pts: 200\n"
    "fast_threshold: 20\n"
    "grid_x: 5\n"
    "grid_y: 5\n"
    "min_px_dist: 10\n"
    "knn_ratio: 0.70\n"
    "track_frequency: 21.0\n"
    "downsample_cameras: false\n"
    "num_opencv_threads: 4\n"
    "histogram_method: \"HISTOGRAM\"\n"
    "fi_max_dist: 150\n"
    "fi_max_baseline: 200\n"
    "fi_max_cond_number: 20000\n"
    "fi_triangulate_1d: false\n"
    "up_msckf_sigma_px: 1\n"
    "up_msckf_chi2_multipler: 1\n"
    "up_slam_sigma_px: 1\n"
    "up_slam_chi2_multipler: 1\n"
    "up_aruco_sigma_px: 1\n"
    "up_aruco_chi2_multipler: 1\n"
    "use_aruco: false\n"
    "num_aruco: 1024\n"
    "downsize_aruco: true\n"
    "use_mask: false\n"
    "relative_config_imu: \"kalibr_imu_chain.yaml\"\n"
    "relative_config_imucam: \"kalibr_imucam_chain.yaml\"\n")

MIN_EST = ("relative_config_imu: kalibr_imu_chain.yaml\n"
           "relative_config_imucam: kalibr_imucam_chain.yaml\n"
           "max_cameras: 1\nmax_clones: 11\nmax_slam: 25\n")

RPNG_IMU = (
    "  model: \"rpng\"\n"
    "  Tw:\n"
    "    - [ 1.02, 0.01, -0.003 ]\n"
    "    - [ 0.0, 0.98, 0.004 ]\n"
    "    - [ 0.0, 0.0, 1.01 ]\n"
    "  Ta:\n"
    "    - [ 0.99, 0.002, 0.0 ]\n"
    "    - [ 0.0, 1.03, -0.001 ]\n"
    "    - [ 0.0, 0.0, 0.97 ]\n"
    "  Tg:\n"
    "    - [ 0.001, 0.0, 0.0 ]\n"
    "    - [ 0.0, 0.002, 0.0 ]\n"
    "    - [ 0.0, 0.0, 0.003 ]\n"
    "  R_IMUtoACC:\n"
    "    - [ 1.0, 0.0, 0.0 ]\n"
    "    - [ 0.0, 0.0, -1.0 ]\n"
    "    - [ 0.0, 1.0, 0.0 ]\n")

KALIBR_IMU = (
    "  model: \"kalibr\"\n"
    "  Tw:\n"
    "    - [ 1.01, 0.0, 0.0 ]\n"
    "    - [ 0.02, 0.99, 0.0 ]\n"
    "    - [ -0.01, 0.003, 1.02 ]\n"
    "  Ta:\n"
    "    - [ 0.98, 0.0, 0.0 ]\n"
    "    - [ 0.001, 1.01, 0.0 ]\n"
    "    - [ 0.002, -0.004, 0.995 ]\n"
    "  R_IMUtoGYRO:\n"
    "    - [ 0.9998477, -0.0174524, 0.0 ]\n"
    "    - [ 0.0174524, 0.9998477, 0.0 ]\n"
    "    - [ 0.0, 0.0, 1.0 ]\n")

TREES = {
    "euroc_stereo": (EUROC_EST, IMU, EUROC_CAMS),
    "equidistant": (MIN_EST + "calib_cam_timeoffset: true\n"
                    "feat_rep_slam: ANCHORED_INVERSE_DEPTH_SINGLE\n"
                    "use_aruco: true\nnum_aruco: 64\nuse_mask: true\n"
                    "mask0: masks/cam0.png\nfi_max_runs: 7\n",
                    IMU, EQUI_CAM),
    "rpng_seeded": (MIN_EST, IMU + RPNG_IMU, EQUI_CAM),
    "kalibr_seeded": (MIN_EST + "integration: analytical\n",
                      IMU + KALIBR_IMU, EQUI_CAM),
}


def write_tree(tmp_path, est, imu, cams):
    (tmp_path / "kalibr_imu_chain.yaml").write_text(imu)
    (tmp_path / "kalibr_imucam_chain.yaml").write_text(cams)
    path = tmp_path / "estimator_config.yaml"
    path.write_text(est)
    return str(path)


def assert_same_config(got, want):
    assert got.filter._asdict() == want.filter._asdict()
    assert len(got.cams) == len(want.cams)
    for c_t, c_j in zip(got.cams, want.cams):
        assert c_t.model == c_j.model and c_t.resolution == c_j.resolution
        for k in ("intrinsics", "R_ItoC", "p_IinC"):
            a, b = getattr(c_t, k), getattr(c_j, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k, v in want.imu._asdict().items():
        if k in ("q_gyro", "q_acc"):
            np.testing.assert_allclose(getattr(got.imu, k), v, atol=QUAT_TOL,
                                       rtol=0, err_msg=k)
        else:
            assert getattr(got.imu, k) == v, k
    for k in ("calib_dt", "use_stereo", "downsample_cameras",
              "init_window_time", "init_imu_thresh", "try_zupt"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("tracker", "init", "output", "tri"):
        assert getattr(got, k)._asdict() == getattr(want, k)._asdict(), k


@pytest.mark.parametrize("tree", sorted(TREES))
def test_load_matches_jax(tmp_path, tree):
    path = write_tree(tmp_path, *TREES[tree])
    got = tconfig.load(path, warn_unknown=False)
    want = jconfig.load(path, warn_unknown=False)
    assert_same_config(got, want)
    assert type(got.filter).__module__.startswith("open_vins_tpu_torch")
    assert type(got.tri).__module__.startswith("open_vins_tpu_torch")


@pytest.mark.parametrize("tree", ["rpng_seeded", "kalibr_seeded"])
def test_seed_imu_intrinsics_matches_jax(tmp_path, tree):
    from open_vins_tpu.core.state import init_state as jinit_state
    from open_vins_tpu.models import manager as jman

    path = write_tree(tmp_path, *TREES[tree])
    tc = tconfig.load(path, warn_unknown=False)
    jc = jconfig.load(path, warn_unknown=False)
    got = tman.seed_imu_intrinsics(tinit_state(tc.filter, "cpu"), tc.imu)
    want = jman.seed_imu_intrinsics(jinit_state(jc.filter), jc.imu)
    for k in ("imu_dw", "imu_da", "imu_tg", "imu_q_gyro", "imu_q_acc"):
        v = getattr(got, k)
        assert v.dtype == torch.float32, k
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(want, k)),
                                   atol=QUAT_TOL, rtol=0, err_msg=k)
    # the seeded values are not identity
    assert not np.allclose(got.imu_dw.numpy(), [1, 0, 0, 1, 0, 1])


def test_missing_key_raises(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("max_clones: 5\n")
    for loader in (tconfig, jconfig):
        with pytest.raises(KeyError, match="relative_config_imu"):
            loader.load(str(p))
    path = write_tree(tmp_path, MIN_EST.replace("max_slam: 25\n", ""), IMU,
                      EQUI_CAM)
    for loader in (tconfig, jconfig):
        with pytest.raises(KeyError, match="max_slam"):
            loader.load(path)


def test_unknown_key_warns(tmp_path, caplog):
    path = write_tree(tmp_path, MIN_EST + "not_an_option: 3\n"
                      "max_slam_in_update: 20\n", IMU, EQUI_CAM)
    warned = {}
    for name, loader in (("port", tconfig), ("jax", jconfig)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            loader.load(path)
        warned[name] = [r.getMessage() for r in caplog.records
                        if r.levelno == logging.WARNING]
    assert len(warned["port"]) == 1 and "not_an_option" in warned["port"][0]
    assert warned["port"] == warned["jax"]
    assert set(tconfig._OUT_OF_SCOPE) == set(jconfig._OUT_OF_SCOPE)
