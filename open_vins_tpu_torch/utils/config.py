"""Config system: loads the reference's three-file YAML layout.

Counterpart of `open_vins_tpu/utils/config.py`, the same records and the
same key handling; its `filter` is the port's `core/layout.FilterConfig`
and its `tri` the port's `models/triangulation.TriangulationOptions`, and
the IMU sensor rotations become quaternions through the port's `ops/lie`.

Capability parity with ov_core::YamlParser + VioManagerOptions
(utils/opencv_yaml_parse.h:58-280, core/VioManagerOptions.h): an
`estimator_config.yaml` plus `kalibr_imu_chain.yaml` and
`kalibr_imucam_chain.yaml` (referenced by relative path) are parsed into the
typed configs — FilterConfig, tracker/init/output options, and
calibration arrays.  Existing OpenVINS config directories (e.g.
config/euroc_mav) load unmodified.

Honesty contract: every key the reference's VioManagerOptions consumes is
either mapped into a typed field here or explicitly listed as
out-of-scope-with-reason; keys present in the file but recognized by
neither list produce a warning (the reference prints unused-parameter
warnings through its YamlParser, opencv_yaml_parse.h:260-280).

Strict-mode parity: `load()` raises KeyError on missing required keys
(the reference aborts startup via `successful()`).
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import numpy as np
import torch
import yaml

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.models.triangulation import TriangulationOptions
from open_vins_tpu_torch.ops import lie

logger = logging.getLogger("open_vins_tpu_torch.config")


def _load_yaml(path):
    with open(path) as f:
        text = f.read()
    # OpenCV-YAML files start with "%YAML:1.0" which pyyaml rejects
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    return yaml.safe_load("\n".join(lines))


class CameraCalib(NamedTuple):
    model: str  # "radtan" | "equi"
    intrinsics: np.ndarray  # [8] = fx fy cx cy d0..d3
    R_ItoC: np.ndarray  # [3,3]
    p_IinC: np.ndarray  # [3]
    resolution: tuple  # (w, h)


class ImuCalib(NamedTuple):
    """IMU noise densities + intrinsic initial values.

    The intrinsic fields mirror VioManagerOptions' yaml-seeded state values
    (VioManagerOptions.h:306-353): Dw/Da are the INVERSES of the yaml's
    Tw/Ta, packed per-model (kalibr: lower-triangular column stack; rpng:
    upper-triangular column stack — State::Dm, State.h:91-102), tg is the
    column-major gravity-sensitivity stack, and the quaternions are
    R_GYROtoIMU / R_ACCtoIMU (transposes of the yaml's R_IMUtoGYRO /
    R_IMUtoACC)."""

    sigma_w: float
    sigma_wb: float
    sigma_a: float
    sigma_ab: float
    rate: float
    model: str = "kalibr"  # "kalibr" | "rpng"
    dw: tuple = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)
    da: tuple = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)
    tg: tuple = (0.0,) * 9
    q_gyro: tuple = (0.0, 0.0, 0.0, 1.0)  # JPL [x,y,z,w]
    q_acc: tuple = (0.0, 0.0, 0.0, 1.0)


class TrackerConfig(NamedTuple):
    """Front-end options (VioManagerOptions tracker block)."""

    use_klt: bool = True
    num_pts: int = 200
    fast_threshold: int = 20
    grid_x: int = 5
    grid_y: int = 5
    min_px_dist: int = 10
    knn_ratio: float = 0.70
    track_frequency: float = 21.0
    downsample_cameras: bool = False
    histogram_method: str = "HISTOGRAM"  # NONE | HISTOGRAM | CLAHE
    use_mask: bool = False
    mask_paths: tuple = ()  # absolute per-camera mask image paths
    # (VioManagerOptions.h:281-299: mask<i> keys, resolved against the
    # config folder; pixels >127 are masked OUT)
    use_aruco: bool = False
    num_aruco: int = 1024
    downsize_aruco: bool = True


class InitConfig(NamedTuple):
    """ov_init options (InertialInitializerOptions parity)."""

    window_time: float = 2.0
    imu_thresh: float = 1.5
    max_disparity: float = 10.0
    max_features: int = 50
    dyn_use: bool = False
    dyn_mle_opt_calib: bool = False
    dyn_mle_max_iter: int = 50
    dyn_num_pose: int = 6
    dyn_min_deg: float = 10.0
    dyn_inflation_ori: float = 10.0
    dyn_inflation_vel: float = 100.0
    dyn_inflation_bg: float = 10.0
    dyn_inflation_ba: float = 100.0
    dyn_min_rec_cond: float = 1e-12
    dyn_bias_g: tuple = (0.0, 0.0, 0.0)
    dyn_bias_a: tuple = (0.0, 0.0, 0.0)


class OutputConfig(NamedTuple):
    """Timing / state recording options."""

    record_timing_information: bool = False
    record_timing_filepath: str = "/tmp/traj_timing.txt"
    save_total_state: bool = False
    filepath_est: str = "/tmp/ov_estimate.txt"
    filepath_std: str = "/tmp/ov_estimate_std.txt"
    filepath_gt: str = "/tmp/ov_groundtruth.txt"


class VioConfig(NamedTuple):
    filter: FilterConfig
    cams: list  # list[CameraCalib]
    imu: ImuCalib
    calib_dt: float
    use_stereo: bool
    downsample_cameras: bool
    init_window_time: float
    init_imu_thresh: float
    try_zupt: bool
    tracker: TrackerConfig = TrackerConfig()
    init: InitConfig = InitConfig()
    output: OutputConfig = OutputConfig()
    tri: TriangulationOptions = TriangulationOptions()


# Keys VioManagerOptions consumes that this build deliberately does not map
# into behavior, with the reason (kept out of the unknown-key warning).
_OUT_OF_SCOPE = {
    "verbosity": "python logging controls verbosity",
    "num_opencv_threads": "host threading is the native hub's concern",
    "init_dyn_mle_max_time": "the MLE runs fixed iterations, not wall-time",
    "init_dyn_mle_max_threads": "device-parallel MLE, no host threads",
    # The reference caps SLAM features per sequential update to bound the
    # O(m^3) chunk cost (UpdaterSLAM.cpp delayed/update batching).  This
    # build applies ALL active landmarks in ONE stacked update whose cost
    # is bounded by the static (max_slam, max_clones) layout — a cap would
    # only mask measurements, so the key is deliberately not consumed.
    "max_slam_in_update": "stacked SLAM update makes the cap unnecessary",
}


def load(config_path: str, warn_unknown: bool = True) -> VioConfig:
    """Load an estimator_config.yaml (reference layout) into typed configs."""
    base = os.path.dirname(os.path.abspath(config_path))
    est_raw = _load_yaml(config_path)
    consumed = set()

    def get(key, default=None):
        consumed.add(key)
        return est_raw.get(key, default)

    def req(key):
        consumed.add(key)
        if key not in est_raw:
            raise KeyError(f"missing required config key: {key}")
        return est_raw[key]

    imu_file = os.path.join(base, req("relative_config_imu"))
    cam_file = os.path.join(base, req("relative_config_imucam"))
    imu_y = _load_yaml(imu_file)["imu0"]
    cam_y = _load_yaml(cam_file)

    num_cams = int(req("max_cameras"))
    cams = []
    for i in range(num_cams):
        c = cam_y[f"cam{i}"]
        # kalibr chains carry either T_imu_cam (R_CtoI, p_CinI — EuRoC style)
        # or T_cam_imu (R_ItoC, p_IinC — TUM-VI style)
        if "T_imu_cam" in c:
            T_CtoI = np.asarray(c["T_imu_cam"], dtype=np.float64)
            R_ItoC = T_CtoI[:3, :3].T
            p_IinC = -R_ItoC @ T_CtoI[:3, 3]
        else:
            T_ItoC = np.asarray(c["T_cam_imu"], dtype=np.float64)
            R_ItoC = T_ItoC[:3, :3]
            p_IinC = T_ItoC[:3, 3]
        intr4 = np.asarray(c["intrinsics"], dtype=np.float64)
        dist = np.asarray(c["distortion_coeffs"], dtype=np.float64)
        model = "equi" if c.get("distortion_model") == "equidistant" else "radtan"
        cams.append(CameraCalib(
            model=model,
            intrinsics=np.concatenate([intr4, dist]).astype(np.float32),
            R_ItoC=R_ItoC.astype(np.float32),
            p_IinC=p_IinC.astype(np.float32),
            resolution=tuple(c["resolution"]),
        ))

    # IMU model + intrinsic initial values (StateOptions.h:141-146,
    # VioManagerOptions.h:306-353): yaml carries the forward maps Tw/Ta and
    # the IMU→sensor rotations; the state stores their inverses/transposes.
    imu_model_str = str(imu_y.get("model", "kalibr")).lower()
    if imu_model_str == "calibrated":
        imu_model_str = "kalibr"
    if imu_model_str not in ("kalibr", "rpng"):
        raise ValueError(f"invalid imu model: {imu_model_str}")

    def _mat3(key, default):
        return np.asarray(imu_y.get(key, default), dtype=np.float64)

    I3 = np.eye(3)
    Tw = _mat3("Tw", I3)
    Ta = _mat3("Ta", I3)
    Tg_mat = _mat3("Tg", np.zeros((3, 3)))
    R_IMUtoGYRO = _mat3("R_IMUtoGYRO", I3)
    R_IMUtoACC = _mat3("R_IMUtoACC", I3)
    Dw_m = np.linalg.solve(Tw, I3)
    Da_m = np.linalg.solve(Ta, I3)
    if not (np.isfinite(Dw_m).all() and np.isfinite(Da_m).all()):
        raise ValueError(f"singular IMU intrinsic matrix in {imu_file}")
    if imu_model_str == "kalibr":
        dw6 = (Dw_m[0, 0], Dw_m[1, 0], Dw_m[2, 0],
               Dw_m[1, 1], Dw_m[2, 1], Dw_m[2, 2])
        da6 = (Da_m[0, 0], Da_m[1, 0], Da_m[2, 0],
               Da_m[1, 1], Da_m[2, 1], Da_m[2, 2])
    else:  # rpng: upper triangular (State.h:96-100)
        dw6 = (Dw_m[0, 0], Dw_m[0, 1], Dw_m[1, 1],
               Dw_m[0, 2], Dw_m[1, 2], Dw_m[2, 2])
        da6 = (Da_m[0, 0], Da_m[0, 1], Da_m[1, 1],
               Da_m[0, 2], Da_m[1, 2], Da_m[2, 2])
    tg9 = tuple(float(x) for x in Tg_mat.T.reshape(-1))  # column-major
    def _quat_of(R_to_imu):
        q = lie.rot_2_quat(torch.as_tensor(R_to_imu, dtype=torch.float32))
        return tuple(float(x) for x in q.tolist())

    imu = ImuCalib(
        sigma_w=float(imu_y["gyroscope_noise_density"]),
        sigma_wb=float(imu_y["gyroscope_random_walk"]),
        sigma_a=float(imu_y["accelerometer_noise_density"]),
        sigma_ab=float(imu_y["accelerometer_random_walk"]),
        rate=float(imu_y.get("update_rate", 200.0)),
        model=imu_model_str,
        dw=tuple(float(x) for x in dw6),
        da=tuple(float(x) for x in da6),
        tg=tg9,
        q_gyro=_quat_of(R_IMUtoGYRO.T),
        q_acc=_quat_of(R_IMUtoACC.T),
    )

    integration = str(get("integration", "rk4"))
    if integration not in ("discrete", "rk4", "analytical"):
        raise ValueError(f"unknown integration method: {integration}")

    sigma_msckf = float(get("up_msckf_sigma_px", 1.0))
    chi2_msckf = float(get("up_msckf_chi2_multipler", 1.0))
    cam_model = cams[0].model if cams else "radtan"
    fil = FilterConfig(
        max_clones=int(req("max_clones")),
        max_slam=int(req("max_slam")),
        num_cams=num_cams,
        max_msckf_in_update=int(get("max_msckf_in_update", 40)),
        calib_cam_timeoffset=bool(get("calib_cam_timeoffset", False)),
        calib_cam_extrinsics=bool(get("calib_cam_extrinsics", False)),
        calib_cam_intrinsics=bool(get("calib_cam_intrinsics", False)),
        calib_imu_intrinsics=bool(get("calib_imu_intrinsics", False)),
        calib_imu_g_sensitivity=bool(get("calib_imu_g_sensitivity", False)),
        imu_model=imu.model,
        integration=integration,
        use_fej=bool(get("use_fej", True)),
        use_zupt=bool(get("try_zupt", False)),
        feat_rep_msckf=str(get("feat_rep_msckf", "GLOBAL_3D")),
        feat_rep_slam=str(get("feat_rep_slam", "GLOBAL_3D")),
        feat_rep_aruco=str(get("feat_rep_aruco", "GLOBAL_3D")),
        dt_slam_delay=float(get("dt_slam_delay", 0.0)),
        cam_model=cam_model,
        sigma_w=imu.sigma_w, sigma_wb=imu.sigma_wb,
        sigma_a=imu.sigma_a, sigma_ab=imu.sigma_ab,
        sigma_pix=sigma_msckf,
        gravity_mag=float(get("gravity_mag", 9.81)),
        chi2_multiplier=chi2_msckf,
        # per-updater noise/gates default to the MSCKF values when absent
        sigma_pix_slam=float(get("up_slam_sigma_px", sigma_msckf)),
        chi2_multiplier_slam=float(get("up_slam_chi2_multipler", chi2_msckf)),
        sigma_pix_aruco=float(get("up_aruco_sigma_px", sigma_msckf)),
        chi2_multiplier_aruco=float(
            get("up_aruco_chi2_multipler", chi2_msckf)),
        num_aruco_tags=(int(get("num_aruco", 1024))
                        if bool(get("use_aruco", False)) else 0),
        zupt_noise_multiplier=float(get("zupt_noise_multiplier", 10.0)),
        zupt_max_velocity=float(get("zupt_max_velocity", 0.25)),
        zupt_max_disparity=float(get("zupt_max_disparity", 0.5)),
        zupt_chi2_multiplier=float(get("zupt_chi2_multipler", 1.0)),
        zupt_only_at_beginning=bool(get("zupt_only_at_beginning", False)),
    )

    tracker = TrackerConfig(
        use_klt=bool(get("use_klt", True)),
        num_pts=int(get("num_pts", 200)),
        fast_threshold=int(get("fast_threshold", 20)),
        grid_x=int(get("grid_x", 5)),
        grid_y=int(get("grid_y", 5)),
        min_px_dist=int(get("min_px_dist", 10)),
        knn_ratio=float(get("knn_ratio", 0.70)),
        track_frequency=float(get("track_frequency", 21.0)),
        downsample_cameras=bool(get("downsample_cameras", False)),
        histogram_method=str(get("histogram_method", "HISTOGRAM")),
        use_mask=bool(get("use_mask", False)),
        mask_paths=tuple(
            os.path.join(base, str(get(f"mask{i}", "")))
            for i in range(num_cams)
        ) if bool(est_raw.get("use_mask", False)) else (),
        use_aruco=bool(get("use_aruco", False)),
        num_aruco=int(get("num_aruco", 1024)),
        downsize_aruco=bool(get("downsize_aruco", True)),
    )

    def _vec3(key, default):
        v = get(key, list(default))
        return tuple(float(x) for x in v)

    init = InitConfig(
        window_time=float(get("init_window_time", 2.0)),
        imu_thresh=float(get("init_imu_thresh", 1.5)),
        max_disparity=float(get("init_max_disparity", 10.0)),
        max_features=int(get("init_max_features", 50)),
        dyn_use=bool(get("init_dyn_use", False)),
        dyn_mle_opt_calib=bool(get("init_dyn_mle_opt_calib", False)),
        dyn_mle_max_iter=int(get("init_dyn_mle_max_iter", 50)),
        dyn_num_pose=int(get("init_dyn_num_pose", 6)),
        dyn_min_deg=float(get("init_dyn_min_deg", 10.0)),
        dyn_inflation_ori=float(get("init_dyn_inflation_ori", 10.0)),
        dyn_inflation_vel=float(get("init_dyn_inflation_vel", 100.0)),
        dyn_inflation_bg=float(get("init_dyn_inflation_bg", 10.0)),
        dyn_inflation_ba=float(get("init_dyn_inflation_ba", 100.0)),
        dyn_min_rec_cond=float(get("init_dyn_min_rec_cond", 1e-12)),
        dyn_bias_g=_vec3("init_dyn_bias_g", (0.0, 0.0, 0.0)),
        dyn_bias_a=_vec3("init_dyn_bias_a", (0.0, 0.0, 0.0)),
    )

    tri = TriangulationOptions(
        refine=bool(get("fi_refine_features", True)),
        triangulate_1d=bool(get("fi_triangulate_1d", False)),
        max_runs=int(get("fi_max_runs", 5)),
        init_lamda=float(get("fi_init_lamda", 1e-3)),
        max_lamda=float(get("fi_max_lamda", 1e10)),
        min_dx=float(get("fi_min_dx", 1e-6)),
        min_dcost=float(get("fi_min_dcost", 1e-6)),
        lam_mult=float(get("fi_lam_mult", 10.0)),
        min_dist=float(get("fi_min_dist", 0.10)),
        max_dist=float(get("fi_max_dist", 60.0)),
        max_cond_number=float(get("fi_max_cond_number", 10000.0)),
    )
    consumed.add("fi_max_baseline")  # gate not used: masked fixed windows

    output = OutputConfig(
        record_timing_information=bool(
            get("record_timing_information", False)),
        record_timing_filepath=str(
            get("record_timing_filepath", "/tmp/traj_timing.txt")),
        save_total_state=bool(get("save_total_state", False)),
        filepath_est=str(get("filepath_est", "/tmp/ov_estimate.txt")),
        filepath_std=str(get("filepath_std", "/tmp/ov_estimate_std.txt")),
        filepath_gt=str(get("filepath_gt", "/tmp/ov_groundtruth.txt")),
    )

    cfg = VioConfig(
        filter=fil,
        cams=cams,
        imu=imu,
        calib_dt=float(get("calib_camimu_dt", 0.0)),
        use_stereo=bool(get("use_stereo", num_cams > 1)),
        downsample_cameras=tracker.downsample_cameras,
        init_window_time=init.window_time,
        init_imu_thresh=init.imu_thresh,
        try_zupt=fil.use_zupt,
        tracker=tracker,
        init=init,
        output=output,
        tri=tri,
    )

    if warn_unknown:
        leftover = set(est_raw.keys()) - consumed - set(_OUT_OF_SCOPE)
        for key in sorted(leftover):
            logger.warning(
                "config key %r in %s is not recognized and was ignored",
                key, config_path,
            )
    return cfg
