"""Static error-state layout: a frozen copy of the port's
`core/layout.py`, so that the reference's state vectors and covariances
compare with the program's index for index.

Error-state ordering (all offsets static python ints):

    [ imu θ(3) p(3) v(3) bg(3) ba(3) |
      clone_0 θ(3) p(3) | ... | clone_{C-1} |
      slam_0 f(3) | ... | slam_{L-1} |
      calib_dt(1) |
      cam_0 ext θ(3) p(3) | ... |
      cam_0 intr ζ(8) | ... |
      imu intrinsics Dw(6) Da(6) Tg(9) θ_w(3) ]
"""

from __future__ import annotations

from typing import NamedTuple


class FilterConfig(NamedTuple):
    """Static filter configuration (ov_msckf StateOptions + fixed caps)."""

    max_clones: int = 11
    max_slam: int = 25
    num_cams: int = 1
    max_msckf_in_update: int = 40
    max_obs_per_feature: int = 12
    calib_cam_timeoffset: bool = False
    calib_cam_extrinsics: bool = False
    calib_cam_intrinsics: bool = False
    calib_imu_intrinsics: bool = False
    calib_imu_g_sensitivity: bool = False
    imu_model: str = "kalibr"
    integration: str = "rk4"  # "rk4" | "discrete" | "analytical"
    use_fej: bool = True
    use_zupt: bool = False
    feat_rep_msckf: str = "GLOBAL_3D"
    feat_rep_slam: str = "GLOBAL_3D"
    feat_rep_aruco: str = "GLOBAL_3D"
    dt_slam_delay: float = 0.0
    slam_stack_clones: int = 3
    joint_vision_update: bool = True
    gauge_deflation: bool = False
    joint_update_form: str = "qr"
    newton_joseph: bool = False
    newton_iters: int = 22
    fast_compress: bool = False
    cam_model: str = "radtan"
    sigma_w: float = 1.6968e-4
    sigma_wb: float = 1.9393e-5
    sigma_a: float = 2.0e-3
    sigma_ab: float = 3.0e-3
    sigma_pix: float = 1.0
    gravity_mag: float = 9.81
    chi2_multiplier: float = 1.0
    sigma_pix_slam: float = 1.0
    chi2_multiplier_slam: float = 1.0
    sigma_pix_aruco: float = 1.0
    chi2_multiplier_aruco: float = 1.0
    num_aruco_tags: int = 0
    zupt_noise_multiplier: float = 10.0
    zupt_max_velocity: float = 0.25
    zupt_max_disparity: float = 0.5
    zupt_chi2_multiplier: float = 1.0
    zupt_only_at_beginning: bool = False
    zupt_explicit_motion: bool = False

    # ---- layout offsets -------------------------------------------------
    @property
    def imu_off(self) -> int:
        return 0

    @property
    def imu_dim(self) -> int:
        return 15

    @property
    def th_off(self) -> int:
        return 0

    @property
    def p_off(self) -> int:
        return 3

    @property
    def v_off(self) -> int:
        return 6

    @property
    def bg_off(self) -> int:
        return 9

    @property
    def ba_off(self) -> int:
        return 12

    @property
    def clones_off(self) -> int:
        return 15

    def clone_off(self, slot: int) -> int:
        return self.clones_off + 6 * slot

    @property
    def slam_off(self) -> int:
        return self.clones_off + 6 * self.max_clones

    def slam_slot_off(self, slot: int) -> int:
        return self.slam_off + 3 * slot

    @property
    def calib_dt_off(self) -> int:
        return self.slam_off + 3 * self.max_slam

    @property
    def calib_ext_off(self) -> int:
        return self.calib_dt_off + 1

    def cam_ext_off(self, cam: int) -> int:
        return self.calib_ext_off + 6 * cam

    @property
    def calib_intr_off(self) -> int:
        return self.calib_ext_off + 6 * self.num_cams

    def cam_intr_off(self, cam: int) -> int:
        return self.calib_intr_off + 8 * cam

    @property
    def imu_dw_off(self) -> int:
        return self.calib_intr_off + 8 * self.num_cams

    @property
    def imu_da_off(self) -> int:
        return self.imu_dw_off + 6

    @property
    def imu_tg_off(self) -> int:
        return self.imu_da_off + 6

    @property
    def imu_thw_off(self) -> int:
        return self.imu_tg_off + 9

    @property
    def imu_intr_dim(self) -> int:
        return 24

    @property
    def state_dim(self) -> int:
        return self.imu_thw_off + 3

    # ---- static measurement column support -------------------------------
    @property
    def cam_meas_support_ranges(self) -> tuple:
        """(start, stop) ranges of columns a camera-feature row can touch:
        clone block + camera extrinsic/intrinsic calib (+ dt)."""
        return (
            (self.clones_off, self.clones_off + 6 * self.max_clones),
            (self.calib_dt_off, self.calib_intr_off + 8 * self.num_cams),
        )

    @property
    def slam_meas_support_ranges(self) -> tuple:
        """Support of SLAM-landmark rows: clones + landmarks + cam calib."""
        return (
            (self.clones_off, self.calib_intr_off + 8 * self.num_cams),
        )
