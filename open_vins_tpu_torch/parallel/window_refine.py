"""Sliding-window BA refinement of the live filter state.

Counterpart of `open_vins_tpu/parallel/window_refine.py` (BASELINE config
5's "distributed BA refinement"): takes the filter's clone window and the
current feature tracks, builds a BAProblem (poses = the clone window's
camera-0 frames, the extrinsic folded in), runs the landmark-sharded Schur
Gauss-Newton (`parallel/distributed_ba.py`) over the ranks of a process
group, and returns the refined window poses — a smoother-grade polish of
the filter trajectory.

This is an output refinement (it does not feed back into the covariance):
the filter stays a consistent EKF; the refined window is for publishing
and evaluation.

The landmarks are the `max_landmarks` rows with the most observations.
Observation counts tie as a rule; the reference's `lax.top_k` takes the
lower row among equal scores, and so does the stable descending sort here
(`select_rows`), so both packages refine the same landmarks.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import VioState
from open_vins_tpu_torch.models import feature_table as ft
from open_vins_tpu_torch.models import triangulation as tri
from open_vins_tpu_torch.ops import lie
from open_vins_tpu_torch.parallel import distributed_ba as dba
from open_vins_tpu_torch.parallel.mesh import rank_device


def select_rows(table: ft.FeatureTable, max_landmarks: int):
    """(rows [max_landmarks], score [T]): the live rows with the most
    observations, ties to the lower row (as `lax.top_k`); empty rows score
    -1."""
    n_obs = ft.row_obs_counts(table)
    score = torch.where(table.ids >= 0, n_obs.to(torch.float32), -1.0)
    return ft.select_candidates(score, max_landmarks), score


def build_problem(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                  tri_opts: tri.TriangulationOptions, max_landmarks: int,
                  gather_fn):
    """Assemble a BAProblem from the clone window + longest current tracks.

    Uses cam-0 poses (R_GtoC, p_CinG) as the BA 'camera' frames so the
    extrinsic is folded in; landmarks triangulated from the current state.
    max_landmarks should divide by the world size for sharded runs.
    Returns (problem, ok [max_landmarks])."""
    rows, score = select_rows(table, max_landmarks)
    tri_obs, gobs = gather_fn(state, cfg, table, rows)
    p_f, ok = tri.triangulate_batch(tri_obs, tri_opts)
    ok = ok & torch.isfinite(p_f).all(dim=-1) & (score[rows] > 2)
    p_f = torch.where(ok[:, None], p_f,
                      torch.tensor([0.0, 0.0, 1.0], dtype=p_f.dtype,
                                   device=p_f.device))

    # BA poses: cam0 at each clone slot
    R_GtoI = lie.quat_2_rot(state.clones_q)  # [C,3,3]
    R_ItoC0 = lie.quat_2_rot(state.calib_ext_q[0])
    R = R_ItoC0 @ R_GtoI
    p = state.clones_p - (R_GtoI.mT @ (R_ItoC0.T @ state.calib_ext_p[0]))

    # observations: (slot, uvn) pairs from the gathered cam-0 entries
    cam0 = gobs.cam == 0  # [F, O]
    obs_mask = (gobs.mask & cam0 & ok[:, None]
                & state.clone_valid[gobs.clone_slot])
    kw = dict(dtype=R.dtype, device=R.device)
    prob = dba.BAProblem(
        R=R, p=p, landmarks=p_f,
        obs_pose=gobs.clone_slot.to(torch.int32),
        obs_uvn=gobs.uvn,
        obs_mask=obs_mask,
        R_ItoC=torch.eye(3, **kw),  # extrinsic already folded in
        p_IinC=torch.zeros(3, **kw),
    )
    return prob, ok


def refine_window(state: VioState, cfg: FilterConfig, table: ft.FeatureTable,
                  tri_opts: tri.TriangulationOptions, gather_fn, group=None,
                  max_landmarks=64, iters=3, device=None):
    """Refined (R_GtoC0 [C,3,3], p_C0inG [C,3], landmarks [max_landmarks,
    3], rms_before, rms_after) on the rank's device (`mesh.rank_device`,
    None = CUDA).  Every rank builds the same problem and refines its share
    of the landmarks; the landmarks come back gathered in row order."""
    dev = rank_device(device, group)
    state, table = pytree.tree_map(lambda v: v.to(dev), (state, table))
    prob, _ = build_problem(state, cfg, table, tri_opts, max_landmarks,
                            gather_fn)
    prob = dba.shard_problem(prob, group, dev)
    e0 = dba.reprojection_rmse(prob, group)
    prob2, _ = dba.refine(prob, iters=iters, group=group)
    e1 = dba.reprojection_rmse(prob2, group)
    return (prob2.R, prob2.p, dba.gather_landmarks(prob2.landmarks, group),
            e0, e1)
