"""Distributed sliding-window bundle adjustment by Schur complement over the
ranks of a process group.

Counterpart of `open_vins_tpu/parallel/distributed_ba.py` — the
reference's closest analog is the Ceres DENSE_SCHUR solve inside dynamic
initialization (DynamicInitializer.cpp:622-628), generalized to a
sliding-window refiner that scales over devices.

Structure (classic BA sparsity):
  * unknowns: K camera/clone poses (6-dof each) + L landmarks (3-dof each),
  * landmarks are sharded over the ranks (`shard_problem`); each rank
    builds only its landmark blocks H_pp, H_pl, H_ll,
  * Schur: each rank eliminates its landmarks locally,
      S_r = Σ_{l∈r} ( H_pl,l H_ll,l⁻¹ H_lp,l ),  b by the same blocks,
  * one all_reduce of S and b (the reference's `psum`).  The landmarks'
    terms are summed, on each rank and over the ranks, in f64 and the sum
    rounded to f32 once: the reduced pose system holds the gauge by its
    small damping only, so f32 sums in another order (another split of the
    landmarks) moved the poses by up to 2.5e-4; this way every split gives
    the single rank's system,
  * every rank solves the small reduced pose system, then back-substitutes
    its own landmarks — no further communication.

The reference's per-landmark and per-observation `vmap`s are batched
tensor operations here, and `refine`'s `lax.scan` a Python loop.  With no
process group it is the plain dense BA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from open_vins_tpu_torch import resolve_device
from open_vins_tpu_torch.core.state import TensorRecord
from open_vins_tpu_torch.ops import lie
from open_vins_tpu_torch.parallel.mesh import rank_device, world


@dataclasses.dataclass
class BAProblem(TensorRecord):
    """Gauss-Newton BA linearization inputs (fixed shapes).

    K poses (R_GtoI [K,3,3], p_IinG [K,3]); L landmarks [L,3] (global);
    observations: for each landmark, up to O obs: pose index, normalized uv,
    validity.  Extrinsics fixed (camera extrinsics are folded into the
    poses by the caller)."""

    R: torch.Tensor  # [K,3,3] world-to-body
    p: torch.Tensor  # [K,3]
    landmarks: torch.Tensor  # [L,3]
    obs_pose: torch.Tensor  # [L,O] int32
    obs_uvn: torch.Tensor  # [L,O,2]
    obs_mask: torch.Tensor  # [L,O] bool
    R_ItoC: torch.Tensor  # [3,3]
    p_IinC: torch.Tensor  # [3]


def _landmark_system(prob: BAProblem):
    """Every landmark's Gauss-Newton rows, masked observations zeroed:
    (A_p [L, 2O, 6K], A_l [L, 2O, 3], r [L, 2O])."""
    K = prob.R.shape[0]
    L, O = prob.obs_pose.shape
    k = prob.obs_pose.long()  # [L, O]
    Rk, pk = prob.R[k], prob.p[k]  # [L, O, 3, 3], [L, O, 3]
    d = prob.landmarks[:, None, :] - pk  # pf - pk
    Rd = (Rk @ d[..., None])[..., 0]  # Rk (pf - pk)
    p_C = (prob.R_ItoC @ Rd[..., None])[..., 0] + prob.p_IinC
    z = torch.where(p_C[..., 2].abs() > 1e-6, p_C[..., 2],
                    torch.full_like(p_C[..., 2], 1e-6))
    pred = p_C[..., :2] / z[..., None]
    r = prob.obs_uvn - pred
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([inv_z, zero, -p_C[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, inv_z, -p_C[..., 1] * inv_z * inv_z], -1)],
        -2)  # [L, O, 2, 3]
    dpC_dth = prob.R_ItoC @ lie.skew(Rd)
    dpC_dpf = prob.R_ItoC @ Rk
    Jth = J_proj @ dpC_dth  # [L, O, 2, 3]
    Jp = J_proj @ -dpC_dpf
    Jl = J_proj @ dpC_dpf
    w = prob.obs_mask.to(pred.dtype)[..., None, None]
    J6 = torch.cat([Jth * w, Jp * w], dim=-1)  # [L, O, 2, 6]
    at_k = (torch.arange(K, device=k.device) == k[..., None])  # [L, O, K]
    A_pose = torch.where(at_k[:, :, None, :, None], J6[:, :, :, None, :],
                         torch.zeros((), dtype=J6.dtype, device=J6.device))
    return (A_pose.reshape(L, 2 * O, 6 * K), (Jl * w).reshape(L, 2 * O, 3),
            (r * w[..., 0]).reshape(L, 2 * O))


def _local_schur(prob: BAProblem, damping):
    """Schur pieces from this rank's landmarks:
    (S [6K,6K], b [6K], Hll_inv [Lloc,3,3], Hlp [Lloc,3,6K], bl [Lloc,3])."""
    A_p, A_l, r = _landmark_system(prob)
    A_pT = A_p.mT
    Hpp = A_pT @ A_p
    Hpl = A_pT @ A_l  # [L, 6K, 3]
    eye3 = torch.eye(3, dtype=A_l.dtype, device=A_l.device)
    Hll = A_l.mT @ A_l + damping * eye3
    bp = (A_pT @ r[..., None])[..., 0]
    bl = (A_l.mT @ r[..., None])[..., 0]
    Hll_inv, _ = torch.linalg.inv_ex(Hll)
    HplHi = Hpl @ Hll_inv
    S = Hpp - HplHi @ Hpl.mT
    b = bp - (HplHi @ bl[..., None])[..., 0]
    # the landmarks' sums in f64: the reduced system then does not depend
    # on how the landmarks are split over ranks (module docstring)
    return (S.to(torch.float64).sum(0), b.to(torch.float64).sum(0),
            Hll_inv, Hpl.mT, bl)


def ba_step(prob: BAProblem, group=None, damping=1e-6, pose_damping=1e-4):
    """One distributed Gauss-Newton step on this rank's landmark shard.
    Returns (new problem, dx_pose).  In a process group the reduced pose
    system is all_reduced; without one, the same code is the plain
    single-device step."""
    S, b, Hll_inv, Hlp, bl = _local_schur(prob, damping)
    if dist.is_initialized():
        Sb = torch.cat([S, b[:, None]], dim=1).contiguous()
        dist.all_reduce(Sb, group=group)
        S, b = Sb[:, :-1], Sb[:, -1]
    S, b = S.to(prob.R.dtype), b.to(prob.R.dtype)
    K6 = S.shape[0]
    S = S + pose_damping * torch.eye(K6, dtype=S.dtype, device=S.device)
    dx_pose = torch.linalg.solve_ex(S, b[:, None])[0][:, 0]
    # back-substitute local landmarks: dx_l = Hll⁻¹ (bl − Hlp dx_pose)
    dx_l = (Hll_inv @ (bl - Hlp @ dx_pose)[..., None])[..., 0]
    dx = dx_pose.reshape(-1, 6)
    # pose update: R <- exp(-δθ) R (JPL left), p <- p + δp
    R_new = lie.exp_so3(-dx[:, :3]) @ prob.R
    return prob.replace(R=R_new, p=prob.p + dx[:, 3:],
                        landmarks=prob.landmarks + dx_l), dx_pose


def refine(prob: BAProblem, iters=5, group=None, gauge_fix=True):
    """Run `iters` Gauss-Newton steps; the BA gauge freedom (a global rigid
    transform) is fixed by re-anchoring the whole solution so that pose 0
    stays at its input value after every step.  Returns (problem, the norm
    of every step's pose update [iters])."""
    R0d, p0d = prob.R[0], prob.p[0]

    def reanchor(prob):
        # world transform x' = Q x + d with Q = R0dᵀ R0c, d = p0d - Q p0c
        Q = R0d.T @ prob.R[0]
        d = p0d - Q @ prob.p[0]
        return prob.replace(R=prob.R @ Q.T, p=prob.p @ Q.T + d,
                            landmarks=prob.landmarks @ Q.T + d)

    norms = []
    for _ in range(iters):
        prob, dx = ba_step(prob, group=group)
        if gauge_fix:
            prob = reanchor(prob)
        norms.append(torch.linalg.vector_norm(dx))
    return prob, torch.stack(norms)


def reprojection_rmse(prob: BAProblem, group=None):
    """Masked RMS reprojection error (normalized coordinates) over every
    rank's landmarks."""
    _, _, r = _landmark_system(prob)
    sums = torch.stack([torch.sum(r * r),
                        2.0 * prob.obs_mask.sum().to(r.dtype)])
    if dist.is_initialized():
        dist.all_reduce(sums, group=group)
    return torch.sqrt(sums[0] / torch.clamp(sums[1], min=1.0))


def shard_problem(prob: BAProblem, group=None, device=None) -> BAProblem:
    """This rank's share of a whole problem, on the rank's device
    (`mesh.rank_device`, None = CUDA): the landmark rows [r·L/W,
    (r+1)·L/W); poses and extrinsics replicated.  L must be divisible by
    the world size."""
    dev = rank_device(device, group)
    rank, n = world(group)
    L = prob.landmarks.shape[0]
    if L % n:
        raise ValueError(f"{L} landmarks do not divide over {n} ranks")
    lo, hi = rank * (L // n), (rank + 1) * (L // n)
    out = {k: v.to(dev) for k, v in prob.items()}
    for k in ("landmarks", "obs_pose", "obs_uvn", "obs_mask"):
        out[k] = out[k][lo:hi]
    return BAProblem(**out)


def gather_landmarks(landmarks, group=None):
    """Every rank's landmarks [L, 3] in rank order (one all_gather)."""
    if not dist.is_initialized():
        return landmarks
    _, n = world(group)
    parts = [torch.empty_like(landmarks) for _ in range(n)]
    dist.all_gather(parts, landmarks.contiguous(), group=group)
    return torch.cat(parts)


def make_ba_problem(K=6, L=32, O=6, noise=1e-3, perturb=0.05, seed=0,
                    device=None):
    """The synthetic problem of tests/test_parallel.py's `make_ba_problem`
    (a camera ring around a point cloud, perturbed poses and landmarks), in
    numpy with the port's f32 `exp_so3`, on `device` (None = CUDA).
    Returns (problem, (true R [K,3,3], p [K,3], landmarks [L,3]))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def exp_so3(w):
        return lie.exp_so3(torch.as_tensor(w, dtype=torch.float32)).numpy()

    Rs, ps = [], []
    for k in range(K):
        w = rng.normal(size=3) * 0.1
        Rs.append(exp_so3(w))
        ps.append(np.array([0.5 * k, 0.05 * k, 0.0]))
    Rs, ps = np.stack(Rs), np.stack(ps)
    lms = rng.uniform(-2, 2, size=(L, 3)) + np.array([1.5, 0, 6.0])
    obs_pose = np.tile(np.arange(O) % K, (L, 1)).astype(np.int32)
    obs_uvn = np.zeros((L, O, 2), np.float32)
    obs_mask = np.ones((L, O), bool)
    for l in range(L):
        for o in range(O):
            k = obs_pose[l, o]
            pC = Rs[k] @ (lms[l] - ps[k])
            if pC[2] < 0.5:
                obs_mask[l, o] = False
                continue
            obs_uvn[l, o] = pC[:2] / pC[2] + rng.normal(size=2) * noise
    Rs_n, ps_n = [Rs[0]], [ps[0]]
    for k in range(1, K):
        dw = rng.normal(size=3) * perturb * 0.2
        Rs_n.append(exp_so3(-dw) @ Rs[k])
        ps_n.append(ps[k] + rng.normal(size=3) * perturb)
    lms_n = lms + rng.normal(size=lms.shape) * perturb

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    prob = BAProblem(
        R=f32(np.stack(Rs_n)), p=f32(np.stack(ps_n)), landmarks=f32(lms_n),
        obs_pose=torch.as_tensor(obs_pose, device=dev),
        obs_uvn=torch.as_tensor(obs_uvn, device=dev),
        obs_mask=torch.as_tensor(obs_mask, device=dev),
        R_ItoC=torch.eye(3, dtype=torch.float32, device=dev),
        p_IinC=torch.zeros(3, dtype=torch.float32, device=dev))
    return prob, (Rs, ps, lms)
