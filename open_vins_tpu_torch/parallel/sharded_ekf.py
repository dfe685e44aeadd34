"""Row-sharded EKF update: the covariance's rows partitioned over ranks.

Counterpart of `open_vins_tpu/parallel/sharded_ekf.py` (SURVEY.md §2.9
"window/model sharding"): for large states (many SLAM landmarks, long clone
windows) the dense [D, D] covariance is split by rows over the ranks of a
process group, and the update's heavy products P·Hᵀ and the downdate are
row-parallel.  The JAX package runs `core.ekf.kalman_update_math(...,
fuse_downdate=False)` under GSPMD, which inserts the collectives; here
each rank holds the rows [r·D/W, (r+1)·D/W) of the padded covariance and
the collectives are explicit — the same math in the same order:

    PHt_r = P_r Hᵀ                      rank r's rows of P Hᵀ
    S     = Σ_r H[:, r] PHt_r + R       one all_reduce
    L     = chol(S),  [Y_r | y] = L⁻¹[PHt_rᵀ | res]
    Y₁    = [Y_0 | … | Y_{W-1}]         one all_gather;  dx = Y₁ᵀ y
    P⁺_r  = P_r − Y_rᵀ Y₁               each rank downdates its own rows
    sym   = ½(P⁺ + P⁺ᵀ)                 one all_to_all_single

The symmetrization needs the other ranks' rows: rank r's rows of P⁺ᵀ are
the blocks P⁺[s-rows, r-cols] that rank s holds, so each rank sends its
[D/W, D/W] blocks to their owners, one all_to_all_single of its rows, and
the result is the reference's ½(P⁺ + P⁺ᵀ) exactly.  The downdate stays a
plain product (`torch.addmm` on the rank's rows), as it is a plain product
outside any kernel in the reference.  D is padded to a multiple of the
world size with zero rows and columns, and H gets zero columns, so the
padding stays zero.  A non-finite result on any rank (one more
all_reduce of a flag) makes the update an exact no-op on every rank, as
the dense update's.

Usage (on every rank of a group):
    st = sharded_ekf.shard_state(state, device=dev)   # own rows of P
    st = sharded_ekf.sharded_ekf_update(None, cfg)(st, H, res, r_diag)
    cov = sharded_ekf.gather_cov(st.cov)[:D, :D]      # the logical block

With no process group it is the dense update with the plain downdate (a
group of one rank runs the collectives, each a copy).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from open_vins_tpu_torch.core import ekf
from open_vins_tpu_torch.core.layout import FilterConfig
from open_vins_tpu_torch.core.state import VioState, boxplus
from open_vins_tpu_torch.parallel.mesh import rank_device, world


def _padded_dim(D, n_ranks):
    return ((D + n_ranks - 1) // n_ranks) * n_ranks


def pad_cov(cov, n_ranks):
    """Zero-pad the covariance to a dimension divisible by the world size.
    The padded rows and columns carry zero covariance and are never touched
    by H (H gets zero-padded columns), so the update is unchanged."""
    D = cov.shape[0]
    Dp = _padded_dim(D, n_ranks)
    if Dp == D:
        return cov
    out = torch.zeros((Dp, Dp), dtype=cov.dtype, device=cov.device)
    out[:D, :D] = cov
    return out


def row_block(Dp, rank, n_ranks):
    """The rows [lo, hi) of a padded dimension Dp that `rank` holds."""
    n = Dp // n_ranks
    return rank * n, (rank + 1) * n


def shard_state(state: VioState, group=None, device=None) -> VioState:
    """The state on the rank's device (`mesh.rank_device`, None = CUDA)
    with `cov` cut to this rank's rows of the padded covariance [D/W, Dp];
    every other leaf is replicated."""
    dev = rank_device(device, group)
    rank, n = world(group)
    cov_p = pad_cov(state.cov.to(dev), n)
    lo, hi = row_block(cov_p.shape[0], rank, n)
    out = {k: v.to(dev) for k, v in state.items()}
    out["cov"] = cov_p[lo:hi].contiguous()
    return VioState(**out)


def gather_cov(cov_rows, group=None):
    """The whole padded covariance [Dp, Dp] from every rank's rows (one
    all_gather), to read the result back."""
    _, n = world(group)
    if not dist.is_initialized():
        return cov_rows
    parts = [torch.empty_like(cov_rows) for _ in range(n)]
    dist.all_gather(parts, cov_rows.contiguous(), group=group)
    return torch.cat(parts)


def sharded_update_math(cov_rows, H_p, res, r_diag, group=None):
    """(dx [Dp], this rank's rows of the new covariance [Dp/W, Dp]) for
    this rank's rows of the padded covariance and the column-padded H
    [m, Dp] (module docstring)."""
    if not dist.is_initialized():
        return ekf.kalman_update_math(cov_rows, H_p, res, r_diag,
                                      fuse_downdate=False)
    rank, n = world(group)
    Dr, Dp = cov_rows.shape
    lo = rank * Dr
    PHt_r = cov_rows @ H_p.T  # [Dr, m]
    S = H_p[:, lo:lo + Dr] @ PHt_r
    dist.all_reduce(S, group=group)
    S = S + torch.diag(r_diag)
    S = 0.5 * (S + S.T)
    L, info = torch.linalg.cholesky_ex(S)
    Yt = torch.linalg.solve_triangular(
        L, torch.cat([PHt_r.T, res[:, None]], dim=1), upper=False)
    Y_r, y = Yt[:, :Dr].contiguous(), Yt[:, Dr]
    parts = [torch.empty_like(Y_r) for _ in range(n)]
    dist.all_gather(parts, Y_r, group=group)
    Y1 = torch.cat(parts, dim=1)  # [m, Dp]
    dx = Y1.T @ y
    new_rows = torch.addmm(cov_rows, Y_r.T, Y1, alpha=-1.0)
    # rank s's blocks P⁺[r-rows, s-cols] go to rank s; back come the
    # blocks P⁺[s-rows, r-cols], which stack into P⁺[:, r-cols]
    send = new_rows.reshape(Dr, n, Dr).permute(1, 0, 2).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    new_rows = 0.5 * (new_rows + recv.reshape(Dp, Dr).T)
    bad = ((info != 0) | ~torch.isfinite(dx).all()
           | ~torch.isfinite(new_rows).all()).to(cov_rows.dtype).reshape(1)
    dist.all_reduce(bad, group=group)
    ok = bad[0] == 0
    return torch.where(ok, dx, 0.0), torch.where(ok, new_rows, cov_rows)


def sharded_ekf_update(group, cfg: FilterConfig):
    """The update keeping the covariance row-sharded in and out.

    Accepts a state whose covariance is this rank's rows of the padded
    covariance (`shard_state`); H [m, D] is column-padded here.  Returns
    the state with its new rows (`gather_cov(state.cov)[:D, :D]` reads
    back the logical block)."""
    D = cfg.state_dim

    def update(state: VioState, H, res, r_diag) -> VioState:
        Dp = state.cov.shape[1]
        H_p = torch.zeros((H.shape[0], Dp), dtype=H.dtype, device=H.device)
        H_p[:, :D] = H
        dx_p, new_rows = sharded_update_math(state.cov, H_p, res, r_diag,
                                             group)
        return boxplus(state, cfg, dx_p[:D]).replace(cov=new_rows)

    return update
