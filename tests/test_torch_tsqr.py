"""The port's Householder TSQR compression against the JAX package:

* `householder_qr_blocks_ref` (the plain version of the Hopper kernel)
  against the TPU kernel `householder_qr_blocks_pallas` in interpret mode at
  the oracle shapes of tests/test_pallas_kernels.py: element by element at
  1e-5·max|R| (both apply the same reflectors; they differ by f32 rounding,
  about 1e-6·max|R| here) and through RᵀR = AᵀA at the JAX test's 2e-3;
* `compress_system` on tests/test_pallas_kernels.py's input (m = 700,
  D = 120, the TSQR route) against JAX's, as Gram matrices (R is unique
  only up to row signs, so R's are never compared element by element);
* the EKF update from the TSQR-compressed system against the update from
  `compress_system_ranges` (tests/test_compress.py's tolerances: p 2e-4,
  cov 2e-3).

* a plain-torch rendition of the CUDA kernel's blocked algorithm (panels of
  32 columns, reflectors kept below the panel's diagonal, the compact WY
  factor T by the larft recurrence, trailing updates C -= V Tᵀ Vᵀ C)
  against `householder_qr_blocks_ref` and the TPU kernel, element by
  element at 1e-5·max|R|, at shapes that cover a ragged last panel, n < nb,
  B = n, zero leading columns and zero padding rows.

The CUDA kernel against its plain version is in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.models import update_helper as juh
from open_vins_tpu.ops import pallas_kernels as pk
from open_vins_tpu_torch.core import ekf as tekf
from open_vins_tpu_torch.core.layout import FilterConfig as TCfg
from open_vins_tpu_torch.core.state import init_state
from open_vins_tpu_torch.models import update_helper as tuh
from open_vins_tpu_torch.ops import kernels
from torch_port_helpers import (STACK_ZERO_IMU, check_r_factors, np_of,
                                oracle_blocks, stack_blocks)

ORACLE_SHAPES = [(256, 128), (512, 128), (384, 256)]
# the stacks' row blocks: MSCKF-only (m = 760 rows of D + 1 = 121 columns)
# and the operating point's joint stack (m = 1174, D + 1 = 271)
STACK_SHAPES = [(760, 121), (1174, 271)]


@pytest.mark.parametrize("B,n", ORACLE_SHAPES)
def test_plain_version_matches_tpu_kernel(B, n):
    A = oracle_blocks(B, n)
    got = np_of(kernels.householder_qr_blocks(torch.from_numpy(A)))
    want = np.asarray(pk.householder_qr_blocks_pallas(jnp.asarray(A),
                                                      interpret=True))
    assert got.shape == (3, n, n)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    check_r_factors(got, A)


@pytest.mark.parametrize("m,n", STACK_SHAPES)
def test_plain_version_onstack_blocks(m, n):
    """The stacks' block shapes, with zero columns first (identity
    reflectors) and zero padding rows: RᵀR = AᵀA per block."""
    A = stack_blocks(m, n)
    R = np_of(kernels.householder_qr_blocks(torch.from_numpy(A)))
    check_r_factors(R, A)
    assert (R[:, :, :STACK_ZERO_IMU] == 0.0).all()  # zero columns stay 0


def test_cpu_call_counts_no_launch():
    before = kernels.householder_qr_blocks.launches
    kernels.householder_qr_blocks(torch.from_numpy(oracle_blocks(64, 32)))
    assert kernels.householder_qr_blocks.launches == before


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "short", "rank"])
def test_wrapper_rejects_bad_arguments(bad):
    A = torch.from_numpy(oracle_blocks(64, 32))
    if bad == "dtype":
        A = A.double()
    elif bad == "contiguous":
        A = A.transpose(0, 1)
    elif bad == "short":
        A = A[:, :16].contiguous()  # B < n
    else:
        A = A[0]
    with pytest.raises((TypeError, ValueError)):
        kernels.householder_qr_blocks(A)


def _tsqr_input(m=700, D=120, seed=3):
    """tests/test_pallas_kernels.py:47-65's input."""
    rng = np.random.default_rng(seed)
    H = (rng.normal(size=(m, D)) * 0.3).astype(np.float32)
    H[100:140] = 0.0  # masked rows
    res = (rng.normal(size=m) * 0.1).astype(np.float32)
    res[100:140] = 0.0
    return H, res


def test_compress_system_matches_jax(monkeypatch):
    H, res = _tsqr_input()
    m, D = H.shape
    blocks = []

    def spy(A_blocks):
        blocks.append(tuple(A_blocks.shape))
        return kernels.householder_qr_blocks(A_blocks)

    monkeypatch.setattr(tuh, "householder_qr_blocks", spy)
    Hc_t, rc_t = tuh.compress_system(torch.from_numpy(H),
                                     torch.from_numpy(res), D)
    assert blocks == [(3, 256, D + 1)]  # the TSQR route, 3 row blocks
    Hc_j, rc_j = juh.compress_system(jnp.asarray(H), jnp.asarray(res), D)
    assert Hc_t.shape == Hc_j.shape and rc_t.shape == rc_j.shape

    def gram(Hc, rc):
        C = np.concatenate([np.asarray(Hc, np.float64),
                            np.asarray(rc, np.float64)[:, None]], 1)
        return (C.T @ C)[:D, :]

    A = np.concatenate([H, res[:, None]], 1).astype(np.float64)
    G_ref = (A.T @ A)[:D, :]
    G_t, G_j = gram(np_of(Hc_t), np_of(rc_t)), gram(Hc_j, rc_j)
    # test_pallas_kernels.py's tolerance against the exact Gram, and the
    # two packages against each other
    np.testing.assert_allclose(G_t, G_ref, atol=5e-2, rtol=5e-3)
    np.testing.assert_allclose(G_t, G_j, atol=5e-2, rtol=5e-3)


def test_dense_route_below_ratio(monkeypatch):
    """m < 4n takes one dense QR, as in the reference: no row blocks."""
    H, res = _tsqr_input(m=300)
    monkeypatch.setattr(tuh, "householder_qr_blocks", None)  # unreachable
    Hc, rc = tuh.compress_system(torch.from_numpy(H), torch.from_numpy(res),
                                 120)
    C = np.concatenate([np_of(Hc), np_of(rc)[:, None]], 1).astype(np.float64)
    A = np.concatenate([H, res[:, None]], 1).astype(np.float64)
    np.testing.assert_allclose((C.T @ C)[:120], (A.T @ A)[:120], atol=5e-2,
                               rtol=5e-3)


def test_tsqr_update_matches_ranges_update():
    """The EKF update from the TSQR-compressed system equals the update
    from compress_system_ranges on the same rows (tests/test_compress.py's
    check, on a support-limited H tall enough for the TSQR route)."""
    cfg = TCfg(max_clones=5, max_slam=4, num_cams=1)
    D = cfg.state_dim
    rng = np.random.default_rng(4)
    st = init_state(cfg, "cpu")
    A = rng.normal(size=(D, D)) * 0.05
    st = st.replace(cov=torch.from_numpy((A @ A.T + 1e-2 * np.eye(D))
                                         .astype(np.float32)))
    ranges = cfg.slam_meas_support_ranges
    m = 5 * (D + 1)
    H = np.zeros((m, D), np.float32)
    for a, b in ranges:
        H[:, a:b] = rng.normal(size=(m, b - a)) * 0.3
    res = (rng.normal(size=m) * 0.02).astype(np.float32)
    H, res = torch.from_numpy(H), torch.from_numpy(res)

    Hq, rq = tuh.compress_system(H, res, D)
    s_q = tekf.ekf_update(st, cfg, Hq, rq, torch.ones(D))
    Hr, rr = tuh.compress_system_ranges(H, res, ranges, D)
    s_r = tekf.ekf_update(st, cfg, Hr, rr, torch.ones(Hr.shape[0]),
                          ranges=ranges)
    np.testing.assert_allclose(np_of(s_q.p), np_of(s_r.p), atol=2e-4)
    np.testing.assert_allclose(np_of(s_q.cov), np_of(s_r.cov), atol=2e-3)


QR_PANEL = 32  # nb of csrc/householder_qr_blocks.cu


def blocked_wy_qr(A_blocks, nb=QR_PANEL):
    """R of csrc/householder_qr_blocks.cu's algorithm, step for step in
    plain torch: per panel of nb columns at j0, the panel is factored column
    by column with the TPU kernel's reflectors (only the diagonal entry of a
    reflector's own column is updated, so V stays below the diagonal), T is
    built by T[0:j, j] = −τ_j T[0:j, 0:j] (V[:, 0:j]ᵀ v_j), and the trailing
    columns take C −= V (Tᵀ (Vᵀ C))."""
    g, B, n = A_blocks.shape
    A = A_blocks.clone()
    for b in range(g):
        a = A[b]
        for j0 in range(0, n, nb):
            w = min(nb, n - j0)
            pn = a[j0:, j0:j0 + w]  # a view: updates land in `a`
            V = torch.zeros(B - j0, w)
            tau = torch.zeros(w)
            Y = torch.zeros(w, w)
            for j in range(w):
                x = pn[j + 1:, j]
                t = torch.sum(x * x)
                alpha = pn[j, j].clone()
                normx = torch.sqrt(alpha * alpha + t)
                beta = -normx if alpha >= 0 else normx
                vj = alpha - beta
                vn2 = vj * vj + t
                if not vn2 > 1e-30:
                    continue  # identity reflector: zero V column, zero τ
                tau[j] = 2.0 / vn2
                v = torch.cat([vj[None], x])  # rows j.. of the panel
                V[j:, j] = v
                s = v @ pn[j:, :]  # y for columns < j, vᵀA for the rest
                Y[:j, j] = s[:j]
                wc = tau[j] * s
                pn[j, j] = alpha - vj * wc[j]
                pn[j:, j + 1:] -= torch.outer(v, wc[j + 1:])
            T = torch.diag(tau)
            for j in range(1, w):
                T[:j, j] = -tau[j] * (T[:j, :j] @ Y[:j, j])
            if j0 + w < n:
                C = a[j0:, j0 + w:]
                C -= V @ (T.T @ (V.T @ C))
    return torch.triu(A[:, :n, :])


# (B, n, zeroed leading columns, zeroed trailing rows, g)
BLOCKED_CASES = [
    (96, 47, 0, 0, 2),   # ragged last panel (47 = 32 + 15)
    (40, 15, 0, 0, 2),   # n < nb
    (71, 71, 0, 0, 1),   # B = n (three panels, the last ragged), g = 1
    (128, 64, 15, 9, 3),  # STACK_ZERO_IMU zero columns and zero padding rows
]


@pytest.mark.parametrize("B,n,zero_cols,zero_rows,g", BLOCKED_CASES)
def test_blocked_wy_matches_plain_version_and_tpu_kernel(B, n, zero_cols,
                                                         zero_rows, g):
    """The CUDA kernel's blocked arithmetic against the unblocked oracle and
    the TPU kernel, element by element at 1e-5·max|R|; zero columns stay
    exactly zero."""
    A = np.random.default_rng(B + n).normal(size=(g, B, n)).astype(np.float32)
    A[:, :, :zero_cols] = 0.0
    if zero_rows:
        A[:, -zero_rows:, :] = 0.0
    got = np_of(blocked_wy_qr(torch.from_numpy(A)))
    ref = np_of(kernels.householder_qr_blocks_ref(torch.from_numpy(A)))
    tpu = np.asarray(pk.householder_qr_blocks_pallas(jnp.asarray(A),
                                                     interpret=True))
    for want in (ref, tpu):
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0)
    assert (got[:, :, :zero_cols] == 0.0).all()
    check_r_factors(got, A)
