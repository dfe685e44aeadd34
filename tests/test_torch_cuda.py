"""The port's hand-written CUDA kernels against their plain versions, on a
machine with an NVIDIA GPU (each test skips without one).  This file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: the repository's root conftest.py imports JAX.)
"""

import pytest
import torch

from open_vins_tpu_torch.ops import kernels
from torch_port_helpers import (check_r_factors, downdate_inputs, np_of,
                                oracle_blocks, stack_blocks)

# symmetric_downdate: the oracle shapes of tests/test_pallas_kernels.py, the
# main paths' (D, support) and a 1434-wide state
DOWNDATE_SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81),
                   (270, 231), (1434, 231)]
# householder_qr_blocks: the oracle [B, n] blocks (g = 3), then the [m, n]
# stacks cut into row blocks (MSCKF-only and the operating point's)
QR_CASES = [("oracle", 256, 128), ("oracle", 512, 128), ("oracle", 384, 256),
            ("stack", 760, 121), ("stack", 1174, 271)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", DOWNDATE_SHAPES)
def test_cuda_kernel_matches_plain_version(D, m, same):
    """symmetric_downdate at 1e-5·max(1, ‖P‖∞), exactly symmetric, one
    launch."""
    _need_gpu()
    P, K, PHt = (torch.from_numpy(a).cuda()
                 for a in downdate_inputs(D, m, same))
    before = kernels.symmetric_downdate.launches
    out = kernels.symmetric_downdate(P, K, PHt)
    torch.cuda.synchronize()
    assert kernels.symmetric_downdate.launches == before + 1
    ref = kernels.symmetric_downdate_ref(P, K, PHt)
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out, out.T)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,n", QR_CASES)
def test_cuda_qr_kernel_matches_plain_version(kind, rows, n):
    """householder_qr_blocks element by element at 1e-5·max|R| (the same
    reflectors; only the order of the f32 sums differs), RᵀR = AᵀA at 2e-3,
    strict lower triangle exactly 0, one launch."""
    _need_gpu()
    A = oracle_blocks(rows, n) if kind == "oracle" else stack_blocks(rows, n)
    A_d = torch.from_numpy(A).cuda()
    before = kernels.householder_qr_blocks.launches
    R = kernels.householder_qr_blocks(A_d)
    torch.cuda.synchronize()
    assert kernels.householder_qr_blocks.launches == before + 1
    ref = kernels.householder_qr_blocks_ref(A_d)
    tol = 1e-5 * ref.abs().max().item()
    assert (R - ref).abs().max().item() <= tol
    check_r_factors(np_of(R), A)


# edge shapes of the redesigned kernels: D = 1 and a D that is not a
# multiple of the 32-wide tile, m = 0 (out = ½(P + Pᵀ))
DOWNDATE_EDGE_SHAPES = [(1, 5), (1, 0), (33, 20), (33, 0), (120, 0)]
# (g, B, n): n < 32 (one ragged panel), B = n, g = 1 at the operating
# point's n = 271 (eight panels of 32 and a ragged one of 15), and a block
# taller than the 640 rows of the register panel (shared-memory panel)
QR_EDGE_SHAPES = [(2, 40, 15), (1, 71, 71), (1, 544, 271), (2, 271, 271),
                  (1, 704, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", DOWNDATE_EDGE_SHAPES)
def test_cuda_kernel_edge_shapes(D, m, same):
    """symmetric_downdate at the edge shapes: 1e-5·max(1, ‖P‖∞), exactly
    symmetric, one launch."""
    _need_gpu()
    P, K, PHt = (torch.from_numpy(a).cuda()
                 for a in downdate_inputs(D, m, same))
    if same:
        PHt = K
    before = kernels.symmetric_downdate.launches
    out = kernels.symmetric_downdate(P, K, PHt)
    torch.cuda.synchronize()
    assert kernels.symmetric_downdate.launches == before + 1
    ref = kernels.symmetric_downdate_ref(P, K, PHt)
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out, out.T)


@pytest.mark.cuda
@pytest.mark.parametrize("D,m", [(120, 81), (270, 231)])
def test_cuda_kernel_single_product_matches_two(D, m):
    """K passed twice takes the single product K·Kᵀ; an equal copy takes the
    two-product form: both agree within the tolerance."""
    _need_gpu()
    P, K, _ = (torch.from_numpy(a).cuda() for a in downdate_inputs(D, m, True))
    one = kernels.symmetric_downdate(P, K, K)
    two = kernels.symmetric_downdate(P, K, K.clone())
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (one - two).abs().max().item() <= tol
    assert torch.equal(one, one.T) and torch.equal(two, two.T)


@pytest.mark.cuda
@pytest.mark.parametrize("g,B,n", QR_EDGE_SHAPES)
def test_cuda_qr_kernel_edge_shapes(g, B, n):
    """householder_qr_blocks at the edge shapes: element by element at
    1e-5·max|R|, RᵀR = AᵀA at 2e-3, strict lower triangle exactly 0, one
    launch."""
    _need_gpu()
    A = oracle_blocks(B, n, g=g)
    A_d = torch.from_numpy(A).cuda()
    before = kernels.householder_qr_blocks.launches
    R = kernels.householder_qr_blocks(A_d)
    torch.cuda.synchronize()
    assert kernels.householder_qr_blocks.launches == before + 1
    ref = kernels.householder_qr_blocks_ref(A_d)
    assert (R - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    check_r_factors(np_of(R), A)
