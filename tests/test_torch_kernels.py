"""The port's symmetric_downdate: its plain version against the TPU kernel
(Pallas, interpret mode) and the reference's jnp form, the wrapper's checks
and launch count, and — on a machine with a GPU — the CUDA kernel against
the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.ops import pallas_kernels as pk
from open_vins_tpu_torch.ops import kernels
from torch_port_helpers import np_of

# the oracle shapes of tests/test_pallas_kernels.py plus the MSCKF-only
# main path's (D = 120, support m = 81)
SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81)]


def _inputs(D, m, same, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) * 0.1
    P = (A @ A.T + np.eye(D)).astype(np.float32)
    K = (rng.normal(size=(D, m)) * 0.05).astype(np.float32)
    PHt = K if same else (rng.normal(size=(D, m)) * 0.05).astype(np.float32)
    return P, K, PHt


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", SHAPES)
def test_plain_version_matches_tpu_kernel(D, m, same):
    P, K, PHt = _inputs(D, m, same)
    got = np_of(kernels.symmetric_downdate(torch.from_numpy(P),
                                           torch.from_numpy(K),
                                           torch.from_numpy(PHt)))
    pallas = np.asarray(pk.symmetric_downdate_pallas(
        jnp.asarray(P), jnp.asarray(K), jnp.asarray(PHt), interpret=True))
    dense = np.asarray(pk._symmetric_downdate_jnp(
        jnp.asarray(P), jnp.asarray(K), jnp.asarray(PHt)))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, got.T)  # exact symmetry


def test_cpu_call_counts_no_launch():
    P, K, PHt = (torch.from_numpy(a) for a in _inputs(120, 81, True))
    before = kernels.symmetric_downdate.launches
    kernels.symmetric_downdate(P, K, K)
    assert kernels.symmetric_downdate.launches == before


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape"])
def test_wrapper_rejects_bad_arguments(bad):
    P, K, PHt = (torch.from_numpy(a) for a in _inputs(32, 8, False))
    if bad == "dtype":
        P = P.double()
    elif bad == "contiguous":
        K = torch.from_numpy(np.ascontiguousarray(K.numpy().T)).T
    else:
        PHt = PHt[:, :4].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kernels.symmetric_downdate(P, K, PHt)


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", SHAPES + [(270, 231), (1434, 231)])
def test_cuda_kernel_matches_plain_version(D, m, same):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    P, K, PHt = (torch.from_numpy(a).cuda() for a in _inputs(D, m, same))
    before = kernels.symmetric_downdate.launches
    out = kernels.symmetric_downdate(P, K, PHt)
    torch.cuda.synchronize()
    assert kernels.symmetric_downdate.launches == before + 1
    ref = kernels.symmetric_downdate_ref(P, K, PHt)
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out, out.T)
