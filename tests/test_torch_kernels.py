"""The port's symmetric_downdate: its plain version against the TPU kernel
(Pallas, interpret mode) and the reference's jnp form, the wrapper's checks
and launch count.  The CUDA kernel against the plain version is in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.ops import pallas_kernels as pk
from open_vins_tpu_torch.ops import kernels
from torch_port_helpers import downdate_inputs, np_of

# the oracle shapes of tests/test_pallas_kernels.py plus the MSCKF-only
# main path's (D = 120, support m = 81)
SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81)]


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", SHAPES)
def test_plain_version_matches_tpu_kernel(D, m, same):
    P, K, PHt = downdate_inputs(D, m, same)
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
    P, K, PHt = (torch.from_numpy(a) for a in downdate_inputs(120, 81, True))
    before = kernels.symmetric_downdate.launches
    kernels.symmetric_downdate(P, K, K)
    assert kernels.symmetric_downdate.launches == before


def test_same_operand_detection():
    """The wrapper asks the kernel for the single product K·Kᵀ only when K
    and PHt are one tensor: not for an equal copy nor a transposed view."""
    K = torch.from_numpy(downdate_inputs(24, 24, True)[1])
    assert kernels.same_operand(K, K)
    assert kernels.same_operand(K, K.view(24, 24))
    assert not kernels.same_operand(K, K.clone())
    assert not kernels.same_operand(K, K.T)
    assert not kernels.same_operand(K, K[:, :12])


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape"])
def test_wrapper_rejects_bad_arguments(bad):
    P, K, PHt = (torch.from_numpy(a) for a in downdate_inputs(32, 8, False))
    if bad == "dtype":
        P = P.double()
    elif bad == "contiguous":
        K = torch.from_numpy(np.ascontiguousarray(K.numpy().T)).T
    else:
        PHt = PHt[:, :4].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kernels.symmetric_downdate(P, K, PHt)
