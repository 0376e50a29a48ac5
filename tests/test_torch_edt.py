"""The port's min-plus EDT (plain PyTorch version, which the CUDA kernel
reproduces bitwise on the card) against the JAX package's Pallas kernel
(interpret mode) and XLA path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cluster_tools_tpu.ops import edt as jedt
from cluster_tools_tpu_torch.ops import edt as pedt

torch.set_num_threads(2)

# the shapes of the JAX package's Pallas test (n < 128, n not a multiple
# of 128, rows not a multiple of 16) plus the short z axis of a block
SHAPES = [(13, 37), (4, 130), (20, 129), (331, 58)]


def _scanlines(m, n, seed):
    rng = np.random.RandomState(seed)
    f = (rng.rand(m, n) * 50).astype("float32")
    f[rng.rand(m, n) < 0.5] = pedt.BIG     # foreground at the EDT's BIG
    return f


@pytest.mark.parametrize("m,n", SHAPES)
def test_minplus_plain_unit_spacing_bitwise(m, n):
    """At unit spacing every candidate f + (i-j)^2 is one exact-cost f32
    add, so the plain version, the Pallas kernel and the XLA path agree
    bitwise."""
    f = _scanlines(m, n, seed=m + n)
    got = pedt.minplus_plain(torch.from_numpy(f), 1.0).numpy()
    pallas = np.asarray(jedt._minplus_pallas(jnp.asarray(f), 1.0,
                                             interpret=True))
    xla = np.asarray(jedt._minplus_axis(jnp.asarray(f), 1, 1.0))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("m,n", SHAPES)
def test_minplus_plain_anisotropic(m, n):
    """Anisotropic spacing.  Against the Pallas kernel (same cost formula
    (d*d)*s^2, which interpret mode contracts into one FMA with the add):
    rtol 1e-6, one float32 ulp.  Against the XLA path, which squares the
    difference of the rounded positions i*s and j*s: each position carries
    up to n*s*2^-24 of rounding, so its cost differs relatively by up to
    4*n*2^-24 from the exact-integer cost."""
    f = _scanlines(m, n, seed=2 * m + n)
    s = 0.7
    got = pedt.minplus_plain(torch.from_numpy(f), s).numpy()
    pallas = np.asarray(jedt._minplus_pallas(jnp.asarray(f), s,
                                             interpret=True))
    xla = np.asarray(jedt._minplus_axis(jnp.asarray(f), 1, s))
    np.testing.assert_allclose(got, pallas, rtol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=4 * n * 2.0 ** -24)


@pytest.mark.parametrize("shape,sampling", [
    ((24, 40, 36), None), ((17, 33, 29), None), ((12, 20, 18), (2.0, 1.0, 1.0))])
def test_distance_transform_edt_3d(shape, sampling):
    """3-d EDT of a random mask: bitwise equal to the JAX function at
    unit spacing (XLA's float32 sqrt is correctly rounded, and so is the
    port's); at anisotropic spacing rtol as for the XLA path above."""
    rng = np.random.RandomState(sum(shape))
    mask = rng.rand(*shape) > 0.15
    want = np.asarray(jedt.distance_transform_edt(jnp.asarray(mask),
                                                  sampling=sampling))
    got = pedt.distance_transform_edt(torch.from_numpy(mask),
                                      sampling=sampling).numpy()
    if sampling is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * max(shape) * 2.0 ** -24)


def test_minplus_dispatch_takes_plain_only_for_cpu_tensors():
    """A CPU tensor takes the plain version (no kernel launch is
    counted); the kernel wrapper refuses anything that is not on the
    card instead of falling back."""
    from cluster_tools_tpu_torch import kernels

    kernels.reset_counts()
    f = torch.from_numpy(_scanlines(8, 20, seed=1))
    np.testing.assert_array_equal(pedt.minplus(f, 1.0).numpy(),
                                  pedt.minplus_plain(f, 1.0).numpy())
    assert kernels.counts()["minplus"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        pedt.minplus_cuda(f, 1.0)
