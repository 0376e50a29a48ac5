"""The filter bank of the port (``ops/filters.py``: Gaussian, gradient
magnitude and Laplacian of Gaussian, the min/max box filters, the by-name
dispatch) and its signed distance transform against the JAX package, on
the CPU.

The taps are the same float32 numbers; the port sums them as shifted
multiply-adds, XLA's CPU convolution in another order, so responses are
held at rtol 1e-4 / atol 1e-5 (the JAX package's own tolerance for the
filter-bank features, ``tests/test_graph_stack.py``).  The box filters
and the distance transforms are exact."""

import numpy as np
import pytest
import torch

FILTERS = ("gaussianSmoothing", "gaussianGradientMagnitude",
           "laplacianOfGaussian")
SIGMAS = (0.7, 1.6, 3.5)


def _volume(shape=(12, 20, 18), seed=0):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_kernel_taps_equal_jax(order, sigma):
    from cluster_tools_tpu.ops.filters import _gaussian_kernel as jk

    from cluster_tools_tpu_torch.ops.filters import _gaussian_kernel as pk

    np.testing.assert_array_equal(pk(sigma, order), jk(sigma, order))


def test_unsupported_derivative_order_raises():
    from cluster_tools_tpu_torch.ops.filters import _gaussian_kernel

    with pytest.raises(ValueError, match="derivative order"):
        _gaussian_kernel(1.0, 3)


@pytest.mark.parametrize("name", FILTERS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_apply_filter_matches_jax(name, sigma):
    import jax.numpy as jnp
    from cluster_tools_tpu.ops.filters import apply_filter as japply

    from cluster_tools_tpu_torch.ops.filters import apply_filter

    x = _volume(seed=int(10 * sigma))
    want = np.asarray(japply(jnp.asarray(x), name, sigma))
    got = apply_filter(torch.from_numpy(x), name, sigma).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", FILTERS)
def test_apply_filter_per_axis_sigma(name):
    """A per-axis sigma stays per axis for the Gaussian and is averaged
    by the derivative filters, as in the JAX package; a 2-d input too."""
    import jax.numpy as jnp
    from cluster_tools_tpu.ops.filters import apply_filter as japply

    from cluster_tools_tpu_torch.ops.filters import apply_filter

    x = _volume(seed=3)
    sig = (0.5, 1.5, 2.0)
    np.testing.assert_allclose(
        apply_filter(torch.from_numpy(x), name, sig).numpy(),
        np.asarray(japply(jnp.asarray(x), name, sig)), rtol=1e-4, atol=1e-5)
    x2 = x[0]
    np.testing.assert_allclose(
        apply_filter(torch.from_numpy(x2), name, 1.2).numpy(),
        np.asarray(japply(jnp.asarray(x2), name, 1.2)), rtol=1e-4, atol=1e-5)


def test_unknown_filter_raises():
    from cluster_tools_tpu.ops.filters import FILTERS as JF

    from cluster_tools_tpu_torch.ops.filters import FILTERS as PF
    from cluster_tools_tpu_torch.ops.filters import apply_filter

    assert sorted(PF) == sorted(JF)
    with pytest.raises(ValueError, match="unknown filter"):
        apply_filter(torch.zeros(4, 4, 4), "hessianOfGaussian", 1.0)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("size", [3, 4, (1, 5, 5), (2, 3, 1)])
def test_rank_pool_matches_jax(mode, size):
    """Out-of-volume samples read +inf for the minimum and -inf for the
    maximum: exact on random values, an integer volume (ties) and odd and
    even windows."""
    import jax.numpy as jnp
    from cluster_tools_tpu.ops.filters import rank_pool as jpool

    from cluster_tools_tpu_torch.ops.filters import rank_pool

    for x in (_volume((9, 14, 11), seed=5),
              np.random.RandomState(6).randint(0, 4, (9, 14, 11)
                                               ).astype("float32")):
        want = np.asarray(jpool(jnp.asarray(x), size, mode))
        np.testing.assert_array_equal(
            rank_pool(torch.from_numpy(x), size, mode).numpy(), want)


def test_rank_pool_bad_mode_raises():
    from cluster_tools_tpu_torch.ops.filters import rank_pool

    with pytest.raises(ValueError):
        rank_pool(torch.from_numpy(_volume(seed=7)), 3, "median")


@pytest.mark.parametrize("sampling", [None, (2.0, 1.0, 1.0)])
def test_signed_distance_transform_matches_jax(sampling):
    import jax.numpy as jnp
    from cluster_tools_tpu.ops.edt import signed_distance_transform as jsdt

    from cluster_tools_tpu_torch.ops.edt import signed_distance_transform

    mask = np.random.RandomState(8).rand(10, 17, 13) > 0.6
    want = np.asarray(jsdt(jnp.asarray(mask), sampling))
    got = signed_distance_transform(torch.from_numpy(mask), sampling)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[mask] > 0).all() and (got.numpy()[~mask] < 0).all()
