"""Connected components of the port against the JAX package, on the CPU.

``method="hooking"`` (the default in both packages) and
``connected_components_batched`` give the JAX package's int32 labels
exactly — the component's minimum linear index + 1 — in 2-d and 3-d, at
connectivity 1, 2 and 3, on the worst-case snake and on batches of
ragged border blocks padded with background; ``relabel_consecutive`` and
``threshold_volume`` agree in every mode.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import components as jc
from cluster_tools_tpu_torch.ops import components as pc


def _snake(n=16):
    """The JAX package's worst case (tests/test_ops_components.py:37): one
    serpentine component of very long graph diameter."""
    mask = np.zeros((n, n), dtype=bool)
    for i in range(n):
        mask[i, :] = True
        if i + 1 < n:
            mask[i, -1 if i % 2 == 0 else 0] = True
    mask[1::2, 0] = False
    mask[0::2, n - 1] = True
    for i in range(0, n - 1):
        mask[i, n - 1 if i % 2 == 0 else 0] = True
    return mask


def _thin_snake(n=31):
    """A one-voxel-wide serpentine: every other row, joined at alternating
    ends."""
    mask = np.zeros((n, n), dtype=bool)
    mask[::2, :] = True
    mask[1::4, -1] = True
    mask[3::4, 0] = True
    return mask


def _jax(mask, connectivity=1):
    return np.asarray(jc.connected_components(
        jnp.asarray(mask), connectivity=connectivity, method="hooking"))


@pytest.mark.parametrize("shape,connectivity,density", [
    ((32, 32), 1, 0.6), ((32, 32), 2, 0.6), ((16, 16, 16), 1, 0.5),
    ((16, 16, 16), 2, 0.6), ((16, 16, 16), 3, 0.7), ((7, 45, 33), 1, 0.45),
])
def test_hooking_matches_jax(shape, connectivity, density):
    mask = np.random.RandomState(42).rand(*shape) > density
    got = pc.connected_components(torch.from_numpy(mask), connectivity,
                                  method="hooking")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax(mask, connectivity))


@pytest.mark.parametrize("make", [_snake, _thin_snake],
                         ids=["snake", "thin_snake"])
def test_hooking_worst_case_snake(make):
    mask = make()
    got, bodies = pc.connected_components(torch.from_numpy(mask),
                                          return_bodies=True)
    np.testing.assert_array_equal(got.numpy(), _jax(mask))
    assert len(np.unique(got.numpy())) == 2 and bodies >= 2


def test_default_method_is_hooking():
    """The port's default is the JAX package's: hooking, whose loop has
    no iteration bound (``max_iter`` bounds propagation only)."""
    default = inspect.signature(pc.connected_components).parameters[
        "method"].default
    assert default == inspect.signature(
        jc.connected_components).parameters["method"].default == "hooking"
    mask = _thin_snake()
    got = pc.connected_components(torch.from_numpy(mask), max_iter=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jc.connected_components(jnp.asarray(mask), max_iter=1)))
    assert len(np.unique(got.numpy())) == 2
    with pytest.raises(ValueError, match="unknown method"):
        pc.connected_components(torch.from_numpy(mask), method="flood")


@pytest.mark.parametrize("connectivity", [1, 3])
def test_batched_matches_jax_with_ragged_blocks(connectivity):
    """Blocks of a ragged grid padded with background to the uniform
    shape, as BlockComponents batches them: each block keeps its own
    linear indices."""
    rng = np.random.RandomState(7)
    bs = (10, 12, 9)
    masks = np.zeros((4,) + bs, bool)
    for i, ext in enumerate([(10, 12, 9), (10, 5, 9), (3, 12, 9),
                             (3, 5, 2)]):
        masks[(i,) + tuple(slice(0, e) for e in ext)] = \
            rng.rand(*ext) > 0.45
    want = np.asarray(jc.connected_components_batched(
        jnp.asarray(masks), connectivity=connectivity))
    got = pc.connected_components_batched(torch.from_numpy(masks),
                                          connectivity=connectivity)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(4):
        single = pc.connected_components(torch.from_numpy(masks[i]),
                                         connectivity)
        np.testing.assert_array_equal(got[i].numpy(), single.numpy())


@pytest.mark.parametrize("labels,start,keep_zeros", [
    (np.array([[0, 5, 5], [9, 0, 2]], "uint64"), 1, True),
    (np.array([[3, 5, 5], [9, 7, 2]], "uint64"), 1, True),
    (np.array([[0, 5, 5], [9, 0, 2]], "uint64"), 4, False),
    (np.zeros((3, 4), "uint64"), 1, True),
    (np.random.RandomState(0).randint(0, 2 ** 40, (6, 7)).astype("uint64"),
     2, True),
])
def test_relabel_consecutive_matches_jax(labels, start, keep_zeros):
    want, want_max = jc.relabel_consecutive(labels, start, keep_zeros)
    got, got_max = pc.relabel_consecutive(labels, start, keep_zeros)
    assert got.dtype == want.dtype and got_max == want_max
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["greater", "less", "equal"])
def test_threshold_volume_matches_jax(mode):
    x = np.round(np.random.RandomState(1).rand(5, 6, 7), 1).astype("float32")
    want = np.asarray(jc.threshold_volume(jnp.asarray(x), 0.5, mode))
    got = pc.threshold_volume(torch.from_numpy(x), 0.5, mode)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        pc.threshold_volume(torch.from_numpy(x), 0.5, "bogus")
