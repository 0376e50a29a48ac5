"""The split watershed's options in the port against the JAX package, on
the CPU: the quantized priority flood (``seeded_watershed_flood``), the
per-slice watershed (``seeded_watershed_batched``), the size filter's
``per_slice``/``connectivity``, non-maximum suppression, and
``run_ws_block`` / ``run_ws_block_host`` / the streamed pipeline with
``apply_ws_2d``, ``non_maximum_suppression``, ``ws_algorithm: "flood"``
and ``impl: "host"`` (``tests/test_torch_ws_seeds_agglo.py`` runs them
through ``WatershedWorkflow``).

Labels are integers computed by the same op sequence (the flood's level
quantization and tie rule included), so every comparison is exact.  The
float32 default height map (Gaussian-smoothed boundaries) gives identical
labels on these per-block instances too."""

import numpy as np
import pytest
import torch

from tests.test_torch_split import _instance, _mask, _uint8

torch.set_num_threads(2)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    import jax.numpy as jnp

    return None if a is None else jnp.asarray(a)


def _flood_instance(shape, seed, n_seeds=6):
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    h = ndimage.gaussian_filter(rng.rand(*shape), 1.5).astype("float32")
    s = np.zeros(shape, "int32")
    s.flat[rng.choice(h.size, n_seeds, replace=False)] = np.arange(
        1, n_seeds + 1)
    m = ndimage.gaussian_filter(rng.rand(*shape), 2) > 0.45
    return h, s, m


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("full", [False, True], ids=["conn1", "connfull"])
@pytest.mark.parametrize("shape", [(30, 28), (10, 18, 16)],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("max_iter", [0, 5], ids=["unbounded", "bound5"])
def test_seeded_watershed_flood_matches_jax(shape, full, masked, max_iter):
    """Identical labels, also where ``max_iter`` stops the flood early
    (the gated extra bodies and the backstop fill)."""
    from cluster_tools_tpu.ops.watershed import seeded_watershed_flood as jf

    from cluster_tools_tpu_torch.ops.watershed import seeded_watershed_flood

    h, s, m = _flood_instance(shape, len(shape) + int(full))
    conn = len(shape) if full else 1
    mask = m if masked else None
    got = seeded_watershed_flood(_t(h), _t(s), _t(mask), conn, max_iter)
    want = np.asarray(jf(_j(h), _j(s), _j(mask), conn, max_iter))
    np.testing.assert_array_equal(got.numpy(), want)
    if max_iter == 0:
        assert (got.numpy()[m if masked else np.ones(shape, bool)] > 0).all()


def test_seeded_watershed_method_dispatch():
    from cluster_tools_tpu_torch.ops.watershed import (
        seeded_watershed, seeded_watershed_flood)

    h, s, _ = _flood_instance((12, 14), 0)
    np.testing.assert_array_equal(
        seeded_watershed(_t(h), _t(s), method="flood").numpy(),
        seeded_watershed_flood(_t(h), _t(s)).numpy())
    with pytest.raises(ValueError, match="unknown watershed method"):
        seeded_watershed(_t(h), _t(s), method="nope")


@pytest.mark.parametrize("method", ["basins", "flood"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_seeded_watershed_batched_matches_jax(method, masked, kind):
    """Each slice solved alone (its linear indices from 0), as JAX's
    ``vmap`` does; the noise heights overflow the natural capacities of
    the port's one basins solve over the stack (its exact-capacity
    re-run), and some of their slices have no seed."""
    from cluster_tools_tpu.ops.watershed import seeded_watershed_batched as jb

    from cluster_tools_tpu_torch.ops.watershed import \
        seeded_watershed_batched

    h, s, m = _flood_instance((5, 20, 22), 7, n_seeds=20)
    if kind == "noise":
        h = np.random.RandomState(1).rand(4, 130, 130).astype("float32")
        s = np.zeros(h.shape, "int32")
        s[1, 3, 4], s[1, 115, 9], s[3, 60, 100] = 1, 2, 3
        m = np.random.RandomState(2).rand(*h.shape) > 0.2
    mask = m if masked else None
    got = seeded_watershed_batched(_t(h), _t(s), _t(mask), 1, method=method)
    want = np.asarray(jb(_j(h), _j(s), _j(mask), 1, method=method))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_slice", [False, True], ids=["3d", "slices"])
@pytest.mark.parametrize("conn", [1, 2])
def test_size_filter_matches_jax(per_slice, conn):
    from cluster_tools_tpu.ops.watershed import size_filter as jsf

    from cluster_tools_tpu_torch.ops.watershed import size_filter

    h, _, m = _flood_instance((6, 24, 20), 3)
    rng = np.random.RandomState(conn)
    labels = rng.randint(0, 40, h.shape).astype("uint64") * 1000
    got = size_filter(labels, _t(h), 30, mask=_t(m), connectivity=conn,
                      per_slice=per_slice)
    want = jsf(labels, h, 30, mask=m, connectivity=conn, per_slice=per_slice)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == labels.dtype


@pytest.mark.parametrize("seed", range(3))
def test_suppress_maxima_matches_jax(seed):
    from cluster_tools_tpu.workflows.watershed import suppress_maxima as js

    from cluster_tools_tpu_torch.workflows.watershed import suppress_maxima

    rng = np.random.RandomState(seed)
    pts = rng.randint(0, 30, (60, 3))
    radii = rng.randint(1, 6, 60).astype("float32")  # ties on purpose
    np.testing.assert_array_equal(suppress_maxima(pts, radii),
                                  js(pts, radii))
    assert len(suppress_maxima(pts[:0], radii[:0])) == 0


_BLOCK_CFGS = {
    "ws_2d": {"apply_ws_2d": True},
    "nms": {"non_maximum_suppression": True},
    "flood": {"ws_algorithm": "flood"},
    "flood_unfiltered": {"ws_algorithm": "flood", "size_filter": 0},
    "host": {"impl": "host"},
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name", sorted(_BLOCK_CFGS))
def test_run_ws_block_options_match_jax(name, dtype, masked):
    from cluster_tools_tpu.workflows import watershed as jw

    from cluster_tools_tpu_torch.workflows import watershed as pw

    x = _instance((16, 32, 30), seed=1)
    if dtype == "uint8":
        x = _uint8(x).astype("float32") / 255.0
    mask = _mask(x.shape).astype(bool) if masked else None
    cfg = {"threshold": 0.4, "size_filter": 25, **_BLOCK_CFGS[name]}
    if name == "host":
        got = pw.run_ws_block_host(x, cfg, mask)
        want = jw.run_ws_block_host(x, cfg, mask)
    else:
        got = pw.run_ws_block(x, cfg, mask, device="cpu")
        want = jw.run_ws_block(x, cfg, mask)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint64 and len(np.unique(got)) > 5


@pytest.mark.parametrize("fuse", [False, True], ids=["host_filter",
                                                     "fused_filter"])
def test_stream_flood_matches_jax(fuse):
    """The streamed pipeline with ``ws_algorithm: "flood"``: the host size
    filter (the CPU default) and the fused flood size filter."""
    from cluster_tools_tpu.workflows import watershed as jw

    from cluster_tools_tpu_torch.workflows import watershed as pw

    x = _instance((14, 28, 26), seed=2)
    blocks = [x, _uint8(x)]
    cfg = {"threshold": 0.4, "size_filter": 25, "ws_algorithm": "flood",
           "fuse_size_filter": fuse}
    got = pw.run_ws_blocks_stream(blocks, cfg, device="cpu")
    want = jw.run_ws_blocks_stream(blocks, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
