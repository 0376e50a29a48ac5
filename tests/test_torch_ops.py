"""The port's device ops (plain PyTorch on the CPU) against the JAX
package's on the same numpy inputs: filters, seed connected components,
the basin watershed, dense relabel, the RAG pair/statistics paths and
run-length coding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cluster_tools_tpu.ops import components as jc
from cluster_tools_tpu.ops import filters as jf
from cluster_tools_tpu.ops import rag as jr
from cluster_tools_tpu.ops import sweep as js
from cluster_tools_tpu.ops import watershed as jw
from cluster_tools_tpu.ops.edt import distance_transform_edt as jedt
from cluster_tools_tpu_torch.ops import components as pc
from cluster_tools_tpu_torch.ops import filters as pf
from cluster_tools_tpu_torch.ops import rag as pr
from cluster_tools_tpu_torch.ops import sweep as ps
from cluster_tools_tpu_torch.ops import watershed as pw

torch.set_num_threads(2)

SHAPE = (20, 36, 32)


def _boundary_volume(shape, n_cells, seed):
    """Smooth voronoi ridges (the fused-pipeline tests' instance)."""
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    pts = rng.rand(n_cells, 3) * np.array(shape)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    coords = np.stack([g.ravel() for g in grids], 1).astype("float32")
    d = np.sort(np.linalg.norm(coords[:, None] - pts[None], axis=2), axis=1)
    bnd = np.exp(-(d[:, 1] - d[:, 0]) ** 2 / 4.0).reshape(shape)
    return ndimage.gaussian_filter(bnd, 1.0).astype("float32")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref():
    """One JAX reference chain (EDT -> filters -> seeds -> height) on the
    test volume; the port's ops are fed the same intermediates."""
    x = _boundary_volume(SHAPE, n_cells=8, seed=3)
    fg = x < 0.4
    dt = np.asarray(jedt(jnp.asarray(fg)))
    hmap = np.asarray(jf.gaussian(jnp.asarray(x), 2.0))
    ds = np.asarray(jf.gaussian(jnp.asarray(dt), 2.0))
    maxima = np.asarray(jf.local_maxima(jnp.asarray(ds), radius=2)) & fg
    seeds = np.asarray(jc.connected_components(
        jnp.asarray(maxima), connectivity=3, method="propagation"))
    height = (0.8 * hmap + 0.2 * (1.0 - dt / max(dt.max(), 1e-6))).astype(
        "float32")
    return dict(x=x, fg=fg, dt=dt, hmap=hmap, ds=ds, maxima=maxima,
                seeds=seeds, height=height)


def test_gaussian_matches(ref):
    """Shifted multiply-adds vs XLA's convolution: the same taps summed in
    another order, so rtol 1e-5 / atol 1e-6 (a few float32 ulps)."""
    np.testing.assert_allclose(pf.gaussian(_t(ref["x"]), 2.0).numpy(),
                               ref["hmap"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pf.gaussian(_t(ref["dt"]), 2.0).numpy(),
                               ref["ds"], rtol=1e-5, atol=1e-6)


def test_local_maxima_exact(ref):
    got = pf.local_maxima(_t(ref["ds"]), radius=2).numpy() & ref["fg"]
    np.testing.assert_array_equal(got, ref["maxima"])


@pytest.mark.parametrize("connectivity", [1, 3])
def test_connected_components_propagation_exact(ref, connectivity):
    want = np.asarray(jc.connected_components(
        jnp.asarray(ref["maxima"]), connectivity=connectivity,
        method="propagation"))
    got = pc.connected_components(_t(ref["maxima"]), connectivity,
                                  method="propagation").numpy()
    np.testing.assert_array_equal(got, want)


def test_connected_components_iteration_bound():
    """A serpentine component longer than the body bound: both stop after
    exactly max_iter bodies with the same partial labels."""
    mask = np.zeros((1, 9, 40), bool)
    mask[0, ::2, :] = True
    mask[0, 1::4, -1] = True
    mask[0, 3::4, 0] = True
    want = np.asarray(jc.connected_components(
        jnp.asarray(mask), connectivity=1, max_iter=3, method="propagation"))
    got = pc.connected_components(_t(mask), 1, max_iter=3,
                                  method="propagation").numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2     # not converged: the bound held


@pytest.mark.parametrize("caps,min_size", [
    ((2048, 8192), 25),      # natural capacities: ok
    ((2048, 8192), 0),
    ((8, 16), 25),           # tiny capacities: ok is False
])
def test_basins_exact(ref, caps, min_size):
    lj, okj = jw._basins_impl(jnp.asarray(ref["height"]),
                              jnp.asarray(ref["seeds"]), None, 1, 64,
                              min_size, *caps)
    lp, okp = pw.basins(_t(ref["height"]), _t(ref["seeds"]), None, 1, 64,
                        min_size, *caps)
    assert bool(okp) == bool(okj)
    if caps[0] > 8:
        assert bool(okp)
    else:
        assert not bool(okp)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))


@pytest.mark.parametrize("factor,dense_ids", [(2, True), (2, False),
                                              (4, True)])
def test_coarse_exact(ref, factor, dense_ids):
    wj, okj = jw._coarse_impl(jnp.asarray(ref["height"]),
                              jnp.asarray(ref["seeds"]), 25, 3, factor,
                              dense_ids=dense_ids)
    wp, okp = pw.coarse(_t(ref["height"]), _t(ref["seeds"]), 25, 3, factor,
                        dense_ids=dense_ids)
    assert bool(okp) == bool(okj)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))


def test_dense_relabel_and_extent_mask_exact(ref):
    ws = np.asarray(jw._coarse_impl(jnp.asarray(ref["height"]),
                                    jnp.asarray(ref["seeds"]), 25, 3, 2,
                                    dense_ids=True)[0])
    inner = ws[2:-2, 4:-4, 4:-4]
    extent = (13, 25, 20)    # a clipped border block
    vj = jw.extent_valid_mask(inner.shape, extent=jnp.asarray(extent))
    vp = pw.extent_valid_mask(inner.shape, extent)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    bound = int(ws.max()) + 1
    dj, kj = jw.dense_relabel(jnp.asarray(inner), bound, valid=vj)
    dp, kp = pw.dense_relabel(_t(inner), bound, valid=vp)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    assert int(kp) == int(kj)


def _labels_and_map(ref, u8):
    ws = np.asarray(jw._coarse_impl(jnp.asarray(ref["height"]),
                                    jnp.asarray(ref["seeds"]), 25, 3, 2,
                                    dense_ids=True)[0])
    dense = np.asarray(jw.dense_relabel(jnp.asarray(ws),
                                        int(ws.max()) + 1)[0])
    bmap = (np.round(ref["x"] * 255).astype("uint8") if u8
            else ref["x"])
    return dense, bmap


def _compare_stats(uvp, fp, np_, ovp, uvj, fj, nj, ovj, n_mean_var_rtol):
    n = int(nj)
    assert int(np_) == n and int(ovp) == int(ovj) == 0
    uvp, fp = uvp.numpy()[:n], fp.numpy()[:n]
    uvj, fj = np.asarray(uvj)[:n], np.asarray(fj)[:n]
    np.testing.assert_array_equal(uvp, uvj)
    # min, quantiles, max, count: exact
    np.testing.assert_array_equal(fp[:, 2:], fj[:, 2:])
    np.testing.assert_allclose(fp[:, :2], fj[:, :2], rtol=n_mean_var_rtol,
                               atol=1e-7)


def test_uint8_pair_path_exact(ref):
    """boundary_pair_values_dual -> compact_valid -> packed histogram
    stats: uv, counts, min, max and quantiles exact; mean and variance
    rtol 1e-6 (the float32 ``hist @ levels`` dot sums in another order)."""
    dense, bmap = _labels_and_map(ref, u8=True)
    cap, e_max = 1 << 14, 4096
    uj, vj, aj, bj, okj = jr.boundary_pair_values_dual(jnp.asarray(dense),
                                                       jnp.asarray(bmap))
    (kj, vabj), cokj, covj = jr.compact_valid(
        okj, [uj * 32768 + vj,
              aj.astype(jnp.int32) * 256 + bj.astype(jnp.int32)], cap)
    outj = jr._edge_stats_hist_packed(kj, vabj, cokj, e_max=e_max)

    up, vp, ap, bp, okp = pr.boundary_pair_values_dual(_t(dense), _t(bmap))
    for a, b in zip((up, vp, ap, bp, okp), (uj, vj, aj, bj, okj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (kp, vabp), cokp, covp = pr.compact_valid(
        okp, [up * 32768 + vp, ap.to(torch.int32) * 256 + bp.to(torch.int32)],
        cap)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vabp.numpy(), np.asarray(vabj))
    np.testing.assert_array_equal(cokp.numpy(), np.asarray(cokj))
    assert int(covp) == int(covj) == 0
    outp = pr.edge_stats_hist_packed(kp, vabp, cokp, e_max=e_max)
    _compare_stats(*outp, *outj, n_mean_var_rtol=1e-6)


def test_float_pair_path(ref):
    """boundary_pair_values -> compact_valid -> sorted-position stats on
    float samples: uv, min, quantiles, max and counts exact; mean and
    variance rtol 1e-6 (segment sums in float32)."""
    dense, bmap = _labels_and_map(ref, u8=False)
    cap, e_max = 1 << 15, 4096
    uj, vj, xj, okj = jr.boundary_pair_values(jnp.asarray(dense),
                                              jnp.asarray(bmap))
    (cuj, cvj, cxj), cokj, _ = jr.compact_valid(okj, [uj, vj, xj], cap)
    outj = jr._edge_stats_device(cuj, cvj, cxj, cokj, e_max=e_max)
    up, vp, xp, okp = pr.boundary_pair_values(_t(dense), _t(bmap))
    (cup, cvp, cxp), cokp, _ = pr.compact_valid(okp, [up, vp, xp], cap)
    outp = pr.edge_stats_device(cup, cvp, cxp, cokp, e_max=e_max)
    _compare_stats(*outp, *outj, n_mean_var_rtol=1e-6)


def test_compact_valid_overflow_count():
    rng = np.random.RandomState(0)
    ok = rng.rand(5000) < 0.5
    x = rng.randint(0, 100, 5000).astype("int32")
    (cj,), cokj, ovj = jr.compact_valid(jnp.asarray(ok), [jnp.asarray(x)],
                                        1000)
    (cp,), cokp, ovp = pr.compact_valid(_t(ok), [_t(x)], 1000)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(cokp.numpy(), np.asarray(cokj))
    assert int(ovp) == int(ovj) > 0


@pytest.mark.parametrize("cap", [1 << 12, 64])
def test_rle_encode_decode_exact(ref, cap):
    dense, _ = _labels_and_map(ref, u8=True)
    flat = np.concatenate([dense.reshape(-1),
                           np.full(70000, 3, dense.dtype)])  # a >2^15 run
    pj, nj, okj = js.rle_encode_packed(jnp.asarray(flat), cap)
    pp, np_, okp = ps.rle_encode_packed(_t(flat), cap)
    assert int(np_) == int(nj) and bool(okp) == bool(okj)
    np.testing.assert_array_equal(pp.numpy().astype(np.uint32),
                                  np.asarray(pj))
    if okp:
        out = ps.rle_decode_packed(pp.numpy(), np_, flat.size)
        np.testing.assert_array_equal(out, flat)
        np.testing.assert_array_equal(
            out, js.rle_decode_packed(np.asarray(pj), int(nj), flat.size))
