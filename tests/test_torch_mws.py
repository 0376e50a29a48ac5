"""The mutex watershed of the port against the JAX package, on the CPU.

* ops: the device-sorted edge stream is bitwise equal to the JAX
  package's (unseeded and seeded, strides 1 and 2, uint8-quantized
  affinities with many ties); the host and device grid-edge extraction,
  the segmentation (with and without seeds, with the seed assignments)
  and ``compact_seeds_int32`` give identical results; the 2^29
  packed-edge guard raises;
* workflows: ``MwsWorkflow`` and ``TwoPassMwsWorkflow`` through the port
  (device "cpu", target "gpu") and through the JAX package (target "tpu"
  on the CPU) on the same store write identical uint64 volumes — uint8
  affinities, float affinities whose max exceeds 1 (volume-global
  normalization), a mask (host path) and ``impl`` pinned to ``device`` on
  both sides;
* the random paths (``noise_level``, ``randomize_strides``) draw from a
  ``torch.Generator`` and cannot reproduce the JAX package's PRNG bits;
  they are held to their properties: the same seed gives the same labels,
  the noise stays inside its range, and the mutex density is
  ``1/prod(strides)`` within five standard deviations.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cluster_tools_tpu.ops import mws as jmws  # noqa: E402
from cluster_tools_tpu_torch.models.unet import DEFAULT_OFFSETS  # noqa: E402
from cluster_tools_tpu_torch.ops import mws as pmws  # noqa: E402

OFFSETS = [list(o) for o in DEFAULT_OFFSETS]
#: every outer block is at least 28 wide in y and x, longer than the
#: longest offset (27): the JAX package's device path cannot take a
#: shorter one (test_offsets_longer_than_the_block)
SHAPE = (20, 48, 48)
BLOCK = [10, 24, 24]
HALO = [2, 4, 4]


def _voronoi(shape, n_cells, seed):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n_cells, 3) * np.array(shape)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    coords = np.stack([g.ravel() for g in grids], 1).astype("float32")
    d = ((coords[:, None, :] - pts[None]) ** 2).sum(-1)
    return (d.argmin(1) + 1).reshape(shape).astype("uint64")


def _affs(gt, offsets=OFFSETS, seed=0, noise=0.05):
    """Affinities of a ground truth (the JAX bench's recipe,
    bench_configs.py:68-79): 0.9 inside a segment, 0.05 across, plus
    uniform noise, clipped to [0, 1]."""
    rng = np.random.RandomState(seed)
    affs = np.full((len(offsets),) + gt.shape, 0.05, dtype="float32")
    for c, off in enumerate(offsets):
        sl_a, sl_b = pmws._offset_slices(off, gt.shape)
        affs[c][sl_a] = np.where(gt[sl_a] == gt[sl_b], 0.9, 0.05)
    affs += (rng.rand(*affs.shape).astype("float32") - 0.5) * 2 * noise
    return np.clip(affs, 0.0, 1.0)


def _u8(affs):
    return np.round(affs * 255).astype("uint8")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _seeds(shape, seed):
    """Seed ids on about half of the voxels (0 elsewhere)."""
    rng = np.random.RandomState(seed)
    gt = _voronoi(shape, 6, seed).astype("int32")
    return np.where(rng.rand(*shape) < 0.5, gt, 0).astype("int32")


@pytest.mark.parametrize("strides", [[1, 1, 1], [2, 2, 2]])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_sorted_edges_bitwise(strides, seeded, quantized):
    shape = (8, 30, 32)
    affs = _affs(_voronoi(shape, 8, 1))
    if quantized:  # 1/255 steps: ties everywhere
        affs = _u8(affs).astype("float32") / 255
    affs[0, 2:4] = 0.0     # zero attractive edges are dropped
    affs[5, :, 3:5] = 1.0  # mutex edges of weight 1 - 1 = 0
    seeds = _seeds(shape, 2) if seeded else None
    ju, jv = jmws._sorted_edges_device(
        jnp.asarray(affs),
        jnp.asarray(seeds) if seeded else jnp.zeros((1, 1, 1), jnp.int32),
        tuple(tuple(o) for o in OFFSETS), tuple(strides), seeded)
    pu, pv = pmws._sorted_edges_device(
        torch.from_numpy(affs), None if seeds is None else
        torch.from_numpy(seeds), OFFSETS, strides)
    assert pu.dtype == pv.dtype == torch.int32
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_sorted_edges_resident_matches_jax():
    """The resident variant slices the outer window of a volume: the
    same stream and affinity sum as the JAX package's dynamic slice."""
    affs = _u8(_affs(_voronoi((12, 40, 36), 9, 3))).astype("float32") / 255
    origin, outer = (2, 5, 4), (8, 30, 29)
    seeds = _seeds(outer, 4).astype("uint64") + np.uint64(3 << 31)
    seeds[seeds == np.uint64(3 << 31)] = 0
    j = jmws._sorted_edges_resident(jnp.asarray(affs), origin, outer,
                                    OFFSETS, [1, 1, 1], seeds)
    p = pmws._sorted_edges_resident(torch.from_numpy(affs), origin, outer,
                                    OFFSETS, [1, 1, 1], seeds)
    for a, b in zip(p[:2], j[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # float32 sums of ~10^5 terms in another order (used only to skip
    # all-zero blocks)
    assert float(p[2]) == pytest.approx(float(j[2]), rel=1e-3)
    # the scans of both streams give the same labels
    np.testing.assert_array_equal(
        pmws.mutex_watershed_scan_sorted(p[0].numpy(), p[1].numpy(), outer),
        jmws.mutex_watershed_scan_sorted(np.asarray(j[0]), np.asarray(j[1]),
                                         outer))


def test_packed_edge_guard_raises():
    vol = torch.zeros((1, 1, 1, 1))
    with pytest.raises(ValueError, match="2\\^29"):
        pmws._sorted_edges_resident(vol, (0, 0, 0), (512, 1024, 1024),
                                    OFFSETS[:1], [1, 1, 1])


def test_compact_seeds_int32_above_2_31():
    rng = np.random.RandomState(0)
    ids = np.array([0, 5, 1 << 31, (1 << 31) + 7, (1 << 40) + 1,
                    (7 << 32) + 5], dtype="uint64")
    seeds = ids[rng.randint(0, len(ids), (6, 7, 8))]
    got = pmws.compact_seeds_int32(seeds)
    np.testing.assert_array_equal(got, jmws.compact_seeds_int32(seeds))
    assert got.dtype == np.int32
    # equality preserved, zero kept, nothing else maps to zero
    pairs = np.unique(np.stack([seeds.ravel(), got.ravel()]), axis=1)
    assert len(np.unique(pairs[0])) == len(np.unique(pairs[1])) \
        == pairs.shape[1]
    assert ((got == 0) == (seeds == 0)).all()
    no_zero = seeds[seeds != 0][:50].reshape(5, 10)
    assert (pmws.compact_seeds_int32(no_zero) != 0).all()
    np.testing.assert_array_equal(pmws.compact_seeds_int32(no_zero),
                                  jmws.compact_seeds_int32(no_zero))


@pytest.mark.parametrize("impl", ["host", "device"])
def test_grid_graph_edges_match_jax(impl):
    """Deterministic cases (the pattern of
    tests/test_mutex_watershed.py::test_grid_graph_edges_host_matches_device):
    strides and a (non-bool) mask."""
    affs = _affs(_voronoi((10, 30, 30), 7, 5))
    mask = np.zeros(affs.shape[1:], np.uint8)
    mask[1:9, 2:28, 1:27] = 1
    for kw in ({}, {"strides": [2, 2, 2], "mask": mask},
               {"strides": [1, 3, 3], "id_offset": 1000}):
        got = pmws.grid_graph_edges(affs, OFFSETS, impl=impl, device="cpu",
                                    **kw)
        want = jmws.grid_graph_edges(affs, OFFSETS, impl=impl, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seeded", [False, True])
def test_segmentation_matches_jax(seeded):
    affs = _affs(_voronoi((10, 32, 32), 6, 7))
    seeds = _seeds(affs.shape[1:], 8).astype("uint64") if seeded else None
    for kw in ({}, {"strides": [2, 2, 2]}):
        got = pmws.mutex_watershed_segmentation(
            affs, OFFSETS, seeds=seeds, return_seed_assignments=True,
            device="cpu", **kw)
        want = jmws.mutex_watershed_segmentation(
            affs, OFFSETS, seeds=seeds, return_seed_assignments=True, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (len(got[1]) > 0) == seeded
    mask = np.ones(affs.shape[1:], bool)
    mask[:, :5] = False
    np.testing.assert_array_equal(
        pmws.mutex_watershed_segmentation(affs, OFFSETS, mask=mask,
                                          seeds=seeds, device="cpu"),
        jmws.mutex_watershed_segmentation(affs, OFFSETS, mask=mask,
                                          seeds=seeds))


def test_sorted_scan_matches_host_segmentation():
    """The device-sorted stream, scanned on the host, gives the host
    Kruskal's labels exactly (same priorities, tie order and drops)."""
    affs = _u8(_affs(_voronoi((10, 32, 32), 6, 9))).astype("float32") / 255
    u, vp = pmws._sorted_edges_device(torch.from_numpy(affs), None, OFFSETS,
                                      [2, 2, 2])
    labels, asum = pmws.mutex_watershed_finalize_sorted(
        (u, vp), affs.shape[1:], asum=torch.tensor(1.0))
    np.testing.assert_array_equal(
        labels, pmws.mutex_watershed_segmentation(affs, OFFSETS,
                                                  strides=[2, 2, 2],
                                                  device="cpu"))
    assert asum == 1.0
    assert pmws.mutex_watershed_finalize_sorted(
        (u, vp), affs.shape[1:], asum=torch.tensor(0.0)) == (None, 0.0)


# ---------------------------------------------------------------------------
# the random paths, by properties
# ---------------------------------------------------------------------------

def test_randomized_strides_density_and_determinism():
    affs = _affs(_voronoi((12, 40, 40), 8, 11))
    strides = [2, 2, 2]
    n_cand = sum(int(np.prod([s - abs(o) for s, o in zip(affs.shape[1:],
                                                            off)]))
                 for off in OFFSETS[3:])
    first = pmws.grid_graph_edges(affs, OFFSETS, strides=strides,
                                  randomize_strides=True, seed=3,
                                  device="cpu")
    again = pmws.grid_graph_edges(affs, OFFSETS, strides=strides,
                                  randomize_strides=True, seed=3,
                                  device="cpu")
    other = pmws.grid_graph_edges(affs, OFFSETS, strides=strides,
                                  randomize_strides=True, seed=4,
                                  device="cpu")
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[2], other[2])
    p = 1.0 / np.prod(strides)
    n_mutex = len(first[2])
    assert abs(n_mutex - p * n_cand) < 5 * np.sqrt(n_cand * p * (1 - p))
    # the attractive edges are all kept, as in the JAX package
    want = jmws.grid_graph_edges(affs, OFFSETS, strides=strides, impl="host")
    np.testing.assert_array_equal(first[0], want[0])
    np.testing.assert_array_equal(first[1], want[1])
    seg = pmws.mutex_watershed_segmentation(
        affs, OFFSETS, strides=strides, randomize_strides=True, seed=3,
        device="cpu")
    np.testing.assert_array_equal(seg, pmws.mutex_watershed_segmentation(
        affs, OFFSETS, strides=strides, randomize_strides=True, seed=3,
        device="cpu"))


def test_noise_range_and_determinism():
    affs = _affs(_voronoi((10, 32, 32), 6, 12))
    level = 0.05
    clean = pmws.grid_graph_edges(affs, OFFSETS, impl="host")
    noisy = pmws.grid_graph_edges(affs, OFFSETS, noise_level=level, seed=5,
                                  device="cpu")
    np.testing.assert_array_equal(noisy[0], clean[0])
    np.testing.assert_array_equal(noisy[2], clean[2])
    da, dm = noisy[1] - clean[1], noisy[3] - clean[3]
    tol = 1e-6
    assert da.min() >= -tol and da.max() < level + tol
    assert dm.max() <= tol and dm.min() > -level - tol
    assert da.std() > level / 4  # uniform on [0, level): std = level/sqrt(12)
    kw = dict(noise_level=level, seed=5, device="cpu")
    np.testing.assert_array_equal(
        pmws.mutex_watershed_segmentation(affs, OFFSETS, **kw),
        pmws.mutex_watershed_segmentation(affs, OFFSETS, **kw))


# ---------------------------------------------------------------------------
# workflows
# ---------------------------------------------------------------------------

def _run(pkg, root, data, two_pass, mask=None, task_cfg=None):
    """Run ``MwsWorkflow`` (or ``TwoPassMwsWorkflow``) of ``pkg`` on the
    affinities ``data``; returns the output volume."""
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows.mutex_watershed import (
            MwsWorkflow, TwoPassMwsWorkflow)
        target, extra = "tpu", {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        MwsWorkflow, TwoPassMwsWorkflow = M.MwsWorkflow, M.TwoPassMwsWorkflow
        target, extra = "gpu", {"device": "cpu"}
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with M.file_reader(path) as f:
        f.require_dataset("affs", shape=data.shape, chunks=[1] + BLOCK,
                          dtype=data.dtype)[:] = data
        if mask is not None:
            f.require_dataset("mask", shape=mask.shape, chunks=BLOCK,
                              dtype=mask.dtype)[:] = mask
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK, **extra})
    for name in ("mws_blocks", "mws_pass1", "mws_pass2"):
        ConfigDir(cfg).write_task_config(name, task_cfg or {})
    kw = dict(input_path=path, input_key="affs", output_path=path,
              output_key="seg", offsets=OFFSETS, halo=HALO,
              tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
              max_jobs=2, target=target,
              mask_path=path if mask is not None else "",
              mask_key="mask" if mask is not None else "")
    wf = (TwoPassMwsWorkflow if two_pass else MwsWorkflow)(**kw)
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return f["seg"][:]


def _mask(shape):
    m = np.ones(shape, "uint8")
    m[:, :, :6] = 0
    m[12:, 30:, 20:] = 0
    return m


GT = _voronoi(SHAPE, 14, 21)
CASES = {
    "uint8": (_u8(_affs(GT)), None, None),
    "float_over_1": (_affs(GT, seed=1) * 3.0, None, {"impl": "host"}),
    "mask": (_u8(_affs(GT, seed=2)), _mask(SHAPE), None),
    "impl_device": (_u8(_affs(GT, seed=3)), None, {"impl": "device"}),
}


@pytest.mark.parametrize("two_pass", [False, True],
                         ids=["single", "two_pass"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_workflow_matches_jax(tmp_path, case, two_pass):
    data, mask, task_cfg = CASES[case]
    jx = _run("jax", str(tmp_path / "jax"), data, two_pass, mask, task_cfg)
    pt = _run("torch", str(tmp_path / "torch"), data, two_pass, mask,
              task_cfg)
    assert pt.dtype == jx.dtype == np.uint64
    np.testing.assert_array_equal(pt, jx)
    u = np.unique(pt)
    assert u[-1] == len(u) - (u[0] == 0)  # consecutive after the relabel
    if mask is not None:
        assert (pt[mask == 0] == 0).all() and (pt[mask != 0] > 0).all()


def test_workflow_device_path_matches_host_path(tmp_path):
    """Within the port: impl device (the card's path, which normalizes
    the whole volume at once) and impl host (per block, by the
    volume-global max) give the same two-pass labels on the CPU device,
    on float affinities whose max exceeds 1."""
    data = _affs(GT, seed=4) * 3.0
    dev = _run("torch", str(tmp_path / "d"), data, True,
               task_cfg={"impl": "device"})
    host = _run("torch", str(tmp_path / "h"), data, True,
                task_cfg={"impl": "host"})
    np.testing.assert_array_equal(dev, host)


def test_offsets_longer_than_the_block(tmp_path):
    """A border block narrower than an offset gets no edges of that
    channel on either path of the port (the JAX package's host path
    agrees; its device path fails to concatenate slices of different
    lengths there)."""
    affs = _affs(_voronoi((6, 30, 20), 5, 13))
    u, vp = pmws._sorted_edges_device(torch.from_numpy(affs), None, OFFSETS,
                                      [1, 1, 1])
    np.testing.assert_array_equal(
        pmws.mutex_watershed_scan_sorted(u.numpy(), vp.numpy(),
                                         affs.shape[1:]),
        jmws.mutex_watershed_segmentation(affs, OFFSETS))
    for g, w in zip(pmws.grid_graph_edges(affs, OFFSETS, impl="device",
                                          device="cpu"),
                    jmws.grid_graph_edges(affs, OFFSETS, impl="host")):
        np.testing.assert_array_equal(g, w)
    data = _u8(_affs(_voronoi((20, 48, 40), 12, 14)))
    dev = _run("torch", str(tmp_path / "d"), data, True,
               task_cfg={"impl": "device"})
    host = _run("torch", str(tmp_path / "h"), data, True,
                task_cfg={"impl": "host"})
    np.testing.assert_array_equal(dev, host)


def test_workflow_noise_is_deterministic(tmp_path):
    data = _u8(_affs(GT, seed=5))
    cfg = {"noise_level": 0.02, "randomize_strides": True,
           "strides": [1, 2, 2]}
    a = _run("torch", str(tmp_path / "a"), data, False, task_cfg=cfg)
    b = _run("torch", str(tmp_path / "b"), data, False, task_cfg=cfg)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 1


def test_device_impl_refuses_a_mask(tmp_path):
    from cluster_tools_tpu_torch.core.runtime import FailedJobsError

    with pytest.raises((ValueError, FailedJobsError, RuntimeError)):
        _run("torch", str(tmp_path), _u8(_affs(GT)), False,
             mask=_mask(SHAPE), task_cfg={"impl": "device"})
