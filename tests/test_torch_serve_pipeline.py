"""The port's FusedROIPipeline (cluster_tools_tpu_torch/core/server.py)
against the JAX package's, and on the port's resident server.

The same seeded ROI volumes (tests/test_server.py's voronoi boundaries,
``(16, 64, 64)`` uint8 in ``(8, 32, 32)`` blocks with a ``(2, 8, 8)``
halo) go through both pipelines' ``prepare`` / ``run_block`` /
``finalize`` with no server.  With ``sigma_weights: 0`` every block's
fragment count, dense labels and edge list, and the segmentation, are
identical and the edge features agree to 1e-6; with the default config
the float32 Gaussian's tap order (ROADMAP §C) moves a few voxels, so
fragments and segmentation are held to VOI <= 0.01.  Both packages'
per-block host fallback gives identical results on the same block.  The
JAX pipelines build one XLA program per config, once per module.
"""

import json

import numpy as np
import pytest
from scipy.spatial import cKDTree

from cluster_tools_tpu_torch.core import telemetry as port_telemetry
from cluster_tools_tpu_torch.core.server import (FusedROIPipeline,
                                                 ResidentSegmentationServer)

SHAPE = (16, 64, 64)
GEOM = dict(block_shape=(8, 32, 32), halo=(2, 8, 8))
SW0 = {"sigma_weights": 0.0}
VOI_GATE = 0.01


@pytest.fixture(autouse=True)
def _port_telemetry_reset():
    yield
    port_telemetry.reset()


def make_vol(seed, shape=SHAPE):
    """tests/test_server.py's ROI volume: smooth voronoi boundaries as
    uint8, and the cells as ground truth."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(8, 3) * np.array(shape)).astype("float32")
    tree = cKDTree(pts)
    grids = np.meshgrid(*[np.arange(s, dtype="float32") for s in shape],
                        indexing="ij")
    d, idx = tree.query(np.stack([g.ravel() for g in grids], 1), k=2)
    bnd = np.exp(-0.5 * ((d[:, 1] - d[:, 0]) / 2.0) ** 2)
    return (np.round(bnd * 255).astype("uint8").reshape(shape),
            (idx[:, 0] + 1).reshape(shape).astype("uint64"))


def _run(pipe, volume):
    """Direct prepare -> run_block x n -> finalize; returns the block
    results and the final result."""
    ctx = pipe.prepare(volume)
    blocks = [pipe.run_block(ctx, bid) for bid in range(pipe.n_blocks)]
    return blocks, pipe.finalize(ctx, blocks)


def _fragments(pipe, blocks):
    """The request's fragment volume, assembled as ``finalize`` does."""
    frag = np.zeros(pipe.volume_shape, "uint32")
    off = 0
    for bid, (k_i, dense, _, _) in enumerate(blocks):
        out = dense.astype("uint32")
        out[out > 0] += np.uint32(off)
        frag[pipe.blocking.get_block(bid).bb] = out
        off += k_i
    return frag


def voi(a, b):
    from cluster_tools_tpu_torch.utils.validation import \
        variation_of_information

    return sum(variation_of_information(a.astype("uint64"),
                                        b.astype("uint64")))


@pytest.fixture(scope="module")
def jax_pipes():
    """The JAX package's pipelines, one XLA build each, shared by the
    module."""
    from cluster_tools_tpu.core.server import FusedROIPipeline as JaxPipe

    return {"sw0": JaxPipe(SHAPE, config=SW0, **GEOM),
            "default": JaxPipe(SHAPE, **GEOM)}


@pytest.mark.parametrize("seed", [0, 3])
def test_uint8_sigma_weights_0_is_identical_to_jax(jax_pipes, seed):
    vol, _ = make_vol(seed)
    j_blocks, j_res = _run(jax_pipes["sw0"], vol)
    port = FusedROIPipeline(SHAPE, config=SW0, device="cpu", **GEOM)
    p_blocks, p_res = _run(port, vol)
    assert len(p_blocks) == len(j_blocks) == 8
    for bid, (pb, jb) in enumerate(zip(p_blocks, j_blocks)):
        pk, pdense, puv, pfeats = pb
        jk, jdense, juv, jfeats = jb
        assert pk == jk, bid
        np.testing.assert_array_equal(pdense, jdense)
        np.testing.assert_array_equal(puv, juv)
        np.testing.assert_allclose(pfeats, jfeats, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p_res["segmentation"],
                                  j_res["segmentation"])
    for key in ("n_fragments", "n_segments", "n_edges"):
        assert p_res[key] == j_res[key], key
    assert p_res["n_segments"] >= 2


def test_default_config_within_voi_of_jax(jax_pipes):
    vol, _ = make_vol(1)
    j_blocks, j_res = _run(jax_pipes["default"], vol)
    port = FusedROIPipeline(SHAPE, device="cpu", **GEOM)
    p_blocks, p_res = _run(port, vol)
    v_frag = voi(_fragments(port, p_blocks),
                 _fragments(jax_pipes["default"], j_blocks))
    v_seg = voi(p_res["segmentation"], j_res["segmentation"])
    assert v_frag <= VOI_GATE, v_frag
    assert v_seg <= VOI_GATE, v_seg


def test_host_block_fallback_is_identical_to_jax(jax_pipes):
    """The block redo taken when the coarse watershed reports a capacity
    overflow, run by both packages on the same outer block."""
    from cluster_tools_tpu.workflows.fused_pipeline import \
        _host_block_fallback as jax_fallback
    from cluster_tools_tpu_torch.workflows.fused_pipeline import \
        _host_block_fallback as port_fallback

    vol, _ = make_vol(2)
    port = FusedROIPipeline(SHAPE, config=SW0, device="cpu", **GEOM)
    ctx = port.prepare(vol)
    block = port.blocking.get_block(5)
    outer = tuple(slice(b, b + o) for b, o in
                  zip(block.begin, port.outer_shape))
    data = ctx["volp"][outer]
    p_dense, p_uv, p_feats, p_k = port_fallback(data, dict(port.cfg),
                                                port.halo, block,
                                                device="cpu")
    j_dense, j_uv, j_feats, j_k = jax_fallback(data, dict(port.cfg),
                                               port.halo, block)
    assert p_k == j_k > 1
    np.testing.assert_array_equal(p_dense, j_dense)
    np.testing.assert_array_equal(p_uv, j_uv)
    np.testing.assert_array_equal(p_feats, j_feats)


def test_server_on_the_port_pipeline(tmp_path):
    """Tenants interleave uint8 and float32 requests at block granularity
    on the port's server: each answer equals the pipeline's direct run of
    the same volume (the parameters live in the request's context, so a
    float32 request cannot switch a uint8 request's), every request is
    warm (the libraries resolve as cache hits, nothing compiles) with one
    ``sync-execute`` per block, and the segmentations are sane."""
    from cluster_tools_tpu_torch.utils.validation import (
        ContingencyTable, cremi_score_from_table)

    pipe = FusedROIPipeline(SHAPE, config=SW0, device="cpu", **GEOM)
    pipe.ensure_compiled()
    reqs = []
    for seed, tenant in enumerate(["alice", "bob"]):
        vol, gt = make_vol(seed + 4)
        if tenant == "bob":
            vol = vol.astype("float32") / 255.0
        reqs.append((tenant, vol, gt))
    with ResidentSegmentationServer(str(tmp_path), pipe) as srv:
        handles = [srv.submit(t, v) for t, v, _ in reqs]
        assert srv.drain(timeout=300)
    for (tenant, vol, gt), h in zip(reqs, handles):
        res = h.result(1)
        _, direct = _run(pipe, vol)
        np.testing.assert_array_equal(res["segmentation"],
                                      direct["segmentation"])
        with open(h.status_path) as f:
            status = json.load(f)
        assert status["state"] == "done" and status["tenant"] == tenant
        # ``hits`` only records the resolution; warm is no compile and
        # no load from ``_build/``
        assert status["exec_cache"].get("compiles", 0) == 0
        assert status["exec_cache"].get("disk_hits", 0) == 0
        assert status["exec_cache"].get("hits", 0) >= 1
        assert status["stage_counts"]["sync-execute"] == pipe.n_blocks
        assert status["stage_counts"]["h2d-upload"] == 1
        table = ContingencyTable.from_arrays_chunked(
            gt, res["segmentation"].astype("uint64"))
        assert cremi_score_from_table(table)[2] < 0.2
        assert res["n_segments"] >= 2


def test_pipeline_defaults_to_the_card_and_checks_the_roi():
    import torch

    pipe = FusedROIPipeline(SHAPE, device="cpu", **GEOM)
    with pytest.raises(ValueError, match="ROI geometry"):
        pipe.prepare(np.zeros((8, 64, 64), "uint8"))
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedROIPipeline(SHAPE, **GEOM)
