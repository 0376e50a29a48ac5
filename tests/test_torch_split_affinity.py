"""The split chain on affinity maps: ``WatershedWorkflow`` (channels
averaged into the boundary evidence) -> ``MulticutSegmentationWorkflow(
fused=False, offsets=...)``, whose edge features sample the offset
channels at each anchor and map them to global edge ids.  The port
(device "cpu", target "gpu") against the JAX package (target "tpu" on
the CPU) on the same uint8 affinities with ``sigma_weights: 0``:
identical fragments, graph, features, costs and segmentation.  (A module
of its own, so that the parallel test run gives it a worker of its own.)
"""

import numpy as np
import pytest
import torch

from test_torch_split import U8_CFG, _both, _instance, _uint8

torch.set_num_threads(2)

SHAPE = (34, 52, 48)
OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [0, -3, 0]]


def _affinities(bnd):
    """Affinity-like channels for OFFSETS: the boundary evidence at the
    anchor and at its offset partner (maximum of the two)."""
    out = []
    for off in OFFSETS:
        shifted = bnd.copy()
        for ax, o in enumerate(off):
            shifted = np.roll(shifted, -o, axis=ax)
        out.append(np.maximum(bnd, shifted))
    return _uint8(np.stack(out))


@pytest.fixture(scope="module")
def affinities(tmp_path_factory):
    return _both(tmp_path_factory, "affinities",
                 _affinities(_instance(SHAPE, seed=3)), U8_CFG,
                 offsets=OFFSETS)


def test_affinity_fragments_and_segmentation_identical(affinities):
    jx, pt = affinities
    np.testing.assert_array_equal(pt["ws"], jx["ws"])
    np.testing.assert_array_equal(pt["seg"], jx["seg"])
    assert len(np.unique(pt["seg"])) > 1


def test_affinity_graph_features_and_costs_identical(affinities):
    jx, pt = affinities
    np.testing.assert_array_equal(pt["edges"], jx["edges"])
    assert pt["features"].shape == (len(pt["edges"]), 10)
    np.testing.assert_array_equal(pt["features"], jx["features"])
    np.testing.assert_array_equal(pt["costs"], jx["costs"])
