"""The split chain's other watershed routes, port (device "cpu", target
"gpu") against the JAX package (target "tpu" on the CPU), identical
outputs expected in each:

* a uint8 noise volume with few seeds, which overflows the coarse solve's
  capacities in every block, so the streamed watershed redoes each block
  with the exact-capacity basins algorithm on the same device (counted
  as the ``device-ws-redo`` stage);
* ``ws_algorithm: "basins"`` with the size filter on the host (the CPU
  device's default, as on the JAX package's CPU backend) and fused into
  the device pass (``fuse_size_filter: true``);
* ``impl: "host"`` for the sub-graph extraction and the edge features
  (the numpy analogs of the device passes).
"""

import numpy as np
import pytest
import torch

from test_torch_split import U8_CFG, _both, _instance, _uint8

torch.set_num_threads(2)

SHAPE = (34, 52, 48)


def _identical(jx, pt):
    for key in ("ws", "seg", "edges", "features", "costs"):
        np.testing.assert_array_equal(pt[key], jx[key], err_msg=key)


@pytest.fixture(scope="module")
def noise_redo(tmp_path_factory):
    data = np.random.RandomState(0).randint(0, 256, (16, 24, 48)).astype(
        "uint8")
    return _both(tmp_path_factory, "noise_redo", data,
                 {"threshold": 0.05, "size_filter": 2, "sigma_weights": 0,
                  "sigma_seeds": 0})


@pytest.mark.parametrize("fuse", [None, True])
def test_basins_algorithm_identical(tmp_path_factory, fuse):
    cfg = {**U8_CFG, "ws_algorithm": "basins"}
    if fuse is not None:
        cfg["fuse_size_filter"] = fuse
    jx, pt = _both(tmp_path_factory, f"basins_{fuse}",
                   _uint8(_instance(SHAPE, seed=4)), cfg)
    _identical(jx, pt)
    assert len(pt["edges"]) > 20


def test_capacity_overflow_redo_identical(noise_redo):
    jx, pt = noise_redo
    _identical(jx, pt)
    counts = pt["status"]["watershed"]["stage_counts"]
    assert counts.get("device-ws-redo", 0) == counts["sync-execute"] > 0


def test_host_impl_rag_identical(tmp_path_factory):
    host = {"impl": "host"}
    jx, pt = _both(tmp_path_factory, "host_impl",
                   _uint8(_instance(SHAPE, seed=5)), U8_CFG,
                   task_cfgs={"initial_sub_graphs": host,
                              "block_edge_features": host})
    _identical(jx, pt)
    assert len(pt["edges"]) > 20
