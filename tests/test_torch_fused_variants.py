"""The fused task's other executions in the port against the JAX
package, on the CPU: ``ws_method: "hybrid"`` (device stage A, the host C++
priority flood and size filter, device stage B one block behind) and
``ws_method: "legacy"`` (one upload per block, the basins watershed),
which a store that is not 3-d also takes.

* Per block: ``hybrid_pre`` / ``_stats_table`` / ``legacy_block`` against
  the JAX package's ``_hybrid_pre_program`` / ``_hybrid_stats_program`` /
  ``_fused_program`` — identical quantized heights, seed COO, dense
  labels, ``ok`` flags and edge tables (the float mean/variance columns
  within rtol 1e-6: float32 sums in another order, as in
  ``tests/test_torch_ops.py``).
* End to end through ``MulticutSegmentationWorkflow(fused=True)``: uint8
  input with ``sigma_weights: 0`` gives identical fragments, segmentation,
  graph, features and costs on both methods, and the float32 default
  holds ``hybrid`` to VOI <= 0.01 (the Gaussian's tap order, ROADMAP §C;
  the uint8 flood levels absorb it here).  ``legacy`` runs on a
  three-cell instance on which the basins watershed's fixed capacities
  overflow in some blocks and not in others, so both the direct drain and
  the redo (``device-ws-redo``, the JAX package's always-correct
  capacity-overflow route) run and give the JAX labels; float32 input
  with ``sigma_weights: 0`` is identical too.  With the default Gaussian,
  the legacy chain's full-resolution basins watershed turns the tap-order
  differences into more moved voxels than the coarse one (ROADMAP §C
  records the measurement).
* A 4-d (channel) store takes ``legacy`` and equals the JAX legacy run on
  the channel mean stored as 3-d, on whole blocks without halo (the
  channel read pads outer windows otherwise; the JAX package's fused
  task cannot open a 4-d store: ROADMAP §C).
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_fused import BLOCK, SHAPE, _instance, _voi
from tests.test_torch_fused import _run as _run_3d

torch.set_num_threads(2)

HALO = [2, 8, 8]


def _params(cfg, outer, halo):
    from cluster_tools_tpu_torch.workflows.fused_pipeline import _params

    return _params(cfg, outer, halo, 65536, False)


def _blocks(data, cfg):
    """The reflect-padded raw outer blocks of ``data`` as the fused task
    reads them."""
    from cluster_tools_tpu_torch.core.blocking import Blocking
    from cluster_tools_tpu_torch.workflows.watershed import \
        _read_padded_input

    class _DS:
        shape, ndim = data.shape, data.ndim

        def __getitem__(self, key):
            return data[key]

    b = Blocking(list(data.shape), BLOCK)
    for bid in range(b.n_blocks):
        blk = b.get_block(bid)
        yield blk, _read_padded_input(_DS(), blk, {**cfg,
                                                   "block_shape": BLOCK},
                                      HALO, raw=True)


def _outer():
    return tuple(b + 2 * h for b, h in zip(BLOCK, HALO))


_CFGS = {"u8_sw0": ("uint8", {"threshold": 0.4, "size_filter": 25,
                              "sigma_weights": 0}),
         "f32_sw0": ("float32", {"threshold": 0.4, "size_filter": 25,
                                 "sigma_weights": 0})}


def _data(dtype, n_cells=10):
    x = _instance(SHAPE, n_cells=n_cells)
    return np.round(x * 255).astype("uint8") if dtype == "uint8" else x


def _assert_table(tbl, n_r, uv, feats):
    np.testing.assert_array_equal(tbl[1:1 + n_r, :2], np.asarray(uv)[:n_r])
    f = tbl[1:1 + n_r, 2:]
    want = np.asarray(feats)[:n_r].astype("float64")
    np.testing.assert_array_equal(f[:, 2:], want[:, 2:])
    np.testing.assert_allclose(f[:, :2], want[:, :2], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_legacy_block_matches_jax_program(name):
    import jax.numpy as jnp
    from cluster_tools_tpu.workflows.fused_pipeline import _fused_program

    from cluster_tools_tpu_torch.workflows.fused_pipeline import \
        legacy_block

    dtype, cfg = _CFGS[name]
    p = _params(cfg, _outer(), HALO)
    prog = _fused_program(_outer(), tuple(HALO), p.threshold, p.sigma_seeds,
                          p.sigma_weights, p.alpha, p.min_size, p.e_max)
    oks = []
    for blk, data in _blocks(_data(dtype, n_cells=3), cfg):
        extent = [s.stop - s.start for s in blk.bb]
        tbl, dense = legacy_block(torch.from_numpy(data), extent, p)
        tbl = tbl.numpy()
        dj, kj, uvj, fj, nj, ovj, okj = prog(
            jnp.asarray(data), jnp.asarray(extent, dtype=jnp.int32))
        np.testing.assert_array_equal(dense.numpy(), np.asarray(dj))
        assert tbl[0, :4].tolist() == [int(kj), int(bool(okj)), int(nj),
                                       int(ovj)]
        _assert_table(tbl, int(nj), uvj, fj)
        oks.append(bool(okj))
    assert any(oks) and not all(oks)  # both drain branches occur


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_hybrid_stages_match_jax_programs(name):
    import jax.numpy as jnp
    from cluster_tools_tpu.workflows.fused_pipeline import (
        _hybrid_pre_program, _hybrid_stats_program)

    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.workflows.fused_pipeline import (
        _normalized, _stats_table, hybrid_pre)

    dtype, cfg = _CFGS[name]
    outer = _outer()
    p = _params(cfg, outer, HALO)
    pre, seed_cap = _hybrid_pre_program(outer, p.threshold, p.sigma_seeds,
                                        p.sigma_weights, p.alpha)
    stats = _hybrid_stats_program(outer, tuple(HALO), p.e_max)
    inner_sl = tuple(slice(h, o - h) for h, o in zip(HALO, outer))
    for _, data in list(_blocks(_data(dtype), cfg))[:6]:
        hq, pos, sid, n = (t.numpy() for t in hybrid_pre(
            torch.from_numpy(data), p, seed_cap))
        hqj, posj, sidj, nj = pre(jnp.asarray(data))
        n = int(n[0])
        assert n == int(nj) > 0
        np.testing.assert_array_equal(hq, np.asarray(hqj))
        np.testing.assert_array_equal(pos[:n], np.asarray(posj)[:n])
        np.testing.assert_array_equal(sid[:n], np.asarray(sidj)[:n])
        markers = np.zeros(hq.size, "int64")
        markers[pos[:n]] = sid[:n]
        ws = native.seeded_watershed_u8(hq, markers.reshape(outer))
        dense = np.unique(ws[inner_sl], return_inverse=True)[1].reshape(
            ws[inner_sl].shape).astype("int32")
        tbl = _stats_table(torch.from_numpy(dense),
                           _normalized(torch.from_numpy(data))[inner_sl],
                           p.e_max, []).numpy()
        uvj, fj, nrj, ovj = stats(jnp.asarray(data), jnp.asarray(dense))
        assert tbl[0, :2].tolist() == [int(nrj), int(ovj)]
        _assert_table(tbl, int(nrj), uvj, fj)


def test_hybrid_seed_capacity_overflow_is_counted():
    """More seed voxels than the COO capacity: the count still reports
    them all (the task raises on it) and the kept slots are the first
    seeds in index order."""
    from cluster_tools_tpu_torch.workflows.fused_pipeline import hybrid_pre

    dtype, cfg = _CFGS["u8_sw0"]
    p = _params(cfg, _outer(), HALO)
    _, data = next(_blocks(_data(dtype), cfg))
    _, pos, _, n = hybrid_pre(torch.from_numpy(data), p, 4)
    _, pos_all, _, n_all = hybrid_pre(torch.from_numpy(data), p, 1 << 14)
    assert int(n[0]) == int(n_all[0]) > 4
    np.testing.assert_array_equal(pos.numpy(), pos_all.numpy()[:4])


def _run(pkg, root, data, task_cfg):
    """``tests/test_torch_fused.py``'s run of the fused workflow; a 4-d
    (channel) store, port only, is written in chunks of all its
    channels."""
    if data.ndim == 3:
        return _run_3d(pkg, root, data, task_cfg, BLOCK)
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.core.graph import load_graph
    from cluster_tools_tpu_torch.core.storage import file_reader

    assert pkg == "torch"
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with file_reader(path) as f:
        f.require_dataset("bmap", shape=data.shape,
                          chunks=[data.shape[0]] + BLOCK,
                          dtype=data.dtype)[:] = data
    cfg_dir = os.path.join(root, "cfg")
    ConfigDir(cfg_dir).write_global_config({"block_shape": BLOCK,
                                            "device": "cpu"})
    ConfigDir(cfg_dir).write_task_config("fused_segmentation", task_cfg)
    tmp = os.path.join(root, "tmp")
    wf = M.MulticutSegmentationWorkflow(
        input_path=path, input_key="bmap", ws_path=path, ws_key="ws",
        problem_path=os.path.join(root, "p.n5"), output_path=path,
        output_key="seg", tmp_folder=tmp, config_dir=cfg_dir, max_jobs=1,
        n_scales=1, fused=True)
    assert M.build([wf], raise_on_failure=True)
    out = {}
    with file_reader(path, "r") as f:
        out["ws"], out["seg"] = f["ws"][:], f["seg"][:]
        out["max_id"] = f["ws"].attrs["maxId"]
    _, out["edges"], _ = load_graph(os.path.join(root, "p.n5"), "s0/graph")
    with file_reader(os.path.join(root, "p.n5"), "r") as f:
        out["features"], out["costs"] = f["features"][:], f["s0/costs"][:]
    with open(os.path.join(tmp, "fused_segmentation.status")) as f:
        out["status"] = json.load(f)
    return out


_RUNS = {
    "hybrid_u8": ("uint8", 10, {"ws_method": "hybrid", "sigma_weights": 0}),
    "hybrid_float": ("float32", 10, {"ws_method": "hybrid"}),
    "legacy_u8": ("uint8", 3, {"ws_method": "legacy", "sigma_weights": 0}),
    "legacy_f32_sw0": ("float32", 3, {"ws_method": "legacy",
                                      "sigma_weights": 0}),
    "channels": ("float32", 3, {"sigma_weights": 0}),
}


@pytest.fixture(scope="module", params=sorted(_RUNS))
def runs(request, tmp_path_factory):
    dtype, n_cells, extra = _RUNS[request.param]
    cfg = {"threshold": 0.4, "size_filter": 25, "halo": HALO, **extra}
    data = _data(dtype, n_cells)
    root = tmp_path_factory.mktemp(request.param)
    if request.param == "channels":
        # the port's default method on two equal channels; the JAX
        # package's legacy run on their mean, stored as 3-d.  A volume of
        # whole blocks without halo: the channel read pads a block's
        # outer window otherwise than the 3-d read does
        # (``_read_padded_input``), so no block may need padding
        data = _instance((32, 48, 48), n_cells=3)
        cfg["halo"] = [0, 0, 0]
        return request.param, (
            _run("jax", str(root / "jax"), data,
                 {**cfg, "ws_method": "legacy"}),
            _run("torch", str(root / "torch"), np.stack([data, data]), cfg))
    return request.param, (_run("jax", str(root / "jax"), data, cfg),
                           _run("torch", str(root / "torch"), data, cfg))


def test_fused_variants_match_jax(runs):
    name, (jx, pt) = runs
    counts = pt["status"]["stage_counts"]
    if name == "hybrid_float":
        assert _voi(pt["ws"], jx["ws"]) <= 0.01
        assert _voi(pt["seg"], jx["seg"]) <= 0.01
    else:
        np.testing.assert_array_equal(pt["ws"], jx["ws"])
        np.testing.assert_array_equal(pt["seg"], jx["seg"])
        np.testing.assert_array_equal(pt["edges"], jx["edges"])
        np.testing.assert_allclose(pt["features"], jx["features"],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(pt["costs"], jx["costs"], rtol=1e-5,
                                   atol=1e-6)
    assert pt["max_id"] == len(np.unique(pt["ws"])) - (0 in pt["ws"])
    if name.startswith("hybrid"):
        assert counts["host-flood"] == counts["sync-stats"] == 18
    elif name == "channels":
        # the legacy loop ran (no resident upload), one pass per block
        assert "h2d-upload" not in counts and counts["sync-execute"] == 8
    else:
        # both drain branches ran: some blocks direct, some redone
        assert 0 < counts.get("device-ws-redo", 0) < counts["sync-execute"]
