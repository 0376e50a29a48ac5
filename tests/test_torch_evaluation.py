"""Node labels and blockwise evaluation of the port against the JAX
package, on the CPU.

``NodeLabelWorkflow`` writes the JAX package's argmax labels
(``max_overlap=True``) and the same merged overlaps
(``max_overlap=False``), with and without ``ignore_label``;
``EvaluationWorkflow`` gives the same metrics within 1e-12, with ignore
lists and object VI.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SHAPE = (20, 20, 20)
BLOCK = [10, 10, 10]
TOL = 1e-12


def _pkg(pkg):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows import evaluation, node_labels
        return M, ConfigDir, "inline", {}, node_labels, evaluation
    import cluster_tools_tpu_torch as M
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows import evaluation, node_labels
    return M, ConfigDir, "gpu", {"device": "cpu"}, node_labels, evaluation


def _common(pkg, root, task_configs=None):
    M, ConfigDir, target, extra, nl, ev = _pkg(pkg)
    cfg = os.path.join(root, f"cfg_{pkg}")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK,
                                        "max_num_retries": 0, **extra})
    for name, conf in (task_configs or {}).items():
        ConfigDir(cfg).write_task_config(name, conf)
    return M, nl, ev, dict(tmp_folder=os.path.join(root, f"tmp_{pkg}"),
                           config_dir=cfg, max_jobs=3, target=target)


def _store(tmp_path, **arrays):
    from cluster_tools_tpu_torch.core.storage import file_reader

    path = str(tmp_path / "data.n5")
    with file_reader(path) as f:
        for key, data in arrays.items():
            f.require_dataset(key, shape=data.shape, chunks=BLOCK,
                              dtype=data.dtype)[:] = data
            f[key].attrs["maxId"] = int(data.max())
    return path


@pytest.mark.parametrize("max_overlap", [True, False],
                         ids=["max_overlap", "full_overlaps"])
@pytest.mark.parametrize("ignore_label", [None, 3])
def test_node_label_workflow_matches_jax(tmp_path, max_overlap,
                                         ignore_label):
    rng = np.random.RandomState(0)
    ws = rng.randint(0, 50, size=SHAPE).astype("uint64")
    labels = rng.randint(0, 8, size=SHAPE).astype("uint64")
    labels[:, :5] = 3  # a slab of the ignore label
    path = _store(tmp_path, ws=ws, labels=labels)
    out = {}
    for pkg in ("jax", "torch"):
        # a shard size that splits the node ids over three shards
        M, nl, _, common = _common(pkg, str(tmp_path),
                                   {"block_node_labels": {"shard_size": 20}})
        wf = nl.NodeLabelWorkflow(
            ws_path=path, ws_key="ws", input_path=path, input_key="labels",
            output_path=path, output_key=f"node_labels_{pkg}",
            max_overlap=max_overlap, ignore_label=ignore_label, **common)
        assert M.build([wf], raise_on_failure=True)
        if max_overlap:
            with M.file_reader(path, "r") as f:
                out[pkg] = f[f"node_labels_{pkg}"][:]
        else:
            out[pkg] = nl.load_merged_overlaps(path, f"node_labels_{pkg}")
    assert out["torch"].dtype == out["jax"].dtype == np.uint64
    np.testing.assert_array_equal(out["torch"], out["jax"])
    if max_overlap and ignore_label is None:
        for node in range(1, int(ws.max()) + 1):
            ids, counts = np.unique(labels[ws == node], return_counts=True)
            assert out["torch"][node] == ids[counts == counts.max()].min()
    if not max_overlap:
        assert len(out["torch"]) and (out["torch"][:, 0] > 0).all()
        if ignore_label is not None:
            assert (out["torch"][:, 1] != ignore_label).all()


@pytest.mark.parametrize("ignore_seg,ignore_gt,object_vi", [
    (None, None, False), ([0], None, True), ([17], [0, 4], False),
])
def test_evaluation_workflow_matches_jax(tmp_path, ignore_seg, ignore_gt,
                                         object_vi):
    rng = np.random.RandomState(1)
    gt = rng.randint(0, 6, size=SHAPE).astype("uint64")
    seg = gt.copy()
    seg[seg == 2] = 1  # a merge
    seg[(gt == 5) & (np.arange(SHAPE[2]) % 2 == 0)[None, None, :]] = 17
    path = _store(tmp_path, seg=seg, gt=gt)
    scores = {}
    for pkg in ("jax", "torch"):
        M, _, ev, common = _common(pkg, str(tmp_path))
        out_path = str(tmp_path / f"scores_{pkg}.json")
        wf = ev.EvaluationWorkflow(
            seg_path=path, seg_key="seg", gt_path=path, gt_key="gt",
            out_path=out_path, ignore_seg=ignore_seg, ignore_gt=ignore_gt,
            compute_object_vi=object_vi, **common)
        assert M.build([wf], raise_on_failure=True)
        with open(out_path) as f:
            scores[pkg] = json.load(f)
    pt, jx = scores["torch"], scores["jax"]
    assert sorted(pt) == sorted(jx)
    for key in ("vi-split", "vi-merge", "adapted-rand-error", "rand-index",
                "cremi-score", "n-points"):
        assert abs(pt[key] - jx[key]) <= TOL, key
    if object_vi:
        assert sorted(pt["object-vi"]) == sorted(jx["object-vi"])
        for k, v in jx["object-vi"].items():
            np.testing.assert_allclose(pt["object-vi"][k], v, rtol=0,
                                       atol=TOL)
    # and the metrics of the whole volumes at once
    from cluster_tools_tpu_torch.utils.validation import (
        rand_index, variation_of_information)

    kw = dict(ignore_seg=ignore_seg, ignore_gt=ignore_gt)
    vis, vim = variation_of_information(seg, gt, **kw)
    assert abs(pt["vi-split"] - vis) <= 1e-9
    assert abs(pt["vi-merge"] - vim) <= 1e-9
    assert abs(pt["adapted-rand-error"] - rand_index(seg, gt, **kw)[0]) \
        <= 1e-9


def test_node_labels_and_evaluation_raise_without_a_card(tmp_path):
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    seg = np.ones(SHAPE, "uint64")
    path = _store(tmp_path, seg=seg)
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    for wf in (ctp.NodeLabelWorkflow(ws_path=path, ws_key="seg",
                                     input_path=path, input_key="seg",
                                     output_path=path, output_key="nl",
                                     **common),
               ctp.EvaluationWorkflow(seg_path=path, seg_key="seg",
                                      gt_path=path, gt_key="seg",
                                      out_path=str(tmp_path / "s.json"),
                                      **common)):
        assert wf.target == "gpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctp.build([wf])
