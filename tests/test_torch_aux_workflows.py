"""Masking, the decomposition multicut and the debugging checks of the port
(``workflows/{masking,decomposition,debugging}.py``) against the JAX
package, on the CPU.

Every output is a block list, a mask, a label volume or a list of ids,
held exactly: both packages run the same numpy, scipy and C++ steps.  The
decomposition runs on one multicut problem (the JAX package's, copied),
so its segmentation must be the JAX package's; the port's own problem
recovers the ground truth of ``tests/test_multicut.py``'s instance as the
JAX package's test asks.  The tests of ``tests/test_aux_workflows.py`` for
these modules run on the port here, each beside the JAX package's
result."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest


def _env(pkg, root, block=(10, 10, 10)):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows import (debugging, decomposition,
                                                 graph, masking, morphology,
                                                 segmentation)
        extra = {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.workflows import (debugging,
                                                       decomposition, graph,
                                                       masking, morphology,
                                                       segmentation)
        extra = {"device": "cpu"}
    os.makedirs(root, exist_ok=True)
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": list(block),
                                        "max_num_retries": 0, **extra})
    return SimpleNamespace(
        M=M, debugging=debugging, decomposition=decomposition, graph=graph,
        masking=masking, morphology=morphology, segmentation=segmentation,
        root=root, path=os.path.join(root, "d.n5"),
        problem=os.path.join(root, "p.n5"), tmp=os.path.join(root, "tmp"),
        common=dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                    max_jobs=2, target="threads"))


def _write(env, key, data, chunks, max_id=None):
    with env.M.file_reader(env.path) as f:
        ds = f.require_dataset(key, shape=data.shape, chunks=list(chunks),
                               dtype=str(data.dtype))
        ds[:] = data
        if max_id is not None:
            ds.attrs["maxId"] = int(max_id)


def _read(env, key):
    with env.M.file_reader(env.path, "r") as f:
        return f[key][:]


def _both(tmp_path, fn, **kw):
    return (fn(_env("jax", str(tmp_path / "jax"), **kw)),
            fn(_env("torch", str(tmp_path / "torch"), **kw)))


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

def _mask(shape, seed):
    rng = np.random.RandomState(seed)
    mask = np.zeros(shape, "uint8")
    for _ in range(3):
        lo = rng.randint(0, np.asarray(shape) - 2)
        hi = lo + rng.randint(1, 6, 3)
        mask[tuple(slice(a, b) for a, b in zip(lo, hi))] = 1
    return mask


@pytest.mark.parametrize("case", ["half", "random", "low_res"])
def test_blocks_from_mask_matches_jax(tmp_path, case):
    """The JAX package's test_blocks_from_mask (``half``) and two more
    masks: random boxes, and a half-resolution mask read through the
    interpolated view."""
    shape = (20, 20, 20)
    if case == "half":
        mask = np.zeros(shape, "uint8")
        mask[:, :10, :] = 1
    elif case == "random":
        mask = _mask(shape, seed=1)
    else:
        mask = _mask((10, 10, 10), seed=2)

    def run(env):
        _write(env, "mask", mask, [10, 10, 10])
        out = os.path.join(env.root, "blocks.json")
        task = env.masking.BlocksFromMask(
            mask_path=env.path, mask_key="mask", shape=shape,
            block_shape=[10, 10, 10], output_path=out,
            tmp_folder=env.common["tmp_folder"])
        assert env.M.build([task], raise_on_failure=True)
        with open(out) as f:
            return json.load(f)

    jax_b, port_b = _both(tmp_path, run)
    assert port_b == jax_b
    full = (mask if case != "low_res"
            else mask.repeat(2, 0).repeat(2, 1).repeat(2, 2))
    want = [bid for bid, (z, y, x) in enumerate(np.ndindex(2, 2, 2))
            if full[z * 10:(z + 1) * 10, y * 10:(y + 1) * 10,
                    x * 10:(x + 1) * 10].any()]
    assert port_b == want
    if case == "half":
        assert len(port_b) == 4


@pytest.mark.parametrize("filter_shape", [[3, 3, 3], [1, 5, 3]])
def test_minfilter_mask_matches_jax(tmp_path, filter_shape):
    """The JAX package's test_minfilter_mask, and a random mask with an
    anisotropic filter."""
    shape = (16, 16, 16)
    mask = np.ones(shape, "uint8")
    mask[8, 8, 8] = 0
    rand = 1 - _mask(shape, seed=3)

    def run(env):
        _write(env, "mask", mask, [8, 8, 8])
        _write(env, "rand", rand, [8, 8, 8])
        out = {}
        for key in ("mask", "rand"):
            task = env.masking.MinFilterMask(
                input_path=env.path, input_key=key, output_path=env.path,
                output_key=key + "_shrunk", filter_shape=filter_shape,
                **dict(env.common, tmp_folder=env.tmp + key))
            assert env.M.build([task], raise_on_failure=True)
            out[key] = _read(env, key + "_shrunk")
        return out

    jax_m, port_m = _both(tmp_path, run, block=(8, 8, 8))
    for key in port_m:
        np.testing.assert_array_equal(port_m[key], jax_m[key])
    from scipy.ndimage import minimum_filter

    np.testing.assert_array_equal(port_m["rand"],
                                  minimum_filter(rand, size=filter_shape))
    if filter_shape == [3, 3, 3]:
        assert (port_m["mask"][7:10, 7:10, 7:10] == 0).all()
        assert port_m["mask"][5, 5, 5] == 1


def test_minfilter_mask_target_is_local(tmp_path):
    """The exported block task keeps the block tasks' default target."""
    env = _env("torch", str(tmp_path))
    task = env.masking.MinFilterMask(
        input_path="a.n5", input_key="m", output_path="a.n5",
        output_key="s", filter_shape=[3, 3, 3],
        tmp_folder=env.tmp, config_dir=env.common["config_dir"])
    assert task.target == "local"


# ---------------------------------------------------------------------------
# debugging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["two_slabs", "random"])
def test_check_sub_graphs_matches_jax(tmp_path, case):
    """The JAX package's test_check_sub_graphs (``two_slabs``) and a random
    label volume; a corrupted sub-graph is reported by both packages."""
    shape = (20, 20, 20)
    if case == "two_slabs":
        seg = np.ones(shape, "uint64")
        seg[:, 10:, :] = 2
    else:
        seg = np.random.RandomState(4).randint(
            1, 30, (5, 5, 5)).astype("uint64")
        seg = seg.repeat(4, 0).repeat(4, 1).repeat(4, 2)

    def run(env):
        _write(env, "ws", seg, [10, 10, 10], max_id=seg.max())
        graph = env.graph.GraphWorkflow(
            input_path=env.path, input_key="ws", graph_path=env.problem,
            output_key="s0/graph", **env.common)
        check = env.debugging.CheckSubGraphs(
            ws_path=env.path, ws_key="ws", graph_path=env.problem,
            dependency=graph, **env.common)
        assert env.M.build([check], raise_on_failure=True)
        with open(os.path.join(env.tmp, "check_sub_graphs_failed.json")) as f:
            ok = json.load(f)
        # a block whose stored nodes lost one id fails the check
        path = os.path.join(env.problem, "s0", "sub_graphs", "block_3.npz")
        with np.load(path) as d:
            data = {k: d[k] for k in d.files}
        data["nodes"] = data["nodes"][:-1]
        np.savez(path, **data)
        os.remove(os.path.join(env.tmp, "check_sub_graphs.status"))
        check = env.debugging.CheckSubGraphs(
            ws_path=env.path, ws_key="ws", graph_path=env.problem,
            **env.common)
        assert not env.M.build([check])
        with open(os.path.join(env.tmp, "check_sub_graphs_failed.json")) as f:
            return ok, json.load(f)

    jax_r, port_r = _both(tmp_path, run)
    assert port_r == jax_r
    assert port_r == ([], [3])


def _seg_with_disconnected():
    """The JAX package's test volume: label 2 is two separate slabs."""
    seg = np.zeros((16, 16, 16), "uint64")
    seg[:4] = 1
    seg[6:8] = 2
    seg[10:12] = 2
    return seg


@pytest.mark.parametrize("case", ["slabs", "random"])
def test_check_components_matches_jax(tmp_path, case):
    """The JAX package's test_check_components (``slabs``) and random
    boxes, some split by a later box."""
    if case == "slabs":
        seg = _seg_with_disconnected()
    else:
        rng = np.random.RandomState(5)
        seg = np.zeros((16, 16, 16), "uint64")
        for i in range(1, 9):
            lo = rng.randint(0, 12, 3)
            hi = lo + rng.randint(2, 8, 3)
            seg[tuple(slice(a, b) for a, b in zip(lo, hi))] = i
        seg[:, 7:9, :] = 9  # a wall that may cut earlier boxes in two

    def run(env):
        _write(env, "seg", seg, [8, 8, 8], max_id=seg.max())
        morpho = env.morphology.MorphologyWorkflow(
            input_path=env.path, input_key="seg", output_path=env.path,
            output_key="morphology", **env.common)
        out_json = os.path.join(env.root, "disconnected.json")
        check = env.debugging.CheckComponents(
            seg_path=env.path, seg_key="seg", morphology_path=env.path,
            morphology_key="morphology", n_labels=int(seg.max()) + 1,
            output_path=out_json, dependency=morpho, **env.common)
        assert env.M.build([check], raise_on_failure=True)
        with open(out_json) as f:
            return json.load(f)

    jax_r, port_r = _both(tmp_path, run, block=(8, 8, 8))
    assert port_r == jax_r
    from scipy import ndimage

    want = [i for i in range(1, int(seg.max()) + 1) if (seg == i).any()
            and ndimage.label(seg == i, np.ones((3, 3, 3)))[1] != 1]
    assert port_r == want
    if case == "slabs":
        assert port_r == [2]


def test_check_ws_workflow_matches_jax(tmp_path):
    """``CheckWsWorkflow`` (not a Task: it builds through ``.task()``)
    resolves the label count from maxId and lists the disconnected
    fragment, as the JAX package's does."""
    seg = _seg_with_disconnected()

    def run(env):
        _write(env, "ws", seg, [8, 8, 8], max_id=seg.max())
        out_json = os.path.join(env.root, "violations.json")
        wf = env.debugging.CheckWsWorkflow(
            ws_path=env.path, ws_key="ws",
            debug_path=os.path.join(env.root, "debug.n5"),
            output_path=out_json, **env.common)
        assert env.M.build([wf.task()], raise_on_failure=True)
        with open(out_json) as f:
            return json.load(f)

    jax_r, port_r = _both(tmp_path, run, block=(8, 8, 8))
    assert port_r == jax_r == [2]
    env = _env("torch", str(tmp_path / "t2"))
    assert env.debugging.CheckWsWorkflow(
        ws_path="a", ws_key="b", debug_path="c", output_path="d",
        tmp_folder=env.tmp, config_dir=env.common["config_dir"]
    ).common["target"] == "gpu"


# ---------------------------------------------------------------------------
# decomposition multicut
# ---------------------------------------------------------------------------

def _instance():
    from tests.test_multicut import _boundary_map, _nested_voronoi

    true, frags = _nested_voronoi()
    return true, frags, _boundary_map(true)


def _problem(env, bnd, frags):
    _write(env, "bmap", bnd, (12, 12, 12))
    _write(env, "ws", frags, (12, 12, 12), max_id=frags.max())
    prob = env.segmentation.ProblemWorkflow(
        input_path=env.path, input_key="bmap", ws_path=env.path,
        ws_key="ws", problem_path=env.problem, **env.common)
    assert env.M.build([prob], raise_on_failure=True)


def _decompose(env, tag=""):
    common = dict(env.common, tmp_folder=env.tmp + tag)
    wf = env.decomposition.DecompositionWorkflow(
        problem_path=env.problem, ws_path=env.path, ws_key="ws",
        output_path=env.path, output_key="seg" + tag, **common)
    assert env.M.build([wf], raise_on_failure=True)
    labeling = _read_problem(env, "decomposition/labeling")
    return _read(env, "seg" + tag), labeling, np.load(os.path.join(
        common["tmp_folder"], "decomposition_assignments.npy"))


def _read_problem(env, key):
    with env.M.file_reader(env.problem, "r") as f:
        return f[key][:]


def test_decomposition_on_the_jax_problem_matches_jax(tmp_path):
    """Both packages' DecompositionWorkflow on one problem (built by the
    JAX package, copied): the component labeling, the assignment table
    and the segmentation are identical."""
    true, frags, bnd = _instance()
    jax_env = _env("jax", str(tmp_path / "jax"), block=(12, 12, 12))
    port_env = _env("torch", str(tmp_path / "torch"), block=(12, 12, 12))
    _problem(jax_env, bnd, frags)
    shutil.copytree(jax_env.path, port_env.path)
    shutil.copytree(jax_env.problem, port_env.problem)
    jax_r = _decompose(jax_env)
    port_r = _decompose(port_env)
    for a, b in zip(jax_r, port_r):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    from tests.test_multicut import _check_recovery

    _check_recovery(true, port_r[0])


def test_decomposition_workflow_recovers_truth(tmp_path):
    """The JAX package's test_decomposition_workflow on the port alone:
    its own problem (built on the CPU), then the decomposition solver."""
    from tests.test_multicut import _check_recovery

    true, frags, bnd = _instance()
    env = _env("torch", str(tmp_path), block=(12, 12, 12))
    _problem(env, bnd, frags)
    seg, labeling, table = _decompose(env)
    _check_recovery(true, seg)
    assert labeling.dtype == np.uint64 and table.dtype == np.uint64


def test_decompose_splits_at_repulsive_edges():
    """Decompose's components are the connected components of the
    attractive subgraph (the JAX package's rule), on a hand-made graph."""
    from cluster_tools_tpu_torch import native

    uv = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [5, 6]])
    costs = np.array([1.0, -1.0, 2.0, 0.5, 1.0])
    roots = native.ufd_merge_pairs(7, uv[costs > 0])
    _, comp = np.unique(roots, return_inverse=True)
    assert comp[0] == comp[1] and comp[2] == comp[3] == comp[4]
    assert comp[1] != comp[2] and comp[5] == comp[6]
    assert len(np.unique(comp)) == 3
