"""Label multisets, the Paintera conversion and the BigCat export of the
port (``workflows/{label_multisets,paintera}.py``) against the JAX
package, on the CPU.

Everything here is labels, id lists and metadata, held exactly: the
multisets (offsets, ids, counts), the per-block unique labels, the
label-to-block lookup, the fragment-segment pairs, the label pyramid (its
``DownscaleTask`` runs on the port's CPU device here) and the attribute
dicts (the lookup's ``root``, an absolute path, aside).  The tests of
``tests/test_downscaling.py`` for these modules run on the port here,
each beside the JAX package's result; the BigCat export runs into HDF5
(the JAX package's test's format), N5 and zarr.  Containers written by
one package are read by the other."""

import os
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest


def _env(pkg, root, block=(8, 8, 8)):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.core.storage import VarlenDataset
        from cluster_tools_tpu.workflows import label_multisets, paintera
        extra = {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.core.storage import VarlenDataset
        from cluster_tools_tpu_torch.workflows import (label_multisets,
                                                       paintera)
        extra = {"device": "cpu"}
    os.makedirs(root, exist_ok=True)
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": list(block),
                                        "max_num_retries": 0, **extra})
    return SimpleNamespace(
        M=M, ms=label_multisets, pt=paintera, Varlen=VarlenDataset,
        root=root, path=os.path.join(root, "d.n5"),
        common=dict(tmp_folder=os.path.join(root, "tmp"), config_dir=cfg,
                    max_jobs=2, target="threads"))


def _write(env, key, data, chunks=(8, 8, 8), max_id=None):
    with env.M.file_reader(env.path) as f:
        ds = f.require_dataset(key, shape=data.shape, chunks=list(chunks),
                               dtype=str(data.dtype))
        ds[:] = data
        if max_id is not None:
            ds.attrs["maxId"] = int(max_id)


#: array metadata of an N5 dataset's attributes.json (each storage layer
#: writes its own); the user attributes are compared
_N5_ARRAY_KEYS = {"dimensions", "blockSize", "dataType", "compression"}


def _user_attrs(attrs):
    return {k: attrs[k] for k in attrs.keys() if k not in _N5_ARRAY_KEYS}


def _both(tmp_path, fn, **kw):
    return (fn(_env("jax", str(tmp_path / "jax"), **kw)),
            fn(_env("torch", str(tmp_path / "torch"), **kw)))


def _chunks(env, path, key):
    ds = env.Varlen(os.path.join(path, key), dtype="uint64", mode="r")
    return {cid: ds.read_chunk(cid) for cid in ds.chunk_ids()}


def _assert_chunks_equal(a, b):
    assert a.keys() == b.keys()
    for cid in a:
        assert a[cid].dtype == b[cid].dtype
        np.testing.assert_array_equal(b[cid], a[cid])


def _labels(shape=(20, 18, 22), n=12, seed=0):
    """Blocky random labels (runs of equal ids across windows) with a
    background of 0, so windows hold one to several ids."""
    rng = np.random.RandomState(seed)
    small = rng.randint(0, n, [-(-s // 3) for s in shape]).astype("uint64")
    big = small.repeat(3, 0).repeat(3, 1).repeat(3, 2)
    big = big[:shape[0], :shape[1], :shape[2]]
    noise = rng.rand(*shape) < 0.1
    big[noise] = rng.randint(0, n, int(noise.sum()))
    return np.ascontiguousarray(big)


# ---------------------------------------------------------------------------
# label multisets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor,shape", [([2, 2, 2], (5, 6, 7)),
                                          ([1, 2, 3], (4, 9, 10)),
                                          ([3, 3, 3], (7, 7, 8))])
def test_compute_multisets_matches_jax_and_bruteforce(factor, shape):
    """The JAX package's test_compute_multisets_bruteforce, with two more
    factors and ragged edge windows, against the JAX package's output."""
    from cluster_tools_tpu.workflows import label_multisets as J
    from cluster_tools_tpu_torch.workflows import label_multisets as P

    rng = np.random.RandomState(0)
    fine = rng.randint(0, 5, size=shape).astype("uint64")
    offsets, ids, counts = P.compute_multisets(fine, factor)
    for a, b in zip(J.compute_multisets(fine, factor),
                    (offsets, ids, counts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    out_shape = tuple(-(-s // f) for s, f in zip(fine.shape, factor))
    assert len(offsets) == int(np.prod(out_shape)) + 1
    for i, (z, y, x) in enumerate(np.ndindex(*out_shape)):
        window = fine[z * factor[0]:(z + 1) * factor[0],
                      y * factor[1]:(y + 1) * factor[1],
                      x * factor[2]:(x + 1) * factor[2]]
        got = dict(zip(ids[offsets[i]:offsets[i + 1]].tolist(),
                       counts[offsets[i]:offsets[i + 1]].tolist()))
        assert got == dict(Counter(window.ravel().tolist())), (z, y, x)
        assert (np.diff(ids[offsets[i]:offsets[i + 1]]) > 0).all()
    assert counts.sum() == fine.size
    packed = P.pack_multiset_block(offsets, ids, counts)
    np.testing.assert_array_equal(packed,
                                  J.pack_multiset_block(offsets, ids, counts))
    for a, b in zip(P.unpack_multiset_block(packed),
                    (offsets, ids, counts)):
        np.testing.assert_array_equal(a, b)


def test_merge_multisets_matches_jax():
    from cluster_tools_tpu.workflows import label_multisets as J
    from cluster_tools_tpu_torch.workflows import label_multisets as P

    rng = np.random.RandomState(2)
    entries = [(rng.randint(0, 6, 20), rng.randint(0, 4, 20).astype("uint64"),
                rng.randint(1, 9, 20)) for _ in range(3)]
    for a, b in zip(J.merge_multisets(entries, 6),
                    P.merge_multisets(entries, 6)):
        np.testing.assert_array_equal(b, a)
    empty = P.merge_multisets([], 4)
    assert len(empty[0]) == 5 and not empty[1].size


def _multisets(env, labels, factors):
    _write(env, "labels", labels)
    wf = env.ms.LabelMultisetWorkflow(
        input_path=env.path, input_key="labels", output_path=env.path,
        output_prefix="multisets", scale_factors=factors, **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    out = {}
    for s in range(1, len(factors) + 1):
        key = f"multisets/s{s}"
        ds = env.Varlen(os.path.join(env.path, key), mode="r")
        out[key] = (_chunks(env, env.path, key), _user_attrs(ds.attrs))
    return out


@pytest.mark.parametrize("factors", [[[2, 2, 2], [2, 2, 2]],
                                     [[1, 2, 2], [1, 2, 2], [2, 2, 2]]])
def test_label_multiset_workflow_matches_jax(tmp_path, factors):
    """The JAX package's test_label_multiset_workflow (``[[2, 2, 2], [2, 2,
    2]]``) and the card run's pyramid: every level's chunks and attrs equal
    to the JAX package's; a coarse voxel's multiset is the histogram of its
    fine window."""
    if factors[0] == [2, 2, 2]:
        labels = np.random.RandomState(1).randint(
            1, 9, size=(16, 16, 16)).astype("uint64")
    else:
        labels = _labels()
    jax_r, port_r = _both(tmp_path, lambda e: _multisets(e, labels, factors))
    assert port_r.keys() == jax_r.keys()
    for key in jax_r:
        _assert_chunks_equal(jax_r[key][0], port_r[key][0])
        assert port_r[key][1] == jax_r[key][1]

    from cluster_tools_tpu_torch.workflows.label_multisets import \
        load_multiset_block

    path = str(tmp_path / "torch" / "d.n5")
    top = f"multisets/s{len(factors)}"
    cum = np.prod(np.asarray(factors), axis=0)
    offsets, ids, counts = load_multiset_block(path, top, 0)
    window = labels[:cum[0], :cum[1], :cum[2]]
    got = dict(zip(ids[offsets[0]:offsets[1]].tolist(),
                   counts[offsets[0]:offsets[1]].tolist()))
    uniq, cnt = np.unique(window, return_counts=True)
    assert got == dict(zip(uniq.tolist(), cnt.tolist()))
    assert counts[offsets[0]:offsets[1]].sum() == int(np.prod(cum))
    assert port_r[top][1]["downsamplingFactors"] == cum[::-1].tolist()


def test_multisets_read_across_packages(tmp_path):
    """Multiset levels written by one package load with the other's
    ``load_multiset_block``, and the other's ``UniqueBlockLabels`` reads
    them (the multiset variant: no dense volume read)."""
    from cluster_tools_tpu.workflows.label_multisets import \
        load_multiset_block as jax_load
    from cluster_tools_tpu_torch.workflows.label_multisets import \
        load_multiset_block as port_load

    labels = _labels(seed=3)
    factors = [[2, 2, 2], [1, 2, 2]]
    _both(tmp_path, lambda e: _multisets(e, labels, factors))
    jax_path = str(tmp_path / "jax" / "d.n5")
    port_path = str(tmp_path / "torch" / "d.n5")
    for key in ("multisets/s1", "multisets/s2"):
        n_blocks = len(os.listdir(os.path.join(jax_path, key))) - 1
        for bid in range(n_blocks):
            for a, b in zip(port_load(jax_path, key, bid),
                            jax_load(port_path, key, bid)):
                np.testing.assert_array_equal(a, b)
    uniques = {}
    for env, src in ((_env("torch", str(tmp_path / "t2")), jax_path),
                     (_env("jax", str(tmp_path / "j2")), port_path)):
        ub = env.pt.UniqueBlockLabels(
            input_path=src, input_key="multisets/s1", output_path=env.path,
            output_key="uniques_s1", from_multiset=True, **env.common)
        assert env.M.build([ub], raise_on_failure=True)
        uniques[env.root] = _chunks(env, env.path, "uniques_s1")
    a, b = uniques.values()
    _assert_chunks_equal(a, b)
    bs = _env("torch", str(tmp_path / "t3")).Varlen(
        os.path.join(port_path, "multisets/s1"), mode="r").attrs["blockShape"]
    np.testing.assert_array_equal(
        a[(0,)], np.unique(labels[:bs[0] * 2, :bs[1] * 2, :bs[2] * 2]))


# ---------------------------------------------------------------------------
# Paintera conversion
# ---------------------------------------------------------------------------

def _attrs(env, path, key):
    with env.M.file_reader(path, "r") as f:
        return _user_attrs(f[key].attrs if key else f.attrs)


def _paintera(env, seg, assignments, factors, max_id):
    _write(env, "seg", seg, max_id=max_id)
    out = os.path.join(env.root, "paintera.n5")
    assign_path = os.path.join(env.root, "assign.npy")
    np.save(assign_path, assignments)
    wf = env.pt.PainteraConversionWorkflow(
        input_path=env.path, input_key="seg", path=out,
        label_group="labels", scale_factors=factors,
        assignment_path=assign_path, resolution=(40.0, 4.0, 4.0),
        offset=(8.0, 0.0, 4.0), **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    res = {"data": {}, "uniques": {}, "lookup": {}, "attrs": {}}
    with env.M.file_reader(out, "r") as f:
        for s in range(len(factors) + 1):
            res["data"][s] = f[f"labels/data/s{s}"][:]
        res["pairs"] = f["labels/fragment-segment-assignment"][:]
    for s in range(len(factors) + 1):
        res["uniques"][s] = _chunks(env, out, f"labels/unique-labels/s{s}")
        res["lookup"][s] = _chunks(
            env, out, f"labels/label-to-block-mapping/s{s}")
        res["attrs"][f"s{s}"] = _attrs(env, out, f"labels/data/s{s}")
    for key in ("labels", "labels/data", ""):
        a = _attrs(env, out, key)
        if "labelBlockLookup" in a:
            assert a["labelBlockLookup"]["root"] == os.path.abspath(out)
            a["labelBlockLookup"] = dict(a["labelBlockLookup"], root=None)
        res["attrs"][key] = a
    return res


@pytest.mark.parametrize("case", ["reference", "random"])
def test_paintera_conversion_matches_jax(tmp_path, case):
    """The JAX package's test_paintera_conversion (``reference``) and a
    random label volume with the card run's scale factors: the pyramid,
    the unique labels, the lookup, the pairs and the metadata equal to the
    JAX package's."""
    if case == "reference":
        seg = np.zeros((16, 16, 16), "uint64")
        seg[:, :8, :] = 1
        seg[:, 8:, :] = 2
        assignments = np.array([0, 10, 10], "uint64")
        factors = [[2, 2, 2]]
    else:
        seg = _labels(shape=(16, 20, 24), n=15, seed=4)
        assignments = np.random.RandomState(5).randint(
            1, 6, 15).astype("uint64")
        assignments[0] = 0
        factors = [[1, 2, 2], [1, 2, 2], [2, 2, 2]]
    max_id = int(seg.max())
    jax_r, port_r = _both(
        tmp_path, lambda e: _paintera(e, seg, assignments, factors, max_id))
    for s in jax_r["data"]:
        assert port_r["data"][s].dtype == jax_r["data"][s].dtype
        np.testing.assert_array_equal(port_r["data"][s], jax_r["data"][s])
        _assert_chunks_equal(jax_r["uniques"][s], port_r["uniques"][s])
        _assert_chunks_equal(jax_r["lookup"][s], port_r["lookup"][s])
    np.testing.assert_array_equal(port_r["pairs"], jax_r["pairs"])
    assert port_r["attrs"] == jax_r["attrs"]

    np.testing.assert_array_equal(port_r["data"][0], seg)
    # label-safe downsampling: s1 samples s0 at the window centers
    f1 = factors[0]
    centers = [np.minimum(np.arange(-(-n // f)) * f + f // 2, n - 1)
               for n, f in zip(seg.shape, f1)]
    np.testing.assert_array_equal(port_r["data"][1], seg[np.ix_(*centers)])
    attrs = port_r["attrs"]
    assert attrs["labels"]["painteraData"] == {"type": "label"}
    assert attrs["labels"]["maxId"] == max_id
    assert attrs["labels/data"]["multiScale"] is True
    assert attrs["labels/data"]["resolution"] == [4.0, 4.0, 40.0]
    assert attrs["labels/data"]["offset"] == [4.0, 0.0, 8.0]
    assert attrs["s1"]["downsamplingFactors"] == f1[::-1]
    pairs = port_r["pairs"]
    assert pairs.shape[0] == 2
    if case == "reference":
        assert pairs[1, 0] == pairs[1, 1]
    # the lookup of s0 lists the blocks holding each label
    from cluster_tools_tpu_torch.core.blocking import Blocking

    blocking = Blocking(list(seg.shape), [8, 8, 8])
    for lab in np.unique(seg):
        want = [b for b in range(blocking.n_blocks)
                if (seg[blocking.get_block(b).bb] == lab).any()]
        np.testing.assert_array_equal(
            np.sort(port_r["lookup"][0][(int(lab),)]), want)


def test_paintera_group_reads_across_packages(tmp_path):
    """A Paintera group written by one package: the other's
    ``label_to_blocks`` and ``load_fragment_segment_assignment`` read it,
    and ``pairs_to_table`` inverts the pairs to the table."""
    from cluster_tools_tpu.workflows import paintera as J
    from cluster_tools_tpu_torch.workflows import paintera as P

    seg = _labels(shape=(16, 16, 16), n=10, seed=6)
    assignments = np.arange(10, dtype="uint64") // 3
    _both(tmp_path, lambda e: _paintera(e, seg, assignments, [[2, 2, 2]],
                                        int(seg.max())))
    jax_out = str(tmp_path / "jax" / "paintera.n5")
    port_out = str(tmp_path / "torch" / "paintera.n5")
    for lab in np.unique(seg):
        for s in (0, 1):
            key = f"labels/label-to-block-mapping/s{s}"
            a = P.label_to_blocks(jax_out, key, int(lab))
            b = J.label_to_blocks(port_out, key, int(lab))
            np.testing.assert_array_equal(a, b)
    a = P.load_fragment_segment_assignment(jax_out, "labels")
    b = J.load_fragment_segment_assignment(port_out, "labels")
    np.testing.assert_array_equal(a, b)
    table = P.pairs_to_table(a, n_labels=10)
    table[0] = assignments[0]
    np.testing.assert_array_equal(table, assignments)


def test_paintera_conversion_needs_the_device_setting(tmp_path):
    """The conversion's ``DownscaleTask`` runs on the global config's
    device: the workflow defaults to target ``gpu`` and, without
    ``"device": "cpu"`` on a host without a card, raises before any work
    runs."""
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    wf = ctp.PainteraConversionWorkflow(
        input_path="a.n5", input_key="s", path="p.n5", label_group="l",
        scale_factors=[[2, 2, 2]], tmp_folder=str(tmp_path / "tmp"),
        config_dir=str(tmp_path / "cfg"))
    assert wf.target == "gpu"
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    ConfigDir(str(tmp_path / "cfg")).write_global_config(
        {"block_shape": [8, 8, 8]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctp.build([wf])


# ---------------------------------------------------------------------------
# BigCat export
# ---------------------------------------------------------------------------

def _bigcat(env, seg, assignments, out_name):
    _write(env, "seg", seg)
    out = os.path.join(env.root, out_name)
    assign_path = os.path.join(env.root, "assign.npy")
    np.save(assign_path, assignments)
    wf = env.pt.BigcatWorkflow(
        input_path=env.path, input_key="seg", output_path=out,
        assignment_path=assign_path, assignment_key=None,
        resolution=(40.0, 4.0, 4.0), **env.common)
    assert env.M.build([wf], raise_on_failure=True)
    with env.M.file_reader(out, "r") as f:
        return (f["volumes/labels/fragments"][:], f["fragment_segment_lut"][:],
                _user_attrs(f["volumes/labels/fragments"].attrs),
                _user_attrs(f.attrs))


@pytest.mark.parametrize("out_name", ["bigcat.n5", "bigcat.zarr"])
def test_bigcat_export_matches_jax(tmp_path, out_name):
    """The JAX package's test_bigcat_export, into N5 and zarr (its HDF5
    case: ``test_bigcat_export_to_hdf5_matches_jax``): the fragments, the lookup table and the attributes equal the JAX
    package's."""
    seg = np.ones((8, 8, 8), "uint64")
    seg[:, 4:, :] = 2
    assignments = np.array([0, 5, 5], "uint64")
    jax_r, port_r = _both(tmp_path,
                          lambda e: _bigcat(e, seg, assignments, out_name))
    for a, b in zip(jax_r, port_r):
        if isinstance(a, dict):
            assert b == a
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    frags, lut, ds_attrs, root_attrs = port_r
    np.testing.assert_array_equal(frags, seg)
    assert lut.shape[0] == 2
    assert "next_id" in root_attrs
    assert ds_attrs["resolution"] == [40.0, 4.0, 4.0]


def test_bigcat_export_to_hdf5_matches_jax(tmp_path):
    """The JAX package's test_bigcat_export: into HDF5, written by the
    port's own writer (``core/hdf5.py``) and by h5py in the JAX package.
    The fragments, the lookup table and the attributes (values and
    dtypes) equal the JAX package's, read through either package."""
    seg = np.ones((8, 8, 8), "uint64")
    seg[:, 4:, :] = 2
    assignments = np.array([0, 5, 5], "uint64")
    jax_r, port_r = _both(tmp_path,
                          lambda e: _bigcat(e, seg, assignments, "bigcat.h5"))
    for a, b in zip(jax_r, port_r):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
                np.testing.assert_array_equal(b[k], a[k])
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    frags, lut, ds_attrs, root_attrs = port_r
    np.testing.assert_array_equal(frags, seg)
    assert lut.shape[0] == 2 and root_attrs["next_id"] == int(lut.max()) + 1
    np.testing.assert_array_equal(ds_attrs["resolution"], [40.0, 4.0, 4.0])
    import h5py

    with h5py.File(str(tmp_path / "torch" / "bigcat.h5"), "r") as f:
        np.testing.assert_array_equal(f["volumes/labels/fragments"][:], seg)
        np.testing.assert_array_equal(f["fragment_segment_lut"][:], lut)
        assert f.attrs["next_id"] == root_attrs["next_id"]
