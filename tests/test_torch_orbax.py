"""The port's restore of the JAX package's orbax train states on the CPU.

The port reads orbax's layout without orbax, tensorstore, JAX or
ml_dtypes: ``core/ocdbt.py`` (tensorstore's OCDBT key-value store),
``core/storage.py``'s zarr v2 arrays over it, ``models/orbax.py`` (the
tree) and ``models/checkpoint.py`` ``restore_train_state``.  Held here
against tensorstore, orbax and the JAX package:

* on the committed fixtures of ``tests/data/torch_train_states/`` (each
  the JAX package's ``save_train_state`` after one JAX step, unsharded
  and from the 8-device CPU mesh; ``make_fixtures.py`` wrote them), on
  their per-process sub-databases, on directories written here by the
  JAX package's ``save_train_state`` and on stores tensorstore writes
  with interior B+tree nodes, data-file values, no compression and
  version-tree nodes: ``list()`` and every value byte for byte as
  tensorstore's ``ocdbt`` driver;
* the port's ``restore_train_state`` bitwise equal to
  ``train_state_from_flax`` of the JAX package's ``restore_train_state``
  (parameters, both Adam moments, count and step), unsharded and onto
  the port's 8-shard CPU mesh, also for a ``use_ocdbt=False`` save;
* the step after a restore against the JAX package, with
  ``tests/test_torch_train.py``'s gates: the float32 loss at rtol 1e-5
  (its gate for float32 losses summed in different orders; its 1e-6
  gate for the JAX package's loss holds at its (2, 8, 16, 16) batch, and
  this (2, 8, 32, 32) batch sums 4 times as many terms: 1.6e-6 here),
  the gradients at rtol 1e-4 / atol 1e-7, the AdamW update from the same
  gradients and the restored moments at 1e-7 absolute, and the loss of
  the bfloat16 U-Net (the JAX package's compute type) at rtol 2e-2;
* a flipped byte in a manifest or a node, or a data file path that
  leaves the database's directory, raises ``OSError`` naming the file;
  an unknown format version, compression, value kind or manifest
  kind raises ``NotImplementedError`` naming it; a ``bfloat16`` leaf
  reads as ``torch.bfloat16``.
"""

import json
import os
import shutil
import struct
import time

import google_crc32c
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import SingleDeviceSharding

torch.set_num_threads(2)

from cluster_tools_tpu.models import checkpoint as jckpt  # noqa: E402
from cluster_tools_tpu.models import train as jtrain  # noqa: E402
from cluster_tools_tpu.models.unet import UNet3D as JUNet3D  # noqa: E402
from cluster_tools_tpu.models.unet import create_unet as jcreate  # noqa: E402
from cluster_tools_tpu.parallel import mesh as jmesh  # noqa: E402
from cluster_tools_tpu_torch.core import ocdbt  # noqa: E402
from cluster_tools_tpu_torch.core.storage import (  # noqa: E402
    file_reader, open_zarr_array)
from cluster_tools_tpu_torch.models import checkpoint as pckpt  # noqa: E402
from cluster_tools_tpu_torch.models import orbax as porbax  # noqa: E402
from cluster_tools_tpu_torch.models import train as ptrain  # noqa: E402
from cluster_tools_tpu_torch.models.unet import create_unet  # noqa: E402
from cluster_tools_tpu_torch.parallel import mesh as pmesh  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "data",
                        "torch_train_states")
NAMES = ("unsharded", "sharded")
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 2e-2
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
UPDATE_ATOL = 1e-7


def _meta(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        return json.load(f)


def _batch(meta):
    """x and y of the fixture's batch, channels last."""
    b, d, h, w = meta["batch"]["shape"]
    x = np.random.RandomState(meta["batch"]["x_seed"]).rand(
        b, d, h, w, 1).astype("float32")
    y = (np.random.RandomState(meta["batch"]["y_seed"]).rand(
        b, d, h, w, 3) > 0.5).astype("float32")
    return x, y


def _cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _jax_model(meta, dtype=jnp.bfloat16):
    model = jcreate(**meta["model"])
    return model if dtype == jnp.bfloat16 else JUNet3D(
        out_channels=model.out_channels, features=model.features,
        scale_factors=model.scale_factors, dtype=dtype)


def _jax_abstract(meta, sharded):
    """The JAX package's abstract TrainState of the fixture's model, on
    one CPU device or the 8-device mesh (its placements)."""
    _, d, h, w = meta["batch"]["shape"]
    model = _jax_model(meta)
    shapes = jax.eval_shape(
        lambda: jtrain.init_state(model, (1, d, h, w, 1)))
    if sharded:
        mesh = jmesh.make_mesh(8)
        shard = jtrain.TrainState(jmesh.param_sharding(mesh, shapes.params),
                                  jmesh.param_sharding(mesh,
                                                       shapes.opt_state),
                                  jmesh.replicated(mesh))
    else:
        one = SingleDeviceSharding(jax.devices()[0])
        shard = jax.tree_util.tree_map(lambda _: one, shapes)
    return jax.tree_util.tree_map(
        lambda a, s: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=s),
        shapes, shard)


def _jax_restore(path, meta, sharded=False):
    """The JAX package's restore, as numpy trees."""
    state = jckpt.restore_train_state(os.path.abspath(path),
                                      _jax_abstract(meta, sharded))
    return jax.tree_util.tree_map(np.asarray, state)


def _port_abstract(meta, sharded, dtype=torch.float32):
    """(model, abstract state, batch placement or None): the port's
    state of the fixture's model, whole on the CPU or on 8 CPU shards."""
    _, d, h, w = meta["batch"]["shape"]
    model = create_unet(**meta["model"], dtype=dtype)
    state = ptrain.init_state(model, (1, 1, d, h, w), device="cpu")
    if not sharded:
        return model, state, None
    mesh = pmesh.make_mesh(devices=pmesh.shard_devices("cpu", 8))
    _, state, pl = ptrain.shard_train_step(model, state, mesh)
    return model, state, pl


def _trees(state):
    return (state.params, state.opt_state.mu, state.opt_state.nu)


def _assert_same_state(got, want):
    """Bitwise: every tensor (or shard), the count and the step."""
    assert got.step == want.step and \
        got.opt_state.count == want.opt_state.count
    for g, w in zip(_trees(got), _trees(want)):
        assert set(g) == set(w)
        for k in w:
            gs = g[k] if isinstance(g[k], list) else [g[k]]
            ws = w[k] if isinstance(w[k], list) else [w[k]]
            assert len(gs) == len(ws), k
            for a, b in zip(gs, ws):
                assert a.dtype == b.dtype and a.device == b.device, k
                assert torch.equal(a, b), k


def _tensorstore(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(path)}/"}
                         ).result()
    keys = sorted(kv.list().result())
    return keys, {k: bytes(kv.read(k).result().value) for k in keys}


def _assert_reads_as_tensorstore(path):
    keys, values = _tensorstore(path)
    store = ocdbt.OcdbtStore(path)
    assert store.list() == keys
    assert keys
    for k in keys:
        assert store.read(k) == values[k], k
    assert store.get(b"no such key") is None
    with pytest.raises(KeyError):
        store.read("zzz/.zarray")


@pytest.fixture(scope="module")
def jax_states():
    """name -> the JAX package's restore of the fixture (numpy trees)."""
    return {n: _jax_restore(os.path.join(FIXTURES, n), _meta(n),
                            sharded=n == "sharded") for n in NAMES}


# ---------------------------------------------------------------------------
# the OCDBT reader against tensorstore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", [
    "unsharded", "sharded", "unsharded/ocdbt.process_0",
    "sharded/ocdbt.process_0"])
def test_ocdbt_reads_fixtures_as_tensorstore(store):
    """The merged top-level tree (its values in ``ocdbt.process_0/d/``)
    and the per-process database with its five versions."""
    _assert_reads_as_tensorstore(os.path.join(FIXTURES, store))


def _ts_store(path, config, batches):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    for batch in batches:
        with ts.Transaction() as txn:
            for k, v in batch.items():
                kv.with_transaction(txn)[k] = v
    return kv


#: (config, number of commits, keys per commit) of stores tensorstore
#: writes: interior nodes and values in data files (small nodes, small
#: inline limit, zstd level 5); no compression and version-tree nodes
#: (arity 2, 20 commits)
WRITTEN = {
    "btree": ({"max_decoded_node_bytes": 2000, "max_inline_value_bytes": 30,
               "compression": {"id": "zstd", "level": 5}}, 1, 300),
    "versions": ({"compression": None, "version_tree_arity_log2": 1}, 20,
                 7),
}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_ocdbt_reads_written_stores_as_tensorstore(case, tmp_path):
    config, commits, n = WRITTEN[case]
    path = str(tmp_path / case)
    _ts_store(path, config, [
        {f"key/{c:03d}/{i:05d}": bytes([i % 251]) * (10 + i % 50)
         for i in range(n)} for c in range(commits)])
    _assert_reads_as_tensorstore(path)


def test_ocdbt_empty_store(tmp_path):
    """A database whose newest version holds no key (the root's
    location is the missing sentinel)."""
    path = str(tmp_path / "empty")
    kv = _ts_store(path, {}, [{"a": b"1"}])
    kv.delete_range(ts.KvStore.KeyRange()).result()
    assert _tensorstore(path)[0] == []
    store = ocdbt.OcdbtStore(path)
    assert store.list() == []
    assert store.get("a") is None


# ---------------------------------------------------------------------------
# restore against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("layout", ["whole", "mesh8"])
def test_restore_equals_jax_restore(name, layout, jax_states):
    meta = _meta(name)
    want = pckpt.train_state_from_flax(jax_states[name], device="cpu")
    _, abstract, _ = _port_abstract(meta, layout == "mesh8")
    got = pckpt.restore_train_state(os.path.join(FIXTURES, name), abstract)
    assert got.step == 1 and got.opt_state.count == 1
    assert got.config == abstract.config
    assert got.optimizer == abstract.optimizer
    if layout == "mesh8":
        assert got.sharded and got.mesh is abstract.mesh
        assert got.placements == abstract.placements
        want = ptrain.place_state(want, abstract.mesh, abstract.placements)
    _assert_same_state(got, want)


def test_restore_fresh_checkpoints(tmp_path, jax_states):
    """A state the JAX package saves here (the fixture's, changed), with
    and without OCDBT: both read as tensorstore and orbax read them,
    bitwise."""
    meta = _meta("unsharded")
    base = jax_states["unsharded"]
    state = jtrain.TrainState(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a * 1.5), base.params),
        jax.tree_util.tree_map(jnp.asarray, base.opt_state),
        jnp.asarray(base.step + 6))
    fresh = str(tmp_path / "fresh")
    jckpt.save_train_state(fresh, state)
    flat = str(tmp_path / "flat")
    with ocp.Checkpointer(ocp.StandardCheckpointHandler(
            use_ocdbt=False)) as ck:
        ck.save(flat, state)
    with open(os.path.join(flat, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False
    assert not os.path.exists(os.path.join(flat, "manifest.ocdbt"))
    _assert_reads_as_tensorstore(fresh)
    want = pckpt.train_state_from_flax(_jax_restore(fresh, meta),
                                       device="cpu")
    assert want.step == 7
    _, abstract, _ = _port_abstract(meta, False)
    for path in (fresh, flat):
        _assert_same_state(pckpt.restore_train_state(path, abstract), want)
    _, abstract8, _ = _port_abstract(meta, True)
    _assert_same_state(pckpt.restore_train_state(flat, abstract8),
                       ptrain.place_state(want, abstract8.mesh,
                                          abstract8.placements))


@pytest.mark.parametrize("layout", ["whole", "mesh8"])
def test_restore_full_width_state(layout, tmp_path):
    """The U-Net at its full width (``create_unet()``'s defaults, as the
    JAX package trains it), saved here by the JAX package's
    ``save_train_state`` from one device or from the 8-device mesh: the
    port's restore, unsharded and onto its 8-shard mesh, bitwise equal
    to ``train_state_from_flax`` of the JAX package's restore.  Moments
    and step are made nonzero so that every leaf holds data.  The
    port's restore seconds on this host's CPU are printed (``-s``)."""
    sharded = layout == "mesh8"
    # the smallest input the anisotropic U-Net takes: its parameters do
    # not depend on the input's size
    meta = {"model": {}, "batch": {"shape": [1, 4, 8, 8]}}
    abstract = _jax_abstract(meta, sharded)
    rng = np.random.RandomState(3)
    state = jax.tree_util.tree_map(
        lambda a: jax.device_put(
            rng.standard_normal(a.shape).astype(a.dtype) if a.ndim
            else np.asarray(5, a.dtype), a.sharding), abstract)
    path = str(tmp_path / layout)
    jckpt.save_train_state(path, state)
    want = pckpt.train_state_from_flax(_jax_restore(path, meta, sharded),
                                       device="cpu")
    assert want.step == 5 and want.opt_state.count == 5
    assert sum(v.numel() for v in want.params.values()) > 10 ** 6
    for port_sharded in (False, True):
        _, port_abstract, _ = _port_abstract(meta, port_sharded)
        t0 = time.perf_counter()
        got = pckpt.restore_train_state(path, port_abstract)
        print(f"full-width {layout} restore onto "
              f"{'8 shards' if port_sharded else 'one device'}: "
              f"{time.perf_counter() - t0:.3f} s")
        _assert_same_state(got, ptrain.place_state(
            want, port_abstract.mesh, port_abstract.placements)
            if port_sharded else want)


def test_step_after_restore_matches_jax(jax_states):
    """The unsharded fixture: the port's float32 loss and gradients
    against ``jax.value_and_grad`` from the same restored parameters,
    the AdamW update of JAX's gradients from the restored moments
    against optax's, and the whole step's losses (float32 and the JAX
    package's bfloat16) against those the fixture recorded."""
    meta = _meta("unsharded")
    x, y = _batch(meta)
    jstate = jax_states["unsharded"]
    jmodel = _jax_model(meta, jnp.float32)

    def loss_fn(p):
        return jtrain.affinity_loss(jmodel.apply(p, x), y)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    np.testing.assert_allclose(float(jloss), meta["next_loss_float32"],
                               rtol=1e-6)
    model, abstract, _ = _port_abstract(meta, False)
    state = pckpt.restore_train_state(os.path.join(FIXTURES, "unsharded"),
                                      abstract)
    loss, grads = ptrain.loss_and_grads(model, state.params, _cf(x), _cf(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = pckpt.state_dict_to_flax_params(grads)
    want = pckpt._flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    opt = jtrain.make_optimizer()
    jopt = jax.tree_util.tree_map(jnp.asarray, jstate.opt_state)
    jup, jopt2 = opt.update(jgrads, jopt, jstate.params)
    pup, popt2 = ptrain.make_optimizer().update(
        pckpt.flax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jgrads)),
        state.opt_state, state.params)
    assert popt2.count == int(jopt2[0].count) == 2
    got = pckpt.state_dict_to_flax_params(pup)
    for k, v in pckpt._flatten(jax.tree_util.tree_map(np.asarray,
                                                      jup)).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=UPDATE_ATOL,
                                   err_msg=k)
    s2, l2 = ptrain.make_train_step(model)(state, _cf(x), _cf(y))
    assert s2.step == 2 and s2.opt_state.count == 2
    np.testing.assert_allclose(float(l2), meta["next_loss_float32"],
                               rtol=LOSS_RTOL)
    bf16, abstract16, _ = _port_abstract(meta, False, torch.bfloat16)
    state16 = pckpt.restore_train_state(
        os.path.join(FIXTURES, "unsharded"), abstract16)
    _, l16 = ptrain.make_train_step(bf16)(state16, _cf(x), _cf(y))
    np.testing.assert_allclose(float(l16), meta["next_loss"],
                               rtol=BF16_LOSS_RTOL)


def test_sharded_step_after_restore_matches_jax():
    """The sharded fixture restored onto the port's 8-shard CPU mesh:
    one sharded step's float32 and bfloat16 losses against those the
    JAX package recorded."""
    meta = _meta("sharded")
    x, y = _batch(meta)
    for dtype, key, rtol in ((torch.float32, "next_loss_float32",
                              LOSS_RTOL),
                             (torch.bfloat16, "next_loss", BF16_LOSS_RTOL)):
        model, abstract, pl = _port_abstract(meta, True, dtype)
        state = pckpt.restore_train_state(os.path.join(FIXTURES, "sharded"),
                                          abstract)
        step = ptrain.make_sharded_step(model)
        s2, loss = step(state, pmesh.shard(_cf(x), state.mesh, pl),
                        pmesh.shard(_cf(y), state.mesh, pl))
        assert s2.step == 2 and s2.opt_state.count == 2 and s2.sharded
        np.testing.assert_allclose(float(loss), meta[key], rtol=rtol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# what the reader refuses
# ---------------------------------------------------------------------------

def _copy(tmp_path, name="unsharded"):
    dst = str(tmp_path / name)
    shutil.copytree(os.path.join(FIXTURES, name), dst)
    return dst


def _root_node(path):
    """The top-level tree's root: the one file of ``d/``."""
    (name,) = os.listdir(os.path.join(path, "d"))
    return os.path.join(path, "d", name)


def _flip(path, at):
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        data[at] ^= 0x10
        f.seek(0)
        f.write(data)


def _refresh_crc(data: bytearray) -> bytearray:
    data[-4:] = struct.pack("<I", google_crc32c.value(bytes(data[:-4])))
    return data


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_flipped_byte_raises_oserror_naming_the_file(target, tmp_path):
    path = _copy(tmp_path)
    victim = os.path.join(path, "manifest.ocdbt") if target == "manifest" \
        else _root_node(path)
    _flip(victim, os.path.getsize(victim) // 2)
    _, abstract, _ = _port_abstract(_meta("unsharded"), False)
    for fn in (lambda: ocdbt.OcdbtStore(path).list(),
               lambda: pckpt.restore_train_state(path, abstract)):
        with pytest.raises(OSError, match="checksum mismatch") as err:
            fn()
        assert victim in str(err.value)


@pytest.mark.parametrize("layout", ["ocdbt", "directory"])
def test_data_file_outside_the_directory_raises(layout, tmp_path):
    """A path out of the checkpoint's directory raises ``OSError``: in
    OCDBT, a manifest (written uncompressed, its checksum valid) whose
    data file path climbs out; with ``use_ocdbt=False``, a ``_METADATA``
    key that names a leaf beside the directory (a real one, so the read
    would succeed)."""
    if layout == "directory":
        path = str(tmp_path / "flat")
        with ocp.Checkpointer(ocp.StandardCheckpointHandler(
                use_ocdbt=False)) as ck:
            ck.save(path, {"w": np.arange(3), "b": np.ones(2)})
        shutil.copytree(os.path.join(path, "w"), str(tmp_path / "out"))
        victim = os.path.join(path, "_METADATA")
        with open(victim) as f:
            meta = json.load(f)
        for key in ("../out", "/out"):
            meta["tree_metadata"]["('w',)"]["key_metadata"][0]["key"] = key
            with open(victim, "w") as f:
                json.dump(meta, f)
            with pytest.raises(OSError, match="leaves the directory") as err:
                porbax.read_tree(path)
            assert path in str(err.value) and key in str(err.value)
        return
    import zstandard

    path = _copy(tmp_path)
    victim = os.path.join(path, "manifest.ocdbt")
    with open(victim, "rb") as f:
        data = f.read()
    body = zstandard.ZstdDecompressor().decompressobj().decompress(
        data[14:-4])
    name = os.path.basename(_root_node(path)).encode()
    assert body.count(b"d/" + name) == 1
    body = body.replace(b"d/" + name, b"../" + name[1:])
    frame = bytearray(data[:12] + b"\x00\x00" + body + b"\x00" * 4)
    frame[4:12] = struct.pack("<Q", len(frame))
    with open(victim, "wb") as f:
        f.write(_refresh_crc(frame))
    with pytest.raises(OSError, match="data file path") as err:
        ocdbt.OcdbtStore(path)
    assert victim in str(err.value)


@pytest.mark.parametrize("field,value,match", [
    (13, 7, "OCDBT compression 7"), (12, 1, "OCDBT format version 1")])
def test_unknown_framing_raises_not_implemented(field, value, match,
                                                tmp_path):
    """A manifest or node whose header names a compression or format
    version the reader does not know (the checksum made valid)."""
    path = _copy(tmp_path)
    for victim in (os.path.join(path, "manifest.ocdbt"), _root_node(path)):
        with open(victim, "rb") as f:
            data = bytearray(f.read())
        keep = bytes(data)
        data[field] = value
        with open(victim, "wb") as f:
            f.write(_refresh_crc(data))
        with pytest.raises(NotImplementedError, match=match) as err:
            ocdbt.OcdbtStore(path).list()
        assert victim in str(err.value)
        with open(victim, "wb") as f:
            f.write(keep)


def test_unknown_value_kind_and_manifest_kind(tmp_path):
    """A leaf's value kind 2 (its checksum made valid) and tensorstore's
    numbered manifests raise by name."""
    path = str(tmp_path / "raw")
    _ts_store(path, {"compression": None}, [{"k": b"v"}])
    node = ocdbt.OcdbtStore(path)._root[0]
    victim = os.path.join(path, node.file.path)
    with open(victim, "rb") as f:
        data = bytearray(f.read())
    frame = data[node.offset:node.offset + node.length]
    # the leaf's body: one key "k", value length 1, kind 0, the value "v"
    at = bytes(frame).index(b"k\x01\x00v") + 2
    frame[at] = 2
    data[node.offset:node.offset + node.length] = _refresh_crc(frame)
    with open(victim, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match="value kind 2"):
        ocdbt.OcdbtStore(path).list()
    numbered = str(tmp_path / "numbered")
    _ts_store(numbered, {"manifest_kind": "numbered"}, [{"k": b"v"}])
    with pytest.raises(NotImplementedError, match="manifest kind 1"):
        ocdbt.OcdbtStore(numbered)


def test_not_a_checkpoint_and_zarr3_raise(tmp_path):
    _, abstract, _ = _port_abstract(_meta("unsharded"), False)
    with pytest.raises(FileNotFoundError, match="train_state.json") as err:
        pckpt.restore_train_state(str(tmp_path), abstract)
    assert "_CHECKPOINT_METADATA" in str(err.value)
    path = _copy(tmp_path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    meta["use_zarr3"] = True
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="use_zarr3"):
        pckpt.restore_train_state(path, abstract)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_tree_leaves_read_as_orbax_wrote_them(use_ocdbt, tmp_path):
    """A bfloat16 ``jax.Array`` reads as a ``torch.bfloat16`` tensor
    with the same bits; ``np.ndarray``, 0-d arrays (``chunks: []``, key
    ``0``) and Python scalars as orbax restores them."""
    w = (jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7).astype(
        jnp.bfloat16)
    tree = {"w": w, "b": np.arange(5, dtype=np.int64),
            "n": {"s": 3, "f": 2.5, "z": jnp.zeros((), jnp.int32)}}
    path = str(tmp_path / "tree")
    with ocp.Checkpointer(ocp.StandardCheckpointHandler(
            use_ocdbt=use_ocdbt)) as ck:
        ck.save(path, tree)
    got = porbax.read_tree(path)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy().view("<u2"),
                          np.asarray(w).view(np.uint16))
    assert got["b"].dtype == np.int64 and np.array_equal(got["b"],
                                                         np.arange(5))
    assert got["n"]["s"] == 3 and isinstance(got["n"]["s"], int)
    assert got["n"]["f"] == 2.5 and isinstance(got["n"]["f"], float)
    assert got["n"]["z"].shape == () and got["n"]["z"].dtype == np.int32


def test_bfloat16_zarr_directory_written_by_tensorstore(tmp_path):
    """``"dtype": "bfloat16"`` (tensorstore's name, which numpy rejects)
    on a zarr directory: the elements' uint16 bits, missing chunks 0
    under ``fill_value: null``."""
    data = (np.arange(48, dtype=np.float32).reshape(6, 8) / 3).astype(
        jnp.bfloat16)
    path = str(tmp_path / "x.zarr")
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                               "path": path + "/bf16"},
                 "metadata": {"shape": [6, 8], "chunks": [3, 4],
                              "dtype": "bfloat16",
                              "compressor": {"id": "zstd", "level": 1},
                              "fill_value": None},
                 "create": True}).result()
    t[:3] = data[:3]
    with open(os.path.join(path, "bf16", ".zarray")) as f:
        assert json.load(f)["dtype"] == "bfloat16"
    with file_reader(path, "r") as f:
        ds = f["bf16"]
        got = ds[...]
    assert ds.bfloat16 and got.dtype == np.uint16
    want = np.asarray(data).view(np.uint16).copy()
    want[3:] = 0
    assert np.array_equal(got, want)
    bits = torch.from_numpy(got).view(torch.bfloat16)
    assert torch.equal(bits[:3].float(),
                       torch.from_numpy(np.asarray(data[:3], np.float32)))
    # a fill value other than null and 0 would be read as uint16 bits
    ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                           "path": path + "/filled"},
             "metadata": {"shape": [4], "chunks": [2], "dtype": "bfloat16",
                          "fill_value": 1.5},
             "create": True}).result()
    with file_reader(path, "r") as f:
        with pytest.raises(NotImplementedError, match="fill value 1.5"):
            f["filled"]
    # an array read through a key-value store is read only
    ds = open_zarr_array(ocdbt.OcdbtStore(os.path.join(FIXTURES,
                                                       "unsharded")), "2")
    assert ds.shape == () and int(ds[...]) == 1
    with pytest.raises(NotImplementedError, match="read only"):
        ds[...] = 0
