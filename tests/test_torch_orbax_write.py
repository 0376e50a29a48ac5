"""The port's orbax train states, written without orbax, on the CPU.

``models/checkpoint.py`` ``save_train_state`` writes what the JAX
package's ``save_train_state`` writes: an orbax ``StandardCheckpointHandler``
directory of zarr v2 arrays in an OCDBT store, through the port's own
Zstandard frame writer (``core/codecs.py``), OCDBT writer
(``core/ocdbt.py``), zarr arrays over a key-value store
(``core/storage.py``) and tree writer (``models/orbax.py``).  Held here
against libzstd, tensorstore, orbax and the JAX package:

* zstd frames of empty, one-byte, all-zero, random and >128 KiB inputs:
  the port's decoder, libzstd (the ``zstandard`` module) and tensorstore
  (the frame as a zarr chunk; a chunk is never empty, so the empty frame
  goes through the port and libzstd only) give back the input, byte for
  byte;
* OCDBT stores of the writer (many keys with shared prefixes, inline and
  data-file values, interior nodes, an empty store, a top-level manifest
  over ``ocdbt.process_0/``) list and read key for key the same through
  tensorstore's ``ocdbt`` driver and the port's ``OcdbtStore``; a flipped
  byte raises ``OSError``;
* the JAX package's ``restore_train_state`` of the port's saves, from one
  device and from the 8-shard ``(2, 2, 2)`` mesh, unsharded and onto its
  8-device mesh: bitwise equal to ``train_state_to_flax`` of the port's
  state, for the ``(4, 8)`` U-Net after one step and for the full-width
  U-Net;
* ``_METADATA``, ``array_metadatas/process_0``, every ``.zarray``, the
  keys tensorstore lists, ``_sharding`` (as JSON) and
  ``_CHECKPOINT_METADATA`` (but its times) equal those of the JAX
  package's own save of the same state on the same placement;
* the JAX package's next step from a restored port save gives the port's
  next loss within ``tests/test_torch_orbax.py``'s gates: rtol 1e-5 in
  float32, 2e-2 in bfloat16;
* the port's earlier layout (``port_layout/``, made by
  ``make_port_layout.py``) still restores bitwise, and its next sharded
  step gives the loss recorded beside it at rtol 1e-6 (the port's own
  step on the same inputs);
* a save replaces the directory that is there; a save that fails leaves
  it as it was and no temporary directory behind.
"""

import base64
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from jax.sharding import NamedSharding, PartitionSpec, SingleDeviceSharding

torch.set_num_threads(2)

from cluster_tools_tpu.models import checkpoint as jckpt  # noqa: E402
from cluster_tools_tpu.models import train as jtrain  # noqa: E402
from cluster_tools_tpu.parallel import mesh as jmesh  # noqa: E402
from cluster_tools_tpu_torch.core import codecs, ocdbt  # noqa: E402
from cluster_tools_tpu_torch.core.storage import (  # noqa: E402
    DirectoryKV, create_zarr_array)
from cluster_tools_tpu_torch.models import checkpoint as pckpt  # noqa: E402
from cluster_tools_tpu_torch.models import orbax as porbax  # noqa: E402
from cluster_tools_tpu_torch.models import train as ptrain  # noqa: E402
from cluster_tools_tpu_torch.models.unet import create_unet  # noqa: E402
from cluster_tools_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from test_torch_orbax import (BF16_LOSS_RTOL, FIXTURES,  # noqa: E402
                              LOSS_RTOL, _assert_reads_as_tensorstore,
                              _assert_same_state, _batch, _cf,
                              _jax_abstract, _jax_model, _meta,
                              _port_abstract, _tensorstore)

LAYOUTS = ("whole", "mesh8")
#: the port's step against itself on the same inputs
PORT_LOSS_RTOL = 1e-6


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


# ---------------------------------------------------------------------------
# zstd frames
# ---------------------------------------------------------------------------

def _zstd_inputs():
    rng = np.random.RandomState(0)
    mixed = bytearray(rng.bytes(300_000))
    mixed[100_000:280_000] = bytes(180_000)  # covers the block at 128 KiB
    return {"empty": b"", "one_byte": b"\x07", "zeros": bytes(300_000),
            "random": rng.bytes(1000), "random_3_blocks": rng.bytes(300_000),
            "one_block": rng.bytes(128 * 1024), "mixed": bytes(mixed)}


@pytest.mark.parametrize("case", sorted(_zstd_inputs()))
def test_zstd_frames_decode_everywhere(case, tmp_path):
    plain = _zstd_inputs()[case]
    frame = codecs.zstd_compress(plain)
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == len(plain) and params.has_checksum
    assert codecs.zstd_decompress(frame, len(plain)).tobytes() == plain
    assert zstandard.ZstdDecompressor().decompressobj().decompress(
        frame) == plain
    # runs of one byte take RLE blocks: a frame of zeros is a few bytes
    if case == "zeros":
        assert len(frame) < 40
    elif case == "mixed":
        assert len(frame) < len(plain) - 131_000
    else:
        assert len(frame) <= len(plain) + 3 * 3 + 18
    if not plain:
        return
    # a zarr directory array written by the port: its chunk is the frame
    ds = create_zarr_array(DirectoryKV(str(tmp_path)), "a", [len(plain)],
                           [len(plain)], "|u1")
    ds[...] = np.frombuffer(plain, np.uint8)
    assert (tmp_path / "a" / "0").read_bytes() == frame
    got = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(tmp_path / "a")}}).result().read(
        ).result()
    assert got.tobytes() == plain


# ---------------------------------------------------------------------------
# the OCDBT writer against tensorstore
# ---------------------------------------------------------------------------

def _values(n, seed, sizes):
    rng = np.random.RandomState(seed)
    return {f"{i % 5}.params.ConvBlock_{i % 7}.Conv_{i % 2}/{i:05d}":
            rng.bytes(int(rng.randint(*sizes))) for i in range(n)}


#: (bounds of ORBAX_CONFIG to shrink, number of keys, value sizes): a leaf
#: of inline values and values in the data file; interior nodes (small
#: node and inline bounds); an empty store; the top-level manifest over a
#: sub-database
STORES = {
    "leaf": ({}, 600, (0, 3000)),
    "interior": ({"max_decoded_node_bytes": 2000,
                  "max_inline_value_bytes": 30}, 3000, (0, 80)),
    "empty": ({}, 0, (0, 1)),
    "process_0": ({}, 300, (0, 2500)),
}


@pytest.mark.parametrize("case", sorted(STORES))
def test_ocdbt_writer_reads_as_tensorstore(case, tmp_path, monkeypatch):
    config, n, sizes = STORES[case]
    for name, value in config.items():
        monkeypatch.setitem(ocdbt.ORBAX_CONFIG, name, value)
    want = _values(n, 1, sizes)
    path = str(tmp_path / case)
    sub = os.path.join(path, "ocdbt.process_0") if case == "process_0" \
        else path
    w = ocdbt.OcdbtWriter(sub)
    for k, v in want.items():
        w.put(k, v)
    assert w.get(next(iter(want))) == want[next(iter(want))] if want \
        else w.get("x") is None
    root = w.commit()
    if case == "process_0":
        ocdbt.write_manifest(path, root, base="ocdbt.process_0/")
    if case == "interior":
        assert root.height >= 2
    assert root.num_keys == n
    keys, values = _tensorstore(path)
    assert keys == sorted(k.encode() for k in want)
    assert all(values[k] == want[k.decode()] for k in keys)
    store = ocdbt.OcdbtStore(path)
    assert store.list() == keys
    assert all(store.read(k) == values[k] for k in keys)
    assert store.get("no such key") is None
    if case == "process_0":  # the sub-database reads on its own too
        assert ocdbt.OcdbtStore(sub).list() == keys


def test_ocdbt_writer_checksums_are_verified(tmp_path):
    """A flipped byte in a written node raises ``OSError`` naming the
    file; a committed writer takes no more keys."""
    path = str(tmp_path / "db")
    w = ocdbt.OcdbtWriter(path)
    w.put("a", b"1" * 10)
    root = w.commit()
    with pytest.raises(ValueError, match="committed"):
        w.put("b", b"2")
    victim = os.path.join(path, root.file)
    with open(victim, "r+b") as f:
        f.seek(root.offset + root.length // 2)
        b = f.read(1)
        f.seek(root.offset + root.length // 2)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(OSError, match="checksum mismatch") as err:
        ocdbt.OcdbtStore(path).list()
    assert victim in str(err.value)


# ---------------------------------------------------------------------------
# the JAX package restores the port's saves
# ---------------------------------------------------------------------------

def _port_step1(meta, layout, dtype=torch.float32):
    """(model, the port's state after one step on the fixture's batch,
    the batch placement or None)."""
    model, state, pl = _port_abstract(meta, layout == "mesh8", dtype)
    x, y = _batch(meta)
    if pl is None:
        s1, _ = ptrain.make_train_step(model)(state, _cf(x), _cf(y))
    else:
        s1, _ = ptrain.make_sharded_step(model)(
            state, pmesh.shard(_cf(x), state.mesh, pl),
            pmesh.shard(_cf(y), state.mesh, pl))
    return model, s1, pl


@pytest.fixture(scope="module")
def port_saves(tmp_path_factory):
    """layout -> (path, the port's state after one step) of the (4, 8)
    U-Net, saved by the port."""
    root = tmp_path_factory.mktemp("port_saves")
    meta = _meta("unsharded")
    out = {}
    for layout in LAYOUTS:
        _, s1, _ = _port_step1(meta, layout)
        path = str(root / layout)
        pckpt.save_train_state(path, s1)
        out[layout] = (path, s1)
    return out


def _assert_flax_equal(got, want):
    """The JAX package's restore (numpy trees) against
    ``train_state_to_flax``: every leaf bitwise, count and step."""
    for g, w in ((got.params, want.params),
                 (got.opt_state[0].mu, want.opt_state[0].mu),
                 (got.opt_state[0].nu, want.opt_state[0].nu)):
        g, w = pckpt._flatten(g), pckpt._flatten(w)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert int(got.opt_state[0].count) == int(want.opt_state[0].count)
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("target", ["one_device", "mesh8"])
def test_jax_restores_port_save_bitwise(layout, target, port_saves):
    path, s1 = port_saves[layout]
    meta = _meta("unsharded")
    got = jckpt.restore_train_state(
        path, _jax_abstract(meta, target == "mesh8"))
    assert int(got.step) == 1
    _assert_flax_equal(jax.tree_util.tree_map(np.asarray, got),
                       pckpt.train_state_to_flax(s1))
    _assert_reads_as_tensorstore(path)


def _jax_placed(want, state, meta):
    """The JAX ``TrainState`` of ``want`` (``train_state_to_flax`` of the
    port's ``state``) on the same placement: one CPU device, or the
    8-device mesh with each leaf the port splits over ``model`` split on
    its last (output-channel) dim."""
    a = _jax_abstract(meta, False)
    adam = a.opt_state[0]._replace(count=want.opt_state[0].count,
                                   mu=want.opt_state[0].mu,
                                   nu=want.opt_state[0].nu)
    tree = jtrain.TrainState(want.params, (adam,) + tuple(a.opt_state[1:]),
                             want.step)
    if not state.sharded:
        return jax.device_put(tree, SingleDeviceSharding(jax.devices()[0]))
    mesh = jmesh.make_mesh(8)
    flax = pckpt._flax_names(state.params)
    split = {tuple(flax[k][0].split("/")) for k, p in state.placements.items()
             if p.spec}

    def place(path, x):
        keys = tuple(str(getattr(k, "key", "")) for k in path)
        spec = PartitionSpec(*([None] * (x.ndim - 1) + ["model"])) \
            if x.ndim and any(keys[-len(s):] == s for s in split) \
            else PartitionSpec()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, tree)


def _assert_same_files(port, jax_path):
    """Everything the JAX package's save writes, but its data."""
    assert set(os.listdir(port)) == set(os.listdir(jax_path)) - {"d"}
    for name in ("_METADATA", os.path.join("array_metadatas", "process_0")):
        with open(os.path.join(port, name)) as f, \
                open(os.path.join(jax_path, name)) as g:
            assert json.load(f) == json.load(g), name
    shardings = []
    for p in (port, jax_path):
        with open(os.path.join(p, "_sharding")) as f:
            shardings.append({base64.b64decode(k).decode(): json.loads(v)
                              for k, v in json.load(f).items()})
    assert shardings[0] == shardings[1]
    meta = []
    for p in (port, jax_path):
        with open(os.path.join(p, "_CHECKPOINT_METADATA")) as f:
            m = json.load(f)
        assert m["init_timestamp_nsecs"] <= m["commit_timestamp_nsecs"]
        meta.append({k: v for k, v in m.items() if "timestamp" not in k})
    assert meta[0] == meta[1]
    keys, values = _tensorstore(port)
    want_keys, want_values = _tensorstore(jax_path)
    assert keys == want_keys
    for k in keys:
        if k.endswith(b"/.zarray"):
            assert values[k] == want_values[k], k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_same_files_as_the_jax_package(layout, port_saves, tmp_path):
    path, s1 = port_saves[layout]
    meta = _meta("unsharded")
    want = pckpt.train_state_to_flax(s1)
    jax_path = str(tmp_path / "jax")
    jckpt.save_train_state(jax_path, _jax_placed(want, s1, meta))
    _assert_same_files(path, jax_path)
    with open(os.path.join(path, "_sharding")) as f:
        one = json.loads(next(iter(json.load(f).values())))
    if layout == "whole":
        assert one == {"sharding_type": "SingleDeviceSharding",
                       "device_str": "TFRT_CPU_0"}
    else:
        assert one["shape"] == [2, 2, 2] and \
            one["axis_names"] == ["data", "space", "model"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_full_width_state(layout, tmp_path):
    """The U-Net at its full width (``create_unet()``'s defaults), every
    leaf random and count and step 5, saved by the port whole and from 8
    shards: the JAX package restores it bitwise, unsharded and onto its
    8-device mesh, and its own save of the same state has the same
    files.  Prints (``-s``) the port's save seconds on this host's CPU
    and the bytes of both saves."""
    model = create_unet()
    state = ptrain.init_state(model, (1, 1, 4, 8, 8), device="cpu")
    gen = torch.Generator().manual_seed(4)

    def rand(tree):
        return {k: torch.randn(v.shape, generator=gen) for k, v in
                tree.items()}

    state = state.replace(params=rand(state.params), step=5,
                          opt_state=ptrain.AdamState(
                              5, rand(state.params), rand(state.params)))
    if layout == "mesh8":
        mesh = pmesh.make_mesh(devices=pmesh.shard_devices("cpu", 8))
        _, state, _ = ptrain.shard_train_step(model, state, mesh)
    path = str(tmp_path / "port")
    t0 = time.perf_counter()
    pckpt.save_train_state(path, state)
    seconds = time.perf_counter() - t0
    want = pckpt.train_state_to_flax(state)
    assert sum(v.size for v in pckpt._flatten(want.params).values()) > 10**6
    meta = {"model": {}, "batch": {"shape": [1, 4, 8, 8]}}
    for target in (False, True):
        got = jckpt.restore_train_state(path, _jax_abstract(meta, target))
        _assert_flax_equal(jax.tree_util.tree_map(np.asarray, got), want)
    jax_path = str(tmp_path / "jax")
    jckpt.save_train_state(jax_path, _jax_placed(want, state, meta))
    _assert_same_files(path, jax_path)
    print(f"full-width {layout}: port save {seconds:.3f} s, "
          f"{_dir_bytes(path)} bytes; the JAX package's save "
          f"{_dir_bytes(jax_path)} bytes")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_resumes_the_port_run(layout, dtype, port_saves):
    """The JAX package restores the port's save (whole onto one device,
    from 8 shards onto its 8-device mesh) and takes the next step: its
    loss is the port's next loss from the same save."""
    path, _ = port_saves[layout]
    meta = _meta("unsharded")
    x, y = _batch(meta)
    tdt, jdt, rtol = ((torch.float32, jnp.float32, LOSS_RTOL)
                      if dtype == "float32" else
                      (torch.bfloat16, jnp.bfloat16, BF16_LOSS_RTOL))
    model, abstract, pl = _port_abstract(meta, layout == "mesh8", tdt)
    state = pckpt.restore_train_state(path, abstract)
    if pl is None:
        s2, port_loss = ptrain.make_train_step(model)(state, _cf(x), _cf(y))
    else:
        s2, port_loss = ptrain.make_sharded_step(model)(
            state, pmesh.shard(_cf(x), state.mesh, pl),
            pmesh.shard(_cf(y), state.mesh, pl))
    assert s2.step == 2
    jstate = jckpt.restore_train_state(
        path, _jax_abstract(meta, layout == "mesh8"))
    xs, ys = jnp.asarray(x), jnp.asarray(y)
    if layout == "mesh8":
        sh = NamedSharding(jmesh.make_mesh(8),
                           PartitionSpec("data", "space", None, None, None))
        xs, ys = jax.device_put(xs, sh), jax.device_put(ys, sh)
    j2, jax_loss = jax.jit(jtrain.make_train_step(_jax_model(meta, jdt)))(
        jstate, xs, ys)
    assert int(j2.step) == 2
    np.testing.assert_allclose(float(port_loss), float(jax_loss), rtol=rtol)


# ---------------------------------------------------------------------------
# the port's earlier layout, replacing and failing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_layout_still_restores(layout):
    path = os.path.join(FIXTURES, "port_layout")
    with open(os.path.join(FIXTURES, "port_layout.json")) as f:
        meta = json.load(f)
    step, abstract, (x, y) = ptrain.train_step_for_mesh(
        n_devices=8, features=tuple(meta["model"]["features"]),
        shape=tuple(meta["batch"]["shape"]), device="cpu")
    if layout == "whole":
        abstract = ptrain.unplace_state(abstract)
    got = pckpt.restore_train_state(path, abstract)
    trees = {}
    for name in ("params", "mu", "nu"):
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            trees[name] = pckpt.flax_params_to_state_dict(
                {k: data[k] for k in data.files})
    want = ptrain.TrainState(trees["params"], ptrain.AdamState(
        1, trees["mu"], trees["nu"]), 1)
    if layout == "mesh8":
        assert got.placements == abstract.placements
        want = ptrain.place_state(want, abstract.mesh, abstract.placements)
    _assert_same_state(got, want)
    if layout == "mesh8":
        _, loss = step(got, x, y)
        np.testing.assert_allclose(float(loss), meta["next_loss"],
                                   rtol=PORT_LOSS_RTOL)


def test_save_replaces_and_a_failed_save_changes_nothing(port_saves,
                                                         tmp_path):
    """A save over the port's earlier layout replaces it; a write that
    fails raises, leaves the directory as it was and no temporary
    directory beside it."""
    path = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(FIXTURES, "port_layout"), path)
    _, s1 = port_saves["whole"]
    pckpt.save_train_state(path, s1)
    assert not os.path.exists(os.path.join(path, "train_state.json"))
    _, abstract, _ = _port_abstract(_meta("unsharded"), False)
    _assert_same_state(pckpt.restore_train_state(path, abstract), s1)
    before = {f: os.path.getmtime(os.path.join(path, f))
              for f in os.listdir(path)}

    def pieces():
        yield (0,), np.zeros(2, np.float32)
        raise RuntimeError("shard lost")

    leaf = porbax.ArrayLeaf((4,), "<f4", (2,), pieces(),
                            porbax.single_device_sharding("TFRT_CPU_0"))
    with pytest.raises(RuntimeError, match="shard lost"):
        porbax.write_tree(path, [([("w", porbax.DICT_KEY)], leaf)])
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert {f: os.path.getmtime(os.path.join(path, f))
            for f in os.listdir(path)} == before
    _assert_same_state(pckpt.restore_train_state(path, abstract), s1)
