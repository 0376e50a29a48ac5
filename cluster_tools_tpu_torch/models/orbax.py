"""orbax checkpoints of the JAX package, read and written without orbax,
tensorstore, JAX or ml_dtypes.

The JAX package's ``models/checkpoint.py`` saves a training state with
orbax's ``StandardCheckpointHandler``.  Its directory holds

    _CHECKPOINT_METADATA   orbax's record of the save: the handler's name,
                           the save's start and commit times (ns)
    _METADATA              JSON: ``tree_metadata`` (per leaf, its tree path
                           as ``key_metadata`` [{key, key_type}] — key type
                           1 a sequence index, 2 a dict key or attribute —
                           and ``value_metadata``: ``value_type``,
                           ``skip_deserialize`` and an array's
                           ``write_shape``, the shape of its chunks),
                           ``use_ocdbt`` and ``use_zarr3``
    _sharding              base64 of each array's name -> the JSON of its
                           sharding (not read: the placements come from
                           the caller, as orbax's come from its target)
    array_metadatas/process_0   each array's name, write and chunk shape
    manifest.ocdbt, d/, ocdbt.process_<i>/   with ``use_ocdbt``: one OCDBT
                           store (``core/ocdbt.py``) holding every leaf

Each array leaf is a zarr v2 array (``core/storage.py``
:func:`~..core.storage.open_zarr_array`) under its ``param_name``, the
tree path's keys joined by ``.`` (``0.params.ConvBlock_0.Conv_0.kernel``):
in the OCDBT store, or without ``use_ocdbt`` a directory of that name.
A sharded save writes several chunks; they are read whole.

Leaves come back as numpy arrays (``jax.Array`` and ``np.ndarray``),
``torch.bfloat16`` tensors (tensorstore's ``"bfloat16"``, which numpy
does not hold), Python numbers (``scalar``) and ``None`` (orbax's empty
nodes, such as optax's ``EmptyState``).  ``use_zarr3`` raises
``NotImplementedError``: the JAX package writes zarr v2.

:func:`write_tree` writes such a directory as orbax does for one
process: the arrays into the OCDBT sub-database ``ocdbt.process_0/``,
each chunk as its shard comes (an :class:`ArrayLeaf` yields them, one
per distinct shard), and a top-level manifest whose tree is that
database's, read under its base path.  It writes into a temporary
sibling directory and renames it into place, replacing a directory that
is there, as orbax's ``force=True`` does.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from typing import (Any, Dict, Iterable, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..core.ocdbt import OcdbtStore, OcdbtWriter, write_manifest
from ..core.storage import DirectoryKV, create_zarr_array, open_zarr_array
from .checkpoint import AdamLeaves, FlaxTrainState

#: orbax's key types in ``key_metadata``: a sequence index, a dict key
#: or attribute
SEQUENCE_KEY, DICT_KEY = 1, 2
_ARRAYS = ("jax.Array", "np.ndarray")
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
#: the OCDBT sub-database of process 0 (the only one written)
SUBDIR = "ocdbt.process_0"


def _leaf(kv, path: str, name: str, value: Dict[str, Any]):
    kind = value.get("value_type")
    if kind == "None" or value.get("skip_deserialize"):
        return None
    if kind not in _ARRAYS + ("scalar",):
        raise NotImplementedError(f"{path}: orbax value type {kind!r} of "
                                  f"{name}")
    ds = open_zarr_array(kv, name)
    arr = ds[...]
    if kind == "scalar":
        return arr.item()
    return torch.from_numpy(arr).view(torch.bfloat16) if ds.bfloat16 \
        else arr


def read_tree(path: str):
    """The tree saved in the orbax checkpoint directory ``path``: dicts
    for dict keys, lists for sequence indices (a tuple, a list or a
    custom node's children)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: orbax arrays in zarr v3 "
                                  "(use_zarr3) are not read")
    kv = OcdbtStore(path) if meta.get("use_ocdbt", True) \
        else DirectoryKV(path)
    root: Dict[Any, Any] = {}
    seq = set()  # ids of the nodes indexed by sequence keys
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        name = ".".join(str(k["key"]) for k in keys)
        node = root
        for i, k in enumerate(keys):
            key = k["key"]
            if k["key_type"] == SEQUENCE_KEY:
                seq.add(id(node))
                key = int(key)
            if i == len(keys) - 1:
                node[key] = _leaf(kv, path, name, entry["value_metadata"])
            else:
                node = node.setdefault(key, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        if id(node) in seq:
            return [build(node[i]) for i in sorted(node)]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def read_train_state(path: str) -> FlaxTrainState:
    """The JAX package's ``TrainState`` saved in ``path`` (its children
    ``params``, optax's ``(ScaleByAdamState, EmptyState, EmptyState)``
    and ``step``) as numpy trees: the input of
    :func:`~.checkpoint.train_state_from_flax`."""
    tree = read_tree(path)
    try:
        params, opt_state, step = tree
        adam = opt_state[0]
        return FlaxTrainState(params, (AdamLeaves(adam["count"], adam["mu"],
                                                  adam["nu"]), (), ()), step)
    except (TypeError, ValueError, KeyError, IndexError):
        raise ValueError(f"{path}: not a train state of the JAX package "
                         "(params, (ScaleByAdamState, EmptyState, "
                         "EmptyState), step)") from None


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class ArrayLeaf(NamedTuple):
    """An array to write: its global ``shape``, ``dtype`` (a numpy dtype
    string such as ``"<f4"``), the
    shape of its ``chunks`` (one shard's), its ``pieces`` — ``(chunk
    index, numpy array)`` pairs, one per distinct shard, made as they are
    written — and the JSON of its ``sharding``."""

    shape: Tuple[int, ...]
    dtype: str
    chunks: Tuple[int, ...]
    pieces: Iterable[Tuple[Tuple[int, ...], np.ndarray]]
    sharding: Dict[str, Any]


def single_device_sharding(device_str: str) -> Dict[str, Any]:
    """orbax's record of a ``SingleDeviceSharding``."""
    return {"sharding_type": "SingleDeviceSharding",
            "device_str": device_str}


def named_sharding(mesh_shape: Sequence[int], axis_names: Sequence[str],
                   spec: Sequence[Any]) -> Dict[str, Any]:
    """orbax's record of a ``NamedSharding`` over a mesh of
    ``mesh_shape`` whose devices have the ids ``0 .. n-1`` in C order
    (each axis of JAX's default type), partitioned by ``spec`` (per array
    dim an axis name, a list of them or ``None``)."""
    ids = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
    mesh = np.vectorize(lambda i: {"id": int(i)}, otypes=[object])(ids)
    return {"sharding_type": "NamedSharding",
            "shape": [int(n) for n in mesh_shape],
            "axis_names": list(axis_names),
            "axis_types": ["AxisType.Auto"] * len(axis_names),
            "partition_spec": list(spec),
            "device_mesh": {"mesh": mesh.tolist()}}


def _write_json(path: str, obj, **kw) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj, **kw))


def write_tree(path: str, leaves: Sequence[Tuple[Sequence[Tuple[str, int]],
                                                 Optional[ArrayLeaf]]]
               ) -> None:
    """Write an orbax checkpoint of a tree into the directory ``path``.

    ``leaves`` lists the tree's leaves in orbax's order: each tree path
    as ``(key, key type)`` pairs and the leaf, an :class:`ArrayLeaf` or
    ``None`` for an empty node.  An array is stored as a zarr v2 array
    (zstd chunks) under its ``param_name``, the keys joined by ``.``."""
    started = time.time_ns()
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        kv = OcdbtWriter(os.path.join(tmp, SUBDIR))
        tree, shardings, arrays = {}, {}, []
        try:
            for keys, leaf in leaves:
                name = ".".join(k for k, _ in keys)
                value: Dict[str, Any] = {"value_type": "None",
                                         "skip_deserialize": True}
                if leaf is not None:
                    value = {"value_type": "jax.Array",
                             "skip_deserialize": False,
                             "write_shape": list(leaf.chunks)}
                    ds = create_zarr_array(kv, name, leaf.shape,
                                           leaf.chunks, leaf.dtype)
                    for index, data in leaf.pieces:
                        ds.write_chunk(index, data)
                    shardings[base64.b64encode(name.encode()).decode()] = \
                        json.dumps(leaf.sharding)
                    arrays.append({"array_metadata": {
                        "param_name": name, "write_shape": list(leaf.chunks),
                        "chunk_shape": list(leaf.chunks),
                        "ext_metadata": None}})
                tree[repr(tuple(k for k, _ in keys))] = {
                    "key_metadata": [{"key": k, "key_type": t}
                                     for k, t in keys],
                    "value_metadata": value}
            root = kv.commit()
        finally:
            kv.close()
        write_manifest(tmp, root, base=f"{SUBDIR}/")
        _write_json(os.path.join(tmp, "_METADATA"), {
            "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None})
        _write_json(os.path.join(tmp, "_sharding"), shardings,
                    separators=(",", ":"))
        os.makedirs(os.path.join(tmp, "array_metadatas"))
        _write_json(os.path.join(tmp, "array_metadatas", "process_0"),
                    {"array_metadatas": arrays})
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": started,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        old = None
        if os.path.lexists(path):
            old = f"{path}.orbax-checkpoint-old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


__all__ = ["ArrayLeaf", "named_sharding", "read_train_state", "read_tree",
           "single_device_sharding", "write_tree"]
