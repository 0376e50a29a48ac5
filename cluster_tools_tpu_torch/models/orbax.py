"""orbax checkpoints of the JAX package, read without orbax, tensorstore,
JAX or ml_dtypes.

The JAX package's ``models/checkpoint.py`` saves a training state with
orbax's ``StandardCheckpointHandler``.  Its directory holds

    _CHECKPOINT_METADATA   orbax's record of the save (not read)
    _METADATA              JSON: ``tree_metadata`` (per leaf, its tree path
                           as ``key_metadata`` [{key, key_type}] — key type
                           1 a sequence index, 2 a dict key or attribute —
                           and ``value_metadata.value_type``), ``use_ocdbt``
                           and ``use_zarr3``
    _sharding, array_metadatas/   the save's shardings (not read: the
                           placements come from the caller)
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
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from ..core.ocdbt import OcdbtStore
from ..core.storage import DirectoryKV, open_zarr_array
from .checkpoint import AdamLeaves, FlaxTrainState

#: orbax's key type of a sequence index in ``key_metadata`` (2 is a
#: dict key or attribute)
SEQUENCE_KEY = 1
_ARRAYS = ("jax.Array", "np.ndarray")


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


__all__ = ["read_train_state", "read_tree"]
