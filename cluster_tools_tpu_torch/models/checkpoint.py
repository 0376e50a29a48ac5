"""Model checkpoints of the inference workflow, in the JAX package's format.

Port of cluster_tools_tpu/models/checkpoint.py.  A checkpoint is a plain
directory, readable and writable by both packages:

    <path>/model.json   — kwargs of :func:`models.unet.create_unet`
    <path>/params.npz   — the flax parameter tree, flattened to names like
                          ``params/ConvBlock_0/Conv_0/kernel``

:func:`flax_params_to_state_dict` and :func:`state_dict_to_flax_params`
carry the parameters between flax's layout and the port's ``UNet3D``
``state_dict``:

* a flax ``Conv`` kernel is ``(kd, kh, kw, in, out)``, a torch ``Conv3d``
  weight ``(out, in, kd, kh, kw)``;
* a flax ``ConvTranspose`` (``transpose_kernel=False``, kernel = stride,
  ``SAME`` padding) writes input voxel ``i`` times tap ``s - 1 - r`` to
  output ``i * s + r``; torch's ``ConvTranspose3d`` uses tap ``r``, with a
  weight laid out ``(in, out, kd, kh, kw)``: the taps are flipped;
* GroupNorm ``scale``/``bias`` are torch's ``weight``/``bias``.

A training state (``models/train.py``) is written as the JAX package's
``save_train_state`` writes one: an orbax ``StandardCheckpointHandler``
directory (``_CHECKPOINT_METADATA``, ``_METADATA``, ``_sharding``,
``array_metadatas/`` and an OCDBT store of zarr v2 arrays:
``models/orbax.py``, ``core/ocdbt.py``), written without orbax, of the
JAX ``TrainState`` ``(params, (ScaleByAdamState(count, mu, nu),
EmptyState, EmptyState), step)``: the parameters and both moments in
flax's layout, ``count`` and ``step`` int32 scalars.  The JAX package's
``restore_train_state`` restores it, so the JAX package resumes a run of
the port.  A sharded state is written shard by shard: the transposes
and flips apply to each shard, the output-channel split of its
placements is the zarr chunk grid, and a replicated shard is written
once.

:func:`restore_train_state` reads such directories, from either
package, and the port's earlier layout (``train_state.json``, step,
count, optimizer settings, model config, placements and mesh axes, and
``params.npz``, ``mu.npz``, ``nu.npz`` under the flax names of
params.npz, each tensor whole).  orbax stores neither the model's config
nor the optimizer's settings; they come from the abstract state.
:func:`train_state_from_flax` and :func:`train_state_to_flax` carry a
JAX ``TrainState`` (flax params plus optax's ``(ScaleByAdamState,
EmptyState, EmptyState)``) across, moments with the kernels' transposes
and flips.
"""

from __future__ import annotations

import json
import os
import re
from collections import namedtuple
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.config import write_config


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _n_levels(names) -> int:
    """Levels below the bottleneck: one flax ConvTranspose each."""
    return len({m.group(1) for n in names
                for m in [re.search(r"ConvTranspose_(\d+)/", n)] if m})


def _module_map(n_levels: int) -> Dict[str, Tuple[str, str]]:
    """flax module path -> (torch module prefix, kind)."""
    out: Dict[str, Tuple[str, str]] = {}

    def block(flax_name, torch_name):
        for j in range(2):
            out[f"params/{flax_name}/Conv_{j}"] = (f"{torch_name}.convs.{j}",
                                                   "conv")
            out[f"params/{flax_name}/GroupNorm_{j}"] = (
                f"{torch_name}.norms.{j}", "norm")

    for lv in range(n_levels):
        block(f"ConvBlock_{lv}", f"encoders.{lv}")
    block(f"ConvBlock_{n_levels}", "bottleneck")
    for j in range(n_levels):
        block(f"ConvBlock_{n_levels + 1 + j}", f"decoders.{j}")
        out[f"params/ConvTranspose_{j}"] = (f"upsamplers.{j}", "up")
    out["params/Conv_0"] = ("head", "conv")
    return out


def flax_params_to_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """The JAX package's U-Net parameters (the flax tree or its flat
    ``params.npz`` names, numpy arrays) as the port's ``UNet3D``
    ``state_dict`` (float32 tensors)."""
    flat = _flatten(params)
    mapping = _module_map(_n_levels(flat))
    sd: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        mod, leaf = name.rsplit("/", 1)
        if mod not in mapping:
            raise KeyError(f"unexpected U-Net parameter {name!r}")
        prefix, kind = mapping[mod]
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel" and kind == "conv":
            a = a.transpose(4, 3, 0, 1, 2)
        elif leaf == "kernel" and kind == "up":
            a = a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        torch_leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        sd[f"{prefix}.{torch_leaf}"] = torch.from_numpy(
            np.array(a, order="C"))
    return sd


#: per kernel kind, the flax dim of each dim of a torch weight (a
#: ``Conv3d``'s ``(out, in, kd, kh, kw)``, a ``ConvTranspose3d``'s ``(in,
#: out, kd, kh, kw)``, both to flax's ``(kd, kh, kw, in, out)``; the
#: up-convolution's taps are also flipped)
_FLAX_DIMS = {"conv": (4, 3, 0, 1, 2), "up": (3, 4, 0, 1, 2)}


def _flax_names(names) -> Dict[str, Tuple[str, Optional[str]]]:
    """``UNet3D`` parameter name -> (flax name, the kernel kind of a
    weight that is transposed — ``"conv"`` or ``"up"`` — or ``None``)."""
    n_levels = len({k.split(".")[1] for k in names
                    if k.startswith("upsamplers.")})
    inverse = {prefix: (flax_mod, kind) for flax_mod, (prefix, kind)
               in _module_map(n_levels).items()}
    out = {}
    for name in names:
        prefix, leaf = name.rsplit(".", 1)
        if prefix not in inverse:
            raise KeyError(f"unexpected UNet3D parameter {name!r}")
        flax_mod, kind = inverse[prefix]
        flax_leaf = ({"weight": "scale"} if kind == "norm"
                     else {"weight": "kernel"}).get(leaf, leaf)
        out[name] = (f"{flax_mod}/{flax_leaf}",
                     kind if leaf == "weight" and kind in _FLAX_DIMS
                     else None)
    return out


def _to_flax(t: torch.Tensor, kind: Optional[str]) -> np.ndarray:
    """A tensor (or a shard of one) in flax's layout, float32 on the
    host."""
    a = t.detach().to(torch.float32).cpu().numpy()
    if kind == "conv":
        a = a.transpose(2, 3, 4, 1, 0)
    elif kind == "up":
        a = a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
    return np.ascontiguousarray(a)


def state_dict_to_flax_params(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`flax_params_to_state_dict`: the flat
    ``params.npz`` names and float32 numpy arrays of a ``UNet3D``
    ``state_dict``."""
    return {flax: _to_flax(state_dict[name], kind)
            for name, (flax, kind) in _flax_names(state_dict).items()}


def _unet_only(model_config: Mapping[str, Any], what: str) -> None:
    """The JAX package's formats hold U-Nets: raise, by name, on a
    configuration of another model (``"model"`` in :func:`models.train.
    model_config`, as Swin UNETR's)."""
    kind = model_config.get("model", "unet")
    if kind != "unet":
        raise ValueError(f"{what} holds UNet3D only, not {kind!r}: "
                         "SwinUNETR has no checkpoint format")


def save_checkpoint(path: str, model_config: Dict[str, Any],
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write ``model.json`` + ``params.npz`` in the JAX package's format.

    ``model_config`` holds the kwargs of :func:`models.unet.create_unet`
    (``out_channels``, ``features``, ``anisotropic``).
    """
    _unet_only(model_config, "save_checkpoint")
    os.makedirs(path, exist_ok=True)
    write_config(os.path.join(path, "model.json"), model_config)
    np.savez(os.path.join(path, "params.npz"),
             **state_dict_to_flax_params(state_dict))


def load_checkpoint(path: str, params: bool = True,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Tuple[torch.nn.Module,
                               Optional[Dict[str, torch.Tensor]]]:
    """Return ``(model, state_dict)`` rebuilt from a checkpoint directory,
    the parameters loaded into the (CPU, eval-mode) model;
    ``params=False`` skips the params.npz read and returns ``(model,
    None)`` with freshly initialized parameters (single-channel input)."""
    from .unet import create_unet

    with open(os.path.join(path, "model.json")) as f:
        model_config = dict(json.load(f))
    _unet_only(model_config, "load_checkpoint")
    if "features" in model_config:
        model_config["features"] = tuple(model_config["features"])
    if not params:
        return create_unet(**model_config, dtype=dtype).eval(), None
    with np.load(os.path.join(path, "params.npz")) as data:
        flat = {k: data[k] for k in data.files}
    # flax infers the input channels from the data; the first kernel
    # records them
    in_channels = int(flat["params/ConvBlock_0/Conv_0/kernel"].shape[3])
    model = create_unet(**model_config, in_channels=in_channels, dtype=dtype)
    sd = flax_params_to_state_dict(flat)
    model.load_state_dict(sd)
    return model.eval(), sd


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


#: a JAX ``TrainState`` as numpy trees: ``opt_state`` is ``(AdamLeaves,
#: (), ())`` as optax's ``(ScaleByAdamState, EmptyState, EmptyState)``
FlaxTrainState = namedtuple("FlaxTrainState", "params opt_state step")
AdamLeaves = namedtuple("AdamLeaves", "count mu nu")


def train_state_from_flax(state, device: str = "cuda"):
    """The port's :class:`~.train.TrainState` of a JAX ``TrainState``
    whose leaves are numpy arrays (``params``, ``opt_state[0].count /
    .mu / .nu``, ``step``), its tensors on ``device``."""
    from ..core.device import resolve_device
    from .train import AdamState, TrainState, make_optimizer

    dev = resolve_device(device)
    adam = state.opt_state[0]

    def tensors(tree):
        return {k: v.to(dev) for k, v in
                flax_params_to_state_dict(tree).items()}

    params = tensors(state.params)
    return TrainState(params, AdamState(int(np.asarray(adam.count)),
                                        tensors(adam.mu), tensors(adam.nu)),
                      int(np.asarray(state.step)),
                      optimizer=make_optimizer().config())


def train_state_to_flax(state) -> FlaxTrainState:
    """The inverse of :func:`train_state_from_flax`: nested dicts of
    numpy arrays under flax's names; a sharded state is joined first."""
    from .train import unplace_state

    whole = unplace_state(state, device=torch.device("cpu"))

    def tree(sd):
        return _unflatten(state_dict_to_flax_params(sd))

    adam = AdamLeaves(np.asarray(whole.opt_state.count, np.int32),
                      tree(whole.opt_state.mu), tree(whole.opt_state.nu))
    return FlaxTrainState(tree(whole.params), (adam, (), ()),
                          np.asarray(whole.step, np.int32))


def _spec_from_json(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _jax_device_str(device: torch.device) -> str:
    """The name JAX gives the device of the same kind and index (what
    orbax records of a ``SingleDeviceSharding``)."""
    if device.type == "cuda":
        return f"cuda:{device.index or 0}"
    return f"TFRT_{device.type.upper()}_{device.index or 0}"


def _orbax_leaves(state) -> List[Tuple[List[Tuple[str, int]], Any]]:
    """The leaves of the JAX ``TrainState`` of ``state``, in orbax's
    order, for :func:`~.orbax.write_tree`: an unsharded tensor as one
    chunk; a sharded one as the chunks of its distinct shards, each cut
    from its own tensor."""
    from ..parallel.mesh import _coords, _split_index
    from .orbax import (DICT_KEY, SEQUENCE_KEY, ArrayLeaf, named_sharding,
                        single_device_sharding)

    names = _flax_names(state.params)
    mesh = state.mesh
    if state.sharded:
        coords = _coords(mesh)

        def sharding(spec):
            return named_sharding(mesh.devices.shape, mesh.axis_names, spec)
    else:
        coords = [None]
        one = single_device_sharding(_jax_device_str(
            next(iter(state.params.values())).device))

        def sharding(spec):
            return one

    def scalar(value) -> ArrayLeaf:
        return ArrayLeaf((), "<i4", (), [((), np.asarray(value, np.int32))],
                         sharding([]))

    def array(name: str, value) -> ArrayLeaf:
        kind = names[name][1]
        shards = value if state.sharded else [value]
        ndim = shards[0].ndim
        dims = _FLAX_DIMS.get(kind, tuple(range(ndim)))
        axes = [state.placements[name].axes_of(d) if state.sharded else ()
                for d in range(ndim)]
        counts = [_split_index(mesh, coords[0], a)[1] for a in axes]
        if any(s.shape != shards[0].shape for s in shards):
            raise ValueError(f"{name}: shards of unequal shapes cannot be "
                             "written as one zarr chunk grid")
        chunks, shape, spec = [0] * ndim, [0] * ndim, [None] * ndim
        for d in range(ndim):
            chunks[dims[d]] = shards[0].shape[d]
            shape[dims[d]] = shards[0].shape[d] * counts[d]
            if axes[d]:
                spec[dims[d]] = axes[d][0] if len(axes[d]) == 1 \
                    else list(axes[d])
        while spec and spec[-1] is None:
            spec.pop()
        # the up-convolution's flipped taps reverse their chunks' order
        flipped = set(dims[2:]) if kind == "up" else set()
        # orbax's replica-parallel write: the shards that hold the same
        # piece split it along its first (flax) axis that they divide,
        # each writing one slice
        replicas = len(shards) // int(np.prod(counts))
        split = next((a for a in range(ndim) if replicas > 1
                      and chunks[a] % replicas == 0), None)
        if split is None:
            replicas = 1
        else:
            chunks[split] //= replicas

        def pieces():
            written: Dict[Tuple[int, ...], int] = {}
            for coord, shard in zip(coords, shards):
                index = [0] * ndim
                for d in range(ndim):
                    i = _split_index(mesh, coord, axes[d])[0]
                    index[dims[d]] = counts[d] - 1 - i \
                        if dims[d] in flipped else i
                r = written.get(tuple(index), 0)
                if r == replicas:
                    continue
                written[tuple(index)] = r + 1
                if split is not None:
                    d, n = dims.index(split), chunks[split]
                    shard = shard.narrow(d, (replicas - 1 - r if split in
                                             flipped else r) * n, n)
                    index[split] = index[split] * replicas + r
                yield tuple(index), _to_flax(shard, kind)

        return ArrayLeaf(tuple(shape), "<f4", tuple(chunks), pieces(),
                         sharding(spec))

    def tree(path, sd):
        order = sorted(sd, key=lambda n: tuple(names[n][0].split("/")))
        return [(path + [(p, DICT_KEY) for p in names[n][0].split("/")],
                 array(n, sd[n])) for n in order]

    adam = [("1", SEQUENCE_KEY), ("0", SEQUENCE_KEY)]
    return (tree([("0", SEQUENCE_KEY)], state.params)
            + [(adam + [("count", DICT_KEY)], scalar(state.opt_state.count))]
            + tree(adam + [("mu", DICT_KEY)], state.opt_state.mu)
            + tree(adam + [("nu", DICT_KEY)], state.opt_state.nu)
            + [([("1", SEQUENCE_KEY), (i, SEQUENCE_KEY)], None)
               for i in ("1", "2")]
            + [([("2", SEQUENCE_KEY)], scalar(state.step))])


def save_train_state(path: str, state) -> None:
    """Write a (possibly sharded) train state as the JAX package's
    ``save_train_state`` does: an orbax checkpoint of its JAX
    ``TrainState``, each shard written from its own tensor (a replicated
    one once), into a temporary directory renamed into place (an
    existing ``path`` is replaced)."""
    from .orbax import write_tree

    _unet_only(state.config, "save_train_state")

    write_tree(path, _orbax_leaves(state))


def _placed(path: str, trees: Dict[str, Dict[str, torch.Tensor]],
            count: int, step: int, abstract_state, placements,
            config, optimizer):
    """A train state of whole tensors placed as ``abstract_state``'s:
    on its tensors' devices, or cut onto its mesh by ``placements``."""
    from ..parallel.mesh import shard
    from .train import AdamState, TrainState

    ref = abstract_state.params
    if set(trees["params"]) != set(ref):
        raise KeyError(f"{path}: saved parameters do not match the "
                       f"abstract state's")

    def shapes(t):
        return [s.shape for s in t] if abstract_state.sharded else t.shape

    def place(tree):
        out = {}
        for k, v in tree.items():
            out[k] = shard(v, abstract_state.mesh, placements[k]) \
                if abstract_state.sharded else v.to(ref[k].device)
            if shapes(out[k]) != shapes(ref[k]):
                raise ValueError(f"{path}: {k} is placed as "
                                 f"{shapes(out[k])}, the abstract state "
                                 f"holds {shapes(ref[k])}")
        return out

    return TrainState(place(trees["params"]),
                      AdamState(int(count), place(trees["mu"]),
                                place(trees["nu"])),
                      int(step), config=config, optimizer=optimizer,
                      mesh=abstract_state.mesh, placements=placements)


def restore_train_state(path: str, abstract_state):
    """Restore a train state onto the layout of ``abstract_state`` (a
    state of the same model): whole tensors on its tensors' devices, or,
    for a sharded one, cut onto its mesh.

    ``path`` holds either an orbax checkpoint, as both packages'
    ``save_train_state`` write it (``_CHECKPOINT_METADATA``,
    ``_METADATA``; cut by ``abstract_state``'s placements, as orbax takes
    its shardings from its abstract state; orbax stores neither the
    model's config nor the optimizer's settings: they come from
    ``abstract_state``), or the port's earlier layout
    (``train_state.json``; a sharded state is cut by the saved
    placements)."""
    from ..parallel.mesh import Placement

    if os.path.exists(os.path.join(path, "train_state.json")):
        with open(os.path.join(path, "train_state.json")) as f:
            meta = json.load(f)
        trees = {}
        for name in ("params", "mu", "nu"):
            with np.load(os.path.join(path, f"{name}.npz")) as data:
                trees[name] = flax_params_to_state_dict(
                    {k: data[k] for k in data.files})
        mesh, placements = abstract_state.mesh, abstract_state.placements
        if abstract_state.sharded and meta.get("placements"):
            if meta["mesh"] != mesh.shape:
                raise ValueError(f"{path}: saved on a mesh {meta['mesh']}, "
                                 f"restoring onto {mesh.shape}")
            placements = {k: Placement(_spec_from_json(v))
                          for k, v in meta["placements"].items()}
        return _placed(path, trees, meta["count"], meta["step"],
                       abstract_state, placements, meta.get("model"),
                       meta.get("optimizer"))
    if not any(os.path.exists(os.path.join(path, name))
               for name in ("_CHECKPOINT_METADATA", "_METADATA")):
        raise FileNotFoundError(
            f"{path}: neither an orbax checkpoint (_CHECKPOINT_METADATA, "
            "_METADATA) nor a train state in the port's earlier layout "
            "(train_state.json)")
    from .orbax import read_train_state

    whole = train_state_from_flax(read_train_state(path), device="cpu")
    trees = {"params": whole.params, "mu": whole.opt_state.mu,
             "nu": whole.opt_state.nu}
    return _placed(path, trees, whole.opt_state.count, whole.step,
                   abstract_state, abstract_state.placements,
                   abstract_state.config, abstract_state.optimizer)
