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

A training state (``models/train.py``) is written in the port's own
layout:

    <path>/train_state.json — step, the optimizer's count and settings,
                              the model config, each tensor's placement
                              and the mesh's axes (null when unsharded)
    <path>/params.npz, mu.npz, nu.npz — the parameters and both Adam
                              moments under the flax names of params.npz

A sharded state is joined on the host before the write; restore places
each tensor back by its placement.  :func:`restore_train_state` also
reads the orbax directories that the JAX package's ``save_train_state``
writes (``_CHECKPOINT_METADATA``, ``_METADATA`` and an OCDBT store:
``models/orbax.py``), without orbax; the port does not write them, so
the JAX package cannot resume a run of the port.
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
from typing import Any, Dict, Mapping, Optional, Tuple

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


def state_dict_to_flax_params(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`flax_params_to_state_dict`: the flat
    ``params.npz`` names and float32 numpy arrays of a ``UNet3D``
    ``state_dict``."""
    n_levels = len({k.split(".")[1] for k in state_dict
                    if k.startswith("upsamplers.")})
    inverse = {prefix: (flax_mod, kind) for flax_mod, (prefix, kind)
               in _module_map(n_levels).items()}
    flat: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        prefix, leaf = name.rsplit(".", 1)
        if prefix not in inverse:
            raise KeyError(f"unexpected UNet3D parameter {name!r}")
        flax_mod, kind = inverse[prefix]
        a = t.detach().to(torch.float32).cpu().numpy()
        if leaf == "weight" and kind == "conv":
            a = a.transpose(2, 3, 4, 1, 0)
        elif leaf == "weight" and kind == "up":
            a = a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        flax_leaf = ({"weight": "scale"} if kind == "norm"
                     else {"weight": "kernel"}).get(leaf, leaf)
        flat[f"{flax_mod}/{flax_leaf}"] = np.ascontiguousarray(a)
    return flat


def save_checkpoint(path: str, model_config: Dict[str, Any],
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write ``model.json`` + ``params.npz`` in the JAX package's format.

    ``model_config`` holds the kwargs of :func:`models.unet.create_unet`
    (``out_channels``, ``features``, ``anisotropic``).
    """
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


def _spec_to_json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _spec_from_json(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def save_train_state(path: str, state) -> None:
    """Write a (possibly sharded) train state: ``train_state.json`` and
    the three ``.npz`` files, each tensor whole (joined on the host)."""
    from .train import unplace_state

    os.makedirs(path, exist_ok=True)
    whole = unplace_state(state, device=torch.device("cpu"))
    for name, tree in (("params", whole.params), ("mu", whole.opt_state.mu),
                       ("nu", whole.opt_state.nu)):
        np.savez(os.path.join(path, f"{name}.npz"),
                 **state_dict_to_flax_params(tree))
    write_config(os.path.join(path, "train_state.json"), {
        "step": int(state.step), "count": int(state.opt_state.count),
        "optimizer": dict(state.optimizer), "model": dict(state.config),
        "mesh": state.mesh.shape if state.sharded else None,
        "placements": ({k: _spec_to_json(p.spec)
                        for k, p in state.placements.items()}
                       if state.sharded else None)})


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

    ``path`` holds either the port's layout (written by
    :func:`save_train_state`: ``train_state.json``; a sharded state is
    cut by the saved placements) or the orbax checkpoint that the JAX
    package's ``save_train_state`` writes (``_CHECKPOINT_METADATA``,
    ``_METADATA``; cut by ``abstract_state``'s placements, as orbax takes
    its shardings from its abstract state).  orbax stores neither the
    model's config nor the optimizer's settings: they come from
    ``abstract_state``."""
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
            f"{path}: neither a train state of the port (train_state.json) "
            "nor an orbax checkpoint of the JAX package "
            "(_CHECKPOINT_METADATA, _METADATA)")
    from .orbax import read_train_state

    whole = train_state_from_flax(read_train_state(path), device="cpu")
    trees = {"params": whole.params, "mu": whole.opt_state.mu,
             "nu": whole.opt_state.nu}
    return _placed(path, trees, whole.opt_state.count, whole.step,
                   abstract_state, abstract_state.placements,
                   abstract_state.config, abstract_state.optimizer)
