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

Sharded training states (orbax in the JAX package) belong to training,
which is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
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
            np.ascontiguousarray(a))
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


def save_train_state(path: str, state) -> None:
    """Sharded training states (orbax in the JAX package) are not ported."""
    raise NotImplementedError(
        "training-state checkpoints are not ported yet (ROADMAP A15)")


def restore_train_state(path: str, abstract_state):
    """Sharded training states (orbax in the JAX package) are not ported."""
    raise NotImplementedError(
        "training-state checkpoints are not ported yet (ROADMAP A15)")
