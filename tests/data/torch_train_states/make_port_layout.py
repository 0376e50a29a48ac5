"""The port's own train-state layout, as ``port_layout/``.

Before ``cluster_tools_tpu_torch.models.checkpoint.save_train_state``
wrote orbax's layout, it wrote this one (and ``restore_train_state``
still reads it):

    train_state.json — step, the optimizer's count and settings, the
                       model config, each tensor's placement and the
                       mesh's axes (null when unsharded)
    params.npz, mu.npz, nu.npz — the parameters and both Adam moments
                       under flax's names (``params/ConvBlock_0/Conv_0/
                       kernel``), each tensor whole (a sharded state was
                       joined on the host)

The fixture is the isotropic 3-output U-Net of features (4, 8) after one
sharded step of the port on 8 CPU shards of the mesh (2, 2, 2)
(``train_step_for_mesh(n_devices=8, features=(4, 8), shape=(2, 8, 16,
16), device="cpu")``).  ``port_layout.json`` records the loss of that
step and of the next one from the saved state.  The directory was
first written by ``save_train_state`` itself; :func:`write_port_layout`
below is that writer, so the fixture can be rewritten with

    python3 tests/data/torch_train_states/make_port_layout.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
NAME = "port_layout"
FEATURES = (4, 8)
#: (B, D, H, W) of ``train_step_for_mesh``'s batch
SHAPE = (2, 8, 16, 16)


def write_port_layout(path: str, state) -> None:
    """Write a (possibly sharded) train state of the port in its own
    layout: ``train_state.json`` and the three ``.npz`` files, each
    tensor whole (joined on the host)."""
    import torch

    from cluster_tools_tpu_torch.models.checkpoint import \
        state_dict_to_flax_params
    from cluster_tools_tpu_torch.models.train import unplace_state

    os.makedirs(path, exist_ok=True)
    whole = unplace_state(state, device=torch.device("cpu"))
    for name, tree in (("params", whole.params), ("mu", whole.opt_state.mu),
                       ("nu", whole.opt_state.nu)):
        np.savez(os.path.join(path, f"{name}.npz"),
                 **state_dict_to_flax_params(tree))
    spec = [[list(a) if isinstance(a, tuple) else a for a in p.spec]
            for p in state.placements.values()] if state.sharded else None
    meta = {"step": int(state.step), "count": int(state.opt_state.count),
            "optimizer": dict(state.optimizer), "model": dict(state.config),
            "mesh": state.mesh.shape if state.sharded else None,
            "placements": (dict(zip(state.placements, spec))
                           if state.sharded else None)}
    with open(os.path.join(path, "train_state.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def main() -> None:
    sys.path.insert(0, ROOT)
    from cluster_tools_tpu_torch.models import train

    step, state, (x, y) = train.train_step_for_mesh(
        n_devices=8, features=FEATURES, shape=SHAPE, device="cpu")
    state1, loss = step(state, x, y)
    _, next_loss = step(state1, x, y)
    path = os.path.join(HERE, NAME)
    if os.path.isdir(path):
        shutil.rmtree(path)
    write_port_layout(path, state1)
    with open(os.path.join(HERE, f"{NAME}.json"), "w") as f:
        json.dump({"model": {"out_channels": 3, "features": list(FEATURES),
                             "anisotropic": False},
                   "batch": {"shape": list(SHAPE), "x_seed": 0,
                             "y_seed": 1},
                   "mesh": [2, 2, 2], "step": 1, "loss": float(loss),
                   "next_loss": float(next_loss)}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
