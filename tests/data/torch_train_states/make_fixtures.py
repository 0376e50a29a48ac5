"""The JAX package's orbax train states of this directory.

Each fixture is what ``cluster_tools_tpu.models.checkpoint.
save_train_state`` writes (orbax's ``StandardCheckpointHandler``: an
OCDBT store of zarr v2 arrays) for the isotropic 3-output U-Net of
features (4, 8) after one training step of the JAX package:

* ``unsharded/``: ``init_state`` and one jitted ``make_train_step`` on
  the CPU;
* ``sharded/``: ``train_step_for_mesh(n_devices=8, features=(4, 8))``
  on the 8-device CPU mesh (2, 2, 2): every tensor written as the chunks
  of its shards.

Beside each, ``<name>.json`` records the model, the batch (its shape
``(B, D, H, W)`` and the seeds of ``x = RandomState(x_seed).rand(B, D,
H, W, 1)`` and ``y = RandomState(y_seed).rand(B, D, H, W, 3) > 0.5``,
channels last, float32), the loss of the step that made the state, the
loss of the next step from it (``next_loss``: the JAX package's U-Net
computes in bfloat16), the same loss of the U-Net computing in float32
(``next_loss_float32``) and the versions of the packages that wrote it.
The port restores the states without orbax
(``cluster_tools_tpu_torch.models.checkpoint.restore_train_state``).

Rewrite the files (JAX, orbax and tensorstore needed) with

    python3 tests/data/torch_train_states/make_fixtures.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
FEATURES = (4, 8)
#: (B, D, H, W): ``train_step_for_mesh``'s default shape, which the mesh
#: and the U-Net's scales divide
SHAPE = (2, 8, 32, 32)
X_SEED, Y_SEED = 0, 1
FIXTURES = ("unsharded", "sharded")


def batch(shape=SHAPE, x_seed=X_SEED, y_seed=Y_SEED):
    """x (B, D, H, W, 1) and binary targets (B, D, H, W, 3), channels
    last, as ``train_step_for_mesh`` draws them."""
    b, d, h, w = shape
    x = np.random.RandomState(x_seed).rand(b, d, h, w, 1).astype(np.float32)
    y = (np.random.RandomState(y_seed).rand(b, d, h, w, 3) > 0.5).astype(
        np.float32)
    return x, y


def _write(name: str, state, step, loss_f32, x, y, loss, mesh) -> None:
    from importlib.metadata import version

    import jax

    from cluster_tools_tpu.models import checkpoint

    path = os.path.join(HERE, name)
    checkpoint.save_train_state(path, state)
    _, next_loss = step(state, x, y)
    meta = {"model": {"out_channels": 3, "features": list(FEATURES),
                      "anisotropic": False},
            "compute_dtype": "bfloat16",
            "batch": {"shape": list(SHAPE), "x_seed": X_SEED,
                      "y_seed": Y_SEED},
            "mesh": mesh, "step": int(state.step), "loss": float(loss),
            "next_loss": float(next_loss),
            "next_loss_float32": float(loss_f32(state.params, x, y)),
            "versions": {"jax": jax.__version__,
                         "orbax-checkpoint": version("orbax-checkpoint"),
                         "tensorstore": version("tensorstore")}}
    with open(os.path.join(HERE, f"{name}.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def main() -> None:
    # the 8-device CPU mesh of the tests (tests/conftest.py)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from cluster_tools_tpu.models import train
    from cluster_tools_tpu.models.unet import UNet3D, create_unet

    for name in FIXTURES:
        for path in (os.path.join(HERE, name),
                     os.path.join(HERE, f"{name}.json")):
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.exists(path):
                os.remove(path)
    model = create_unet(out_channels=3, features=FEATURES,
                        anisotropic=False)
    x, y = batch()
    f32 = UNet3D(out_channels=3, features=FEATURES,
                 scale_factors=model.scale_factors, dtype=jnp.float32)
    loss_f32 = jax.jit(lambda p, x, y: train.affinity_loss(f32.apply(p, x),
                                                           y))
    state = train.init_state(model, (1,) + SHAPE[1:] + (1,))
    step = jax.jit(train.make_train_step(model))
    state, loss = step(state, x, y)
    _write("unsharded", state, step, loss_f32, x, y, loss, None)
    jitted, state, (xs, ys) = train.train_step_for_mesh(
        n_devices=8, features=FEATURES, shape=SHAPE)
    if tuple(xs.shape[:4]) != SHAPE or not np.array_equal(
            np.asarray(xs), x) or not np.array_equal(np.asarray(ys), y):
        raise AssertionError("train_step_for_mesh's batch is not batch()")
    state, loss = jitted(state, xs, ys)
    _write("sharded", state, jitted, loss_f32, xs, ys, loss, [2, 2, 2])


if __name__ == "__main__":
    main()
