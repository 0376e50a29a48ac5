"""Predictor framework registry for the inference workflow.

Port of cluster_tools_tpu/models/frameworks.py (reference:
inference/frameworks.py:118-130 ``get_predictor``, :32-87
``PytorchPredicter``).  Two frameworks:

* ``'self'`` — first-party U-Net checkpoints in the JAX package's format
  (models/checkpoint.py), run by ``workflows.inference.make_predictor``;
* ``'pytorch'`` — externally-trained ``torch.load``-able ``nn.Module``s,
  run on the task's device; the forward pass is lock-serialized like the
  reference's GPU path so the surrounding IO threads never re-enter the
  model.

Every predictor maps one raw outer block (``(*outer_shape)`` or
``(C, *outer_shape)``) to a channels-first, halo-cropped float32 prediction
``(C_out, *inner_shape)``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Sequence

import numpy as np
import torch

from .unet import no_tf32


def make_torch_predictor(checkpoint_path: str, outer_shape: Sequence[int],
                         halo: Sequence[int],
                         preprocess: str = "standardize",
                         device: str = "cuda"):
    """Predictor over a ``torch.load``-able module on ``device``
    (reference: inference/frameworks.py:32-87).  The preprocessing runs
    on the host in numpy, as in the JAX package; float32 convolutions run
    without TF32."""
    model = torch.load(checkpoint_path, map_location=device,
                       weights_only=False)
    model.eval()
    lock = threading.Lock()
    inner = tuple(slice(h, s - h) for s, h in zip(outer_shape, halo))
    ndim = len(outer_shape)

    def predict(block: np.ndarray) -> np.ndarray:
        x = np.asarray(block).astype("float32")
        if x.ndim == ndim:  # single channel -> (C=1, *outer)
            x = x[None]
        spatial = tuple(range(1, x.ndim))
        # 'standardize' uses per-channel statistics over ALL voxels (the
        # 'self' predictor's convention); 'standardize_nonzero' matches
        # the reference torch preprocessor (statistics over nonzero
        # voxels with an additive eps)
        if preprocess == "standardize":
            mean = x.mean(axis=spatial, keepdims=True)
            std = np.maximum(x.std(axis=spatial, keepdims=True), 1e-6)
            x = (x - mean) / std
        elif preprocess == "standardize_nonzero":
            nz = x != 0
            cnt = np.maximum(nz.sum(axis=spatial, keepdims=True), 1)
            mean = (x * nz).sum(axis=spatial, keepdims=True) / cnt
            var = (((x - mean) * nz) ** 2).sum(axis=spatial,
                                               keepdims=True) / cnt
            x = (x - mean) / (np.sqrt(var) + 1e-6)
        elif preprocess == "normalize":
            lo = x.min(axis=spatial, keepdims=True)
            hi = x.max(axis=spatial, keepdims=True)
            x = (x - lo) / np.maximum(hi - lo, 1e-6)
        with lock, torch.no_grad(), no_tf32():
            out = model(torch.from_numpy(x[None]).to(device))
            if isinstance(out, tuple):
                out = out[0]
            out = out[0].float().cpu().numpy()
        if out.ndim == ndim:
            out = out[None]
        return out[(slice(None),) + inner].astype("float32")

    return predict


def wrap_tta(predict, mode: str):
    """Test-time augmentation over the 8 mirror variants: predict each
    axis-flip combination of the block, invert the flip on the output,
    average (the reference's inferno/neurofire TestTimeAugmenter path,
    inference/frameworks.py:90-113).  8x the forward cost, channel axis
    untouched."""
    if not mode:
        return predict
    if mode != "mirror":
        raise ValueError(f"unknown tta mode {mode!r} "
                         "(available: 'mirror')")

    def predict_tta(block: np.ndarray) -> np.ndarray:
        spatial_off = block.ndim - 3
        acc = None
        for flips in itertools.product([False, True], repeat=3):
            axes = tuple(spatial_off + d for d, f in enumerate(flips) if f)
            xb = np.flip(block, axes) if axes else block
            y = predict(np.ascontiguousarray(xb))  # (C_out, *inner)
            out_axes = tuple(1 + d for d, f in enumerate(flips) if f)
            if out_axes:
                y = np.flip(y, out_axes)
            acc = y.astype("float64") if acc is None else acc + y
        return (acc / 8.0).astype("float32")

    return predict_tta


def get_predictor(framework: str, checkpoint_path: str,
                  outer_shape: Sequence[int], halo: Sequence[int],
                  preprocess: str = "standardize",
                  tta: str = "", device: str = "cuda"):
    """Framework dispatch (reference: inference/frameworks.py:118-130)."""
    if framework == "self":
        from ..workflows.inference import make_predictor

        fn = make_predictor(checkpoint_path, outer_shape, halo, preprocess,
                            device=device)
    elif framework == "pytorch":
        fn = make_torch_predictor(checkpoint_path, outer_shape, halo,
                                  preprocess, device=device)
    else:
        raise KeyError(f"Framework {framework} not supported "
                       "(available: 'self', 'pytorch')")
    return wrap_tta(fn, tta)
