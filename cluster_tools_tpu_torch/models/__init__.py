"""The port's models: the 3D U-Net of the inference workflow, its
checkpoints (the JAX package's format) and the predictor frameworks."""

from .unet import DEFAULT_OFFSETS, UNet3D, create_unet

__all__ = ["DEFAULT_OFFSETS", "UNet3D", "create_unet"]
