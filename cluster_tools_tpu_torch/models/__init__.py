"""The port's models: the 3D U-Net of the inference workflow, its
checkpoints (the JAX package's format) and the predictor frameworks, and
Swin UNETR (trained through ``models/train.py``)."""

from .swin_unetr import SwinUNETR, create_swin_unetr
from .unet import DEFAULT_OFFSETS, UNet3D, create_unet

__all__ = ["DEFAULT_OFFSETS", "SwinUNETR", "UNet3D", "create_swin_unetr",
           "create_unet"]
