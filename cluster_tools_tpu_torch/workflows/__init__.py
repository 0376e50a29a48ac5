"""Workflows of the port: the fused multicut segmentation chain."""

from .segmentation import MulticutSegmentationWorkflow

__all__ = ["MulticutSegmentationWorkflow"]
