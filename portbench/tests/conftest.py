"""Shared fixtures of the benchmark's own tests.

``card`` marks a test that needs a CUDA device; the ``card`` fixture skips
it, deciding when the test runs (never while a module is imported).  Run
the card tests on the chip with
``python3 -m pytest portbench/tests -q -m card``.
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the cells at test size on the CPU (same code paths, tiny shapes)
SMALL = {
    "cremi-fused.n5": {
        "config": {"shape": [24, 96, 96], "block_shape": [12, 48, 48],
                   "fused_segmentation": {
                       "halo": [2, 8, 8], "threshold": 0.25,
                       "sigma_seeds": 2.0, "sigma_weights": 2.0,
                       "alpha": 0.8, "size_filter": 25, "refine_rounds": 3,
                       "coarse_factor": 2, "ws_method": "device",
                       "e_max": 2048}},
        "traffic": {"warmup_depth": 12, "max_jobs": 2}},
    "unet-train.crops": {
        "traffic": {"batch": 2, "crop": [16, 32, 32], "pool": 6,
                    "micro_batch": 2, "trace_steps": 2, "max_steps": 8}},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _port_telemetry():
    """The port's telemetry is module-global: reset it around each test."""
    from cluster_tools_tpu_torch.core import telemetry

    telemetry.reset()
    yield
    telemetry.reset()
