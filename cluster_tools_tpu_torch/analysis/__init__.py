"""ctt-lint of the port: static-analysis passes over the port's package
and ``chip_smoke.py``.

Port of cluster_tools_tpu/analysis/.  One CLI (``python -m
cluster_tools_tpu_torch.analysis``), 8 AST passes, one pragma.  See
:mod:`.base` for the framework and the sibling modules for the
individual rules.
"""

from .base import (ALL_RULES, Finding, Pass, SourceFile, load_passes,
                   report_as_json, run_analysis)
from . import sources

__all__ = [
    "ALL_RULES", "Finding", "Pass", "SourceFile", "load_passes",
    "report_as_json", "run_analysis", "sources", "main",
]


def main(argv=None) -> int:
    from .__main__ import main as _main
    return _main(argv)
