"""Top-level segmentation pipeline (reference: cluster_tools/workflows.py).

Port of ``MulticutSegmentationWorkflow`` with ``fused=True``: the fused
problem assembly (fragments + graph + features + costs from one device
pass per block, workflows/fused_pipeline.py) chained with the
hierarchical multicut and the final write (reference workflows.py:204-233).
``fused=False`` (the split watershed + ProblemWorkflow chain) is not
ported yet and raises.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..core.workflow import FileTarget, Task
from .multicut import MulticutWorkflow
from .write import WriteAssignments


class MulticutSegmentationWorkflow(Task):
    """Problem -> hierarchical multicut -> write segmentation
    (reference: MulticutSegmentationWorkflow, workflows.py:204-233).

    ``fused=True`` computes the watershed fragments INSIDE the problem
    assembly, so ``ws_path/ws_key`` are outputs.  ``target`` is ``"gpu"``
    for the card (the JAX package's ``"tpu"``), or ``inline`` / ``local``
    / ``threads``; the device itself is the global config's ``"device"``."""

    def __init__(self, input_path: str, input_key: str, ws_path: str,
                 ws_key: str, problem_path: str, output_path: str,
                 output_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 n_scales: int = 1,
                 offsets: Optional[List[List[int]]] = None,
                 fused: bool = True,
                 dependency: Optional[Task] = None):
        if not fused:
            raise NotImplementedError(
                "fused=False (the split watershed + problem chain) is not "
                "ported yet (ROADMAP A9)")
        if offsets is not None:
            raise ValueError("fused=True supports boundary maps only "
                             "(affinity offsets need the split chain)")
        self.input_path = input_path
        self.input_key = input_key
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.problem_path = problem_path
        self.output_path = output_path
        self.output_key = output_key
        self.n_scales = n_scales
        self.fused = fused
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        from .fused_pipeline import FusedProblemWorkflow

        assignment_path = os.path.join(self.tmp_folder,
                                       "multicut_assignments.npy")
        problem = FusedProblemWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            ws_path=self.ws_path, ws_key=self.ws_key,
            problem_path=self.problem_path,
            dependency=self.dependency, **self._common())
        multicut = MulticutWorkflow(
            problem_path=self.problem_path, assignment_path=assignment_path,
            n_scales=self.n_scales, dependency=problem, **self._common())
        return WriteAssignments(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, identifier="multicut",
            dependency=multicut, **self._common())

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_multicut.status"))
