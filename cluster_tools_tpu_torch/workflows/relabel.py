"""Relabel fragments to consecutive ids across the volume.

A copy of cluster_tools_tpu/workflows/relabel.py (host numpy), the
re-specification of the reference's ``relabel/`` component (SURVEY.md §2.1:
per-job uniques -> merge -> assignment table -> write;
relabel/find_uniques.py:93-112, find_labeling.py:84-129).  Needed after any
task that makes labels globally unique by per-block offsetting
(``block_id * prod(block_shape)``) which leaves the id space sparse.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.blocking import Blocking
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import Task
from .write import WriteAssignments


class FindUniques(BlockTask):
    """Per-job unique label values over assigned blocks (reference:
    find_uniques.py)."""

    task_name = "find_uniques"

    def __init__(self, input_path: str, input_key: str,
                 identifier: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f = file_reader(cfg["input_path"], "r")
        ds = f[cfg["input_key"]]
        uniques = []
        for block_id in job_config["block_list"]:
            uniques.append(np.unique(ds[blocking.get_block(block_id).bb]))
            log_fn(f"processed block {block_id}")
        out = (np.unique(np.concatenate(uniques)) if uniques
               else np.zeros(0, dtype="uint64"))
        np.save(os.path.join(job_config["tmp_folder"],
                             f"{job_config['task_name']}_out_{job_id}.npy"),
                out)


class FindLabeling(BlockTask):
    """Global merge of per-job uniques -> sparse (old_id, new_id) table with
    consecutive new ids (reference: find_labeling.py:84-129)."""

    task_name = "find_labeling"
    global_task = True
    allow_retry = False

    def __init__(self, assignment_path: str, uniques_prefix: str = "find_uniques",
                 identifier: str = "", **kw):
        self.assignment_path = assignment_path
        self.uniques_prefix = uniques_prefix
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "tmp_root": self.tmp_folder,
            "uniques_prefix": self.uniques_prefix,
            "assignment_path": self.assignment_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        uniques = []
        prefix = cfg["uniques_prefix"] + "_out_"
        for name in os.listdir(cfg["tmp_root"]):
            if name.startswith(prefix) and name.endswith(".npy"):
                uniques.append(np.load(os.path.join(cfg["tmp_root"], name)))
        ids = np.unique(np.concatenate(uniques)) if uniques else np.zeros(0, "uint64")
        has_zero = ids.size and ids[0] == 0
        nonzero = ids[1:] if has_zero else ids
        new_ids = np.arange(1, nonzero.size + 1, dtype="uint64")
        table = np.stack([nonzero, new_ids], axis=1)
        if has_zero:
            table = np.concatenate(
                [np.zeros((1, 2), dtype="uint64"), table], axis=0)
        np.save(cfg["assignment_path"], table)
        log_fn(f"relabeling {nonzero.size} ids")


class RelabelWorkflow(Task):
    """FindUniques -> FindLabeling -> Write (in-place) (reference:
    relabel/relabel_workflow.py:10)."""

    def __init__(self, input_path: str, input_key: str, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "local",
                 identifier: str = "relabel",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.identifier = identifier
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        assignment_path = os.path.join(
            self.tmp_folder, f"{self.identifier}_assignments.npy")
        t1 = FindUniques(input_path=self.input_path, input_key=self.input_key,
                         identifier=self.identifier,
                         dependency=self.dependency, **common)
        t2 = FindLabeling(assignment_path=assignment_path,
                          uniques_prefix=t1.name_with_id,
                          identifier=self.identifier, dependency=t1, **common)
        t3 = WriteAssignments(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.input_path, output_key=self.input_key,
            assignment_path=assignment_path, identifier=self.identifier,
            dependency=t2, **common)
        return t3

    def output(self):
        from ..core.workflow import FileTarget

        return FileTarget(os.path.join(
            self.tmp_folder, f"write_{self.identifier}.status"))
