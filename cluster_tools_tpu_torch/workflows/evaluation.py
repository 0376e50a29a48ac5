"""Distributed segmentation evaluation vs groundtruth.

Port of cluster_tools_tpu/workflows/evaluation.py (the reference's
``evaluation/`` package, measures.py:91-165): the per-block overlap
machinery of workflows/node_labels.py (pair counting on the global
config's ``"device"``) produces the sparse contingency table; a global
measures job then computes VI split/merge, adapted Rand error, Rand index and
the CREMI score with the vectorized metric math in utils/validation.py and
writes them to a JSON file.

Overlaps here are (seg, gt) — node_labels' "ws" volume is the candidate
segmentation — so the contingency table is built as (a=gt, b=seg), matching
the reference's reversed construction (evaluation/measures.py:91-119).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.runtime import BlockTask
from ..core.workflow import FileTarget, Task
from ..utils.validation import (
    ContingencyTable, compute_object_vi_scores, compute_rand_scores,
    compute_vi_scores, drop_ignored_pairs,
)
from .node_labels import (
    BlockNodeLabels, MergeNodeLabels, load_merged_overlaps,
)


class Measures(BlockTask):
    """Global job: merged overlaps -> contingency table -> metrics JSON
    (reference: evaluation/measures.py:121-165)."""

    task_name = "measures"
    global_task = True
    allow_retry = False

    def __init__(self, overlaps_path: str, overlaps_key: str, out_path: str,
                 ignore_seg: Optional[List[int]] = None,
                 ignore_gt: Optional[List[int]] = None,
                 compute_object_vi: bool = False, **kw):
        self.overlaps_path = overlaps_path
        self.overlaps_key = overlaps_key
        self.out_path = out_path
        self.ignore_seg = ignore_seg
        self.ignore_gt = ignore_gt
        self.compute_object_vi = compute_object_vi
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "overlaps_path": self.overlaps_path,
            "overlaps_key": self.overlaps_key,
            "out_path": self.out_path,
            "ignore_seg": self.ignore_seg, "ignore_gt": self.ignore_gt,
            "compute_object_vi": self.compute_object_vi,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        rows = load_merged_overlaps(cfg["overlaps_path"], cfg["overlaps_key"])
        # rows are (seg_node, gt_label, count); table wants (a=gt, b=seg)
        p_ids = np.stack([rows[:, 1], rows[:, 0]], axis=1)
        table = ContingencyTable(p_ids, rows[:, 2].astype("float64"))
        table = drop_ignored_pairs(table, ignore_a=cfg.get("ignore_gt"),
                                   ignore_b=cfg.get("ignore_seg"))
        vis, vim = compute_vi_scores(table, use_log2=True)
        ari, ri = compute_rand_scores(table)
        results = {
            "vi-split": vis, "vi-merge": vim,
            "adapted-rand-error": ari, "rand-index": ri,
            "cremi-score": float(np.sqrt(ari * (vis + vim))),
            "n-points": table.n_points,
        }
        if cfg.get("compute_object_vi"):
            results["object-vi"] = {
                str(k): list(v)
                for k, v in compute_object_vi_scores(table).items()}
        tmp = cfg["out_path"] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f)
        os.replace(tmp, cfg["out_path"])
        log_fn(f"vi-split {vis:.4f} vi-merge {vim:.4f} "
               f"adapted-rand-error {ari:.4f}")


class EvaluationWorkflow(Task):
    """BlockNodeLabels(seg vs gt) -> MergeNodeLabels(full overlaps) ->
    Measures (reference: evaluation/evaluation_workflow.py)."""

    def __init__(self, seg_path: str, seg_key: str, gt_path: str, gt_key: str,
                 out_path: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 ignore_seg: Optional[List[int]] = None,
                 ignore_gt: Optional[List[int]] = None,
                 compute_object_vi: bool = False,
                 n_labels: Optional[int] = None,
                 dependency: Optional[Task] = None):
        self.seg_path = seg_path
        self.seg_key = seg_key
        self.gt_path = gt_path
        self.gt_key = gt_key
        self.out_path = out_path
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.ignore_seg = ignore_seg
        self.ignore_gt = ignore_gt
        self.compute_object_vi = compute_object_vi
        self.n_labels = n_labels
        self.dependency = dependency
        super().__init__()

    def _common(self):
        return dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                    max_jobs=self.max_jobs, target=self.target)

    def requires(self):
        prefix = "eval"
        overlaps_key = "overlaps_eval"
        t1 = BlockNodeLabels(
            ws_path=self.seg_path, ws_key=self.seg_key,
            input_path=self.gt_path, input_key=self.gt_key,
            prefix=prefix, n_labels=self.n_labels, include_zeros=True,
            dependency=self.dependency, **self._common())
        t2 = MergeNodeLabels(
            output_path=self.tmp_folder, output_key=overlaps_key,
            prefix=prefix, max_overlap=False,
            dependency=t1, **self._common())
        t3 = Measures(
            overlaps_path=self.tmp_folder, overlaps_key=overlaps_key,
            out_path=self.out_path, ignore_seg=self.ignore_seg,
            ignore_gt=self.ignore_gt,
            compute_object_vi=self.compute_object_vi,
            dependency=t2, **self._common())
        return t3

    def output(self):
        return FileTarget(self.out_path)
