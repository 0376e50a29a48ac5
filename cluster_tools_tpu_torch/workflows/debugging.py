"""Sanity-check workflows (the reference's post-hoc "sanitizers",
SURVEY §5.2).

Port of cluster_tools_tpu/workflows/debugging.py (host numpy and scipy,
as in the JAX package), after the reference's ``debugging/``: verify
per-block sub-graph node sets match the watershed uniques
(check_sub_graphs.py:83-101), verify segments are actually connected by
re-running connected components per label (check_components.py:85-117)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

from ..core.blocking import Blocking
from ..core.config import write_config
from ..core.runtime import BlockTask
from ..core.storage import file_reader


class CheckSubGraphs(BlockTask):
    """Per block: nodes stored in the sub-graph == np.unique(watershed)
    (reference: check_sub_graphs.py:83-101).  Failing block ids are
    written to ``<tmp_folder>/check_sub_graphs_failed.json``."""

    task_name = "check_sub_graphs"

    def __init__(self, ws_path: str, ws_key: str, graph_path: str, **kw):
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.graph_path = graph_path
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.ws_path, "r") as f:
            shape = list(f[self.ws_key].shape)
        block_shape = self.global_block_shape()[-len(shape):]
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "ws_path": self.ws_path, "ws_key": self.ws_key,
            "graph_path": self.graph_path,
            "shape": shape, "block_shape": block_shape,
        }, n_jobs=self.max_jobs)
        # merge per-job failure lists
        failed: List[int] = []
        for name in os.listdir(self.tmp_folder):
            if name.startswith("check_sub_graphs_failed_job"):
                with open(os.path.join(self.tmp_folder, name)) as f:
                    failed.extend(json.load(f))
        out = os.path.join(self.tmp_folder, "check_sub_graphs_failed.json")
        write_config(out, sorted(failed))
        if failed:
            raise RuntimeError(
                f"{len(failed)} blocks have inconsistent sub-graphs: "
                f"{sorted(failed)[:20]} (full list at {out})")

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core import graph as g

        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        f = file_reader(cfg["ws_path"], "r")
        ds = f[cfg["ws_key"]]
        failed = []
        for block_id in job_config["block_list"]:
            block = blocking.get_block(block_id)
            # this framework's sub-graphs include the +1 upper-face halo
            # (the RAG pair-ownership convention, workflows/graph.py:72);
            # check the invariant as constructed
            end = [min(e + 1, s) for e, s in zip(block.end, cfg["shape"])]
            bb = tuple(slice(b, e) for b, e in zip(block.begin, end))
            seg = np.asarray(ds[bb])
            nodes_seg = np.unique(seg)
            nodes_seg = nodes_seg[nodes_seg != 0]
            data = g.load_sub_graph(cfg["graph_path"], 0, block_id)
            nodes = data["nodes"]
            if len(nodes) != len(nodes_seg) or not np.array_equal(
                    np.sort(nodes), nodes_seg):
                failed.append(int(block_id))
            log_fn(f"processed block {block_id}")
        write_config(os.path.join(
            job_config["tmp_folder"],
            f"check_sub_graphs_failed_job{job_id}.json"), failed)


class CheckComponents(BlockTask):
    """Verify every segment is spatially connected: re-run CC inside each
    label's bounding box (reference: check_components.py:85-117), sharded
    over label-id ranges using the morphology table."""

    task_name = "check_components"
    global_task = True
    allow_retry = False

    def __init__(self, seg_path: str, seg_key: str, morphology_path: str,
                 morphology_key: str, n_labels: int, output_path: str, **kw):
        self.seg_path = seg_path
        self.seg_key = seg_key
        self.morphology_path = morphology_path
        self.morphology_key = morphology_key
        self.n_labels = n_labels
        self.output_path = output_path
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "seg_path": self.seg_path, "seg_key": self.seg_key,
            "morphology_path": self.morphology_path,
            "morphology_key": self.morphology_key,
            "n_labels": self.n_labels, "output_path": self.output_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from scipy import ndimage

        cfg = job_config["config"]
        from .morphology import decode_morphology

        with file_reader(cfg["morphology_path"], "r") as f:
            morpho = f[cfg["morphology_key"]][:]
        sizes, bb_min, bb_max = decode_morphology(morpho)
        f = file_reader(cfg["seg_path"], "r")
        ds = f[cfg["seg_key"]]
        struct = np.ones((3, 3, 3), bool)
        disconnected = []
        for label_id in range(1, cfg["n_labels"]):
            if sizes[label_id] == 0:
                continue
            bb = tuple(slice(b, e) for b, e in
                       zip(bb_min[label_id], bb_max[label_id]))
            obj = np.asarray(ds[bb]) == label_id
            _, n_comp = ndimage.label(obj, structure=struct)
            if n_comp != 1:
                disconnected.append(int(label_id))
        write_config(cfg["output_path"], disconnected)
        log_fn(f"{len(disconnected)} disconnected segments of "
               f"{cfg['n_labels']}")


class CheckWsWorkflow:
    """Verify a watershed has exactly one connected component per label
    (reference: debugging/check_ws_workflow.py:13-49 — chains unique-labels
    + label-block mapping + a component check; here the morphology table's
    bounding boxes shard the component re-check directly).  Writes the list
    of violating fragment ids as JSON at ``output_path``.

    Constructed like a workflow task::

        wf = CheckWsWorkflow(ws_path=..., ws_key=..., debug_path=...,
                             output_path=..., tmp_folder=..., config_dir=...,
                             max_jobs=..., target=...)
        ctt.build([wf.task()])
    """

    def __init__(self, ws_path: str, ws_key: str, debug_path: str,
                 output_path: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 n_labels=None, dependency=None):
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.debug_path = debug_path
        self.output_path = output_path
        self.common = dict(tmp_folder=tmp_folder, config_dir=config_dir,
                           max_jobs=max_jobs, target=target)
        self.n_labels = n_labels
        self.dependency = dependency

    def task(self):
        from .morphology import MorphologyWorkflow

        n_labels = self.n_labels
        if n_labels is None:
            with file_reader(self.ws_path, "r") as f:
                n_labels = int(f[self.ws_key].attrs["maxId"]) + 1
        morpho = MorphologyWorkflow(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.debug_path, output_key="morphology",
            n_labels=n_labels, prefix="check_ws",
            dependency=self.dependency, **self.common)
        return CheckComponents(
            seg_path=self.ws_path, seg_key=self.ws_key,
            morphology_path=self.debug_path, morphology_key="morphology",
            n_labels=n_labels, output_path=self.output_path,
            dependency=morpho, **self.common)
