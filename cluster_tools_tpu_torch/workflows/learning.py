"""Random-forest edge classifier: training and prediction.

Port of cluster_tools_tpu/workflows/learning.py, after the reference's
``learning/`` package and
``costs/predict.py``: ground-truth node labels -> binary edge labels
(learning/edge_labels.py:91 — an edge is "cut" when its endpoints carry
different gt labels, ignore-label edges get -1), multi-dataset RF fit
(learning/learn_rf.py:93, sklearn), and chunked RF prediction over the edge
feature table (costs/predict.py:104-147).

The RF itself stays sklearn on the host (the reference's choice as well —
decision-forest inference is pointer-chasing, not tensor work), imported
where a job runs, so a host without sklearn imports this module; the edge
axis is sharded across jobs exactly like the reference.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task


class EdgeLabels(BlockTask):
    """Binary edge labels from gt node labels (reference:
    edge_labels.py:91-126)."""

    task_name = "edge_labels"
    global_task = True
    allow_retry = False

    def __init__(self, graph_path: str, graph_key: str,
                 node_labels_path: str, node_labels_key: str,
                 output_path: str, output_key: str,
                 ignore_label_gt: bool = True, identifier: str = "", **kw):
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.node_labels_path = node_labels_path
        self.node_labels_key = node_labels_key
        self.output_path = output_path
        self.output_key = output_key
        self.ignore_label_gt = ignore_label_gt
        self.identifier = identifier
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "graph_path": self.graph_path, "graph_key": self.graph_key,
            "node_labels_path": self.node_labels_path,
            "node_labels_key": self.node_labels_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "ignore_label_gt": self.ignore_label_gt,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.graph import load_graph

        cfg = job_config["config"]
        _, uv_ids, _ = load_graph(cfg["graph_path"], cfg["graph_key"])
        with file_reader(cfg["node_labels_path"], "r") as f:
            node_labels = f[cfg["node_labels_key"]][:]
        lu = node_labels[uv_ids[:, 0].astype("int64")]
        lv = node_labels[uv_ids[:, 1].astype("int64")]
        labels = (lu != lv).astype("int8")
        if cfg["ignore_label_gt"]:
            labels[(lu == 0) | (lv == 0)] = -1
        with file_reader(cfg["output_path"]) as f:
            f.require_dataset(cfg["output_key"], data=labels,
                              chunks=(min(262144, max(len(labels), 1)),))
        log_fn(f"{int((labels == 1).sum())} cut / "
               f"{int((labels == 0).sum())} merge / "
               f"{int((labels == -1).sum())} ignored edges")


class LearnRF(BlockTask):
    """Joint RF fit over one or more (features, labels) dataset pairs
    (reference: learn_rf.py:93-150)."""

    task_name = "learn_rf"
    global_task = True
    allow_retry = False

    def __init__(self, features_dict: Dict[str, Sequence[str]],
                 labels_dict: Dict[str, Sequence[str]], output_path: str,
                 **kw):
        assert set(features_dict) == set(labels_dict)
        self.features_dict = {k: list(v) for k, v in features_dict.items()}
        self.labels_dict = {k: list(v) for k, v in labels_dict.items()}
        self.output_path = output_path
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"n_trees": 100})
        return conf

    def run_impl(self):
        self.run_jobs(None, {
            "features_dict": self.features_dict,
            "labels_dict": self.labels_dict,
            "output_path": self.output_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from sklearn.ensemble import RandomForestClassifier

        cfg = job_config["config"]
        features: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        for key, (feat_path, feat_key) in cfg["features_dict"].items():
            lab_path, lab_key = cfg["labels_dict"][key]
            with file_reader(feat_path, "r") as f:
                feats = f[feat_key][:]
            with file_reader(lab_path, "r") as f:
                lab = f[lab_key][:]
            assert len(lab) == len(feats)
            keep = lab != -1
            if keep.sum() < len(lab):
                log_fn(f"{key}: dropping {int((~keep).sum())} ignore edges")
            features.append(feats[keep])
            labels.append(lab[keep])
        X = np.concatenate(features, axis=0)
        y = np.concatenate(labels, axis=0)
        log_fn(f"fitting RF on {X.shape[0]} edges x {X.shape[1]} features")
        rf = RandomForestClassifier(
            n_estimators=int(cfg.get("n_trees", 100)),
            n_jobs=int(cfg.get("threads_per_job", 1)))
        rf.fit(X, y)
        with open(cfg["output_path"], "wb") as f:
            pickle.dump(rf, f)
        log_fn(f"saved RF to {cfg['output_path']}")


class RFPredict(BlockTask):
    """Chunked RF edge-probability prediction (reference:
    costs/predict.py:104-147; shards the edge axis)."""

    task_name = "rf_predict"

    def __init__(self, rf_path: str, features_path: str, features_key: str,
                 output_path: str, output_key: str, **kw):
        self.rf_path = rf_path
        self.features_path = features_path
        self.features_key = features_key
        self.output_path = output_path
        self.output_key = output_key
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"chunk_size": int(1e5)})
        return conf

    def run_impl(self):
        with file_reader(self.features_path, "r") as f:
            n_edges = f[self.features_key].shape[0]
        chunk = int(self.task_config.get("chunk_size", 1e5))
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=(max(n_edges, 1),),
                              chunks=(min(chunk, max(n_edges, 1)),),
                              dtype="float32")
        self.run_jobs(self.id_chunks(n_edges, chunk), {
            "rf_path": self.rf_path, "features_path": self.features_path,
            "features_key": self.features_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "chunk_size": chunk, "n_edges": n_edges,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        with open(cfg["rf_path"], "rb") as f:
            rf = pickle.load(f)
        rf.n_jobs = int(cfg.get("threads_per_job", 1))
        chunk, n_edges = cfg["chunk_size"], cfg["n_edges"]
        f_in = file_reader(cfg["features_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_in = f_in[cfg["features_key"]]
        ds_out = f_out[cfg["output_key"]]
        for block_id in job_config["block_list"]:
            lo, hi = block_id * chunk, min((block_id + 1) * chunk, n_edges)
            if lo >= hi:
                log_fn(f"processed block {block_id}")
                continue
            feats = ds_in[lo:hi, :]
            proba = rf.predict_proba(feats)
            # an RF trained on one class returns a single column; locate
            # the "cut" (label 1) column via classes_
            classes = list(rf.classes_)
            if 1 in classes:
                probs = proba[:, classes.index(1)]
            else:
                probs = np.zeros(len(feats))
            ds_out[lo:hi] = probs.astype("float32")
            log_fn(f"processed block {block_id}")


class LearningWorkflow(Task):
    """Per-dataset (graph -> features -> gt node labels -> edge labels),
    then a joint RF fit (reference: learning_workflow.py:14-110).

    ``datasets``: dict name -> dict with keys ws_path/ws_key (fragments),
    input_path/input_key (boundary map), gt_path/gt_key (groundtruth
    labels), problem_path (container for graph+features).
    """

    def __init__(self, datasets: Dict[str, Dict[str, str]], output_path: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "gpu", dependency: Optional[Task] = None):
        self.datasets = datasets
        self.output_path = output_path
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        from .node_labels import NodeLabelWorkflow
        from .segmentation import ProblemWorkflow

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        features_dict: Dict[str, Tuple[str, str]] = {}
        labels_dict: Dict[str, Tuple[str, str]] = {}
        deps = []
        for name, ds in self.datasets.items():
            problem = ds["problem_path"]
            prob_wf = ProblemWorkflow(
                input_path=ds["input_path"], input_key=ds["input_key"],
                ws_path=ds["ws_path"], ws_key=ds["ws_key"],
                problem_path=problem, compute_costs=False,
                dependency=self.dependency,
                **{**common, "tmp_folder": os.path.join(
                    self.tmp_folder, name)})
            gt_labels = NodeLabelWorkflow(
                ws_path=ds["ws_path"], ws_key=ds["ws_key"],
                input_path=ds["gt_path"], input_key=ds["gt_key"],
                output_path=problem, output_key="gt_node_labels",
                prefix=f"gt_{name}", max_overlap=True, dependency=prob_wf,
                **{**common, "tmp_folder": os.path.join(
                    self.tmp_folder, name)})
            edge_labels = EdgeLabels(
                graph_path=problem, graph_key="s0/graph",
                node_labels_path=problem, node_labels_key="gt_node_labels",
                output_path=problem, output_key="edge_labels",
                identifier=name, dependency=gt_labels,
                **{**common, "tmp_folder": os.path.join(
                    self.tmp_folder, name)})
            deps.append(edge_labels)
            features_dict[name] = (problem, "features")
            labels_dict[name] = (problem, "edge_labels")
        # Task.requires handles iterable dependencies: direct fan-in
        return LearnRF(features_dict=features_dict, labels_dict=labels_dict,
                       output_path=self.output_path, dependency=deps,
                       **common)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder, "learn_rf.status"))

