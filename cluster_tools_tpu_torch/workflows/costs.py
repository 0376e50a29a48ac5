"""Edge probabilities -> signed multicut costs.

Re-specification of the reference's ``costs/`` package: the log-odds
transform with boundary bias and edge-size weighting
(probs_to_costs.py:115-131 _transform_probabilities_to_costs) and the
node-label cost overrides (:134-171 ignore / isolate / ignore_transition).
The transform is elementwise over the edge table — one jitted device
program sharded over the edge axis.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core import graph as g
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import Task


def transform_probabilities_to_costs(probs: np.ndarray, beta: float = 0.5,
                                     edge_sizes: Optional[np.ndarray] = None,
                                     weighting_exponent: float = 1.0
                                     ) -> np.ndarray:
    """p in [0,1] -> signed cost; positive = attractive (merge).

    cost = log((1-p)/p) + log((1-beta)/beta), p clipped to [.001, .999];
    optionally scaled by (size/max_size)**exponent (reference semantics,
    probs_to_costs.py:115-131).  Plain numpy: the edge table is a few
    hundred thousand floats — a device round trip (let alone a per-call
    jit trace) costs orders of magnitude more than the transform.
    """
    p_min = 0.001
    p = (1.0 - 2 * p_min) * probs.astype("float32") + p_min
    c = np.log((1.0 - p) / p) + float(np.log((1.0 - beta) / beta))
    if edge_sizes is not None:
        w = edge_sizes.astype("float32") / max(float(edge_sizes.max()), 1e-6)
        if weighting_exponent != 1.0:
            w = w ** weighting_exponent
        c = c * w
    return c.astype("float32")


def apply_node_labels(costs: np.ndarray, uv_ids: np.ndarray, mode: str,
                      labels: np.ndarray, max_repulsive: float,
                      max_attractive: float) -> np.ndarray:
    """Override costs near labeled nodes (reference: _apply_node_labels).

    'ignore': any edge touching a labeled node -> max_repulsive;
    'isolate': edges between two labeled nodes -> max_attractive, edges
      between labeled and unlabeled -> max_repulsive;
    'ignore_transition': edges whose endpoints carry different labels ->
      max_repulsive.
    """
    lab_uv = labels[uv_ids.astype("int64")]
    has = lab_uv > 0
    if mode == "ignore":
        costs[has.any(axis=1)] = max_repulsive
    elif mode == "isolate":
        s = has.sum(axis=1)
        costs[s == 2] = max_attractive
        costs[s == 1] = max_repulsive
    elif mode == "ignore_transition":
        costs[lab_uv[:, 0] != lab_uv[:, 1]] = max_repulsive
    else:
        raise ValueError(f"invalid node-label mode {mode}")
    return costs


class ProbsToCosts(BlockTask):
    """Global job: features -> costs dataset (reference: ProbsToCosts)."""

    task_name = "probs_to_costs"
    global_task = True

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, graph_path: str, graph_key: str = "graph",
                 node_labels_path: str = "", node_labels_key: str = "",
                 features_path: str = "", features_key: str = "", **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.node_labels_path = node_labels_path
        self.node_labels_key = node_labels_key
        #: edge-feature table for size weighting when the input is a 1-D
        #: RF probability vector
        self.features_path = features_path
        self.features_key = features_key
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"invert_inputs": False, "transform_to_costs": True,
                     "weight_edges": False, "weighting_exponent": 1.0,
                     "beta": 0.5, "node_label_mode": "ignore"})
        return conf

    def run_impl(self):
        self.run_jobs(None, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "graph_path": self.graph_path, "graph_key": self.graph_key,
            "node_labels_path": self.node_labels_path,
            "node_labels_key": self.node_labels_key,
            "features_path": self.features_path or self.input_path,
            "features_key": self.features_key or self.input_key,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        with file_reader(cfg["input_path"], "r") as f:
            feats = f[cfg["input_key"]][:]
        # 2-D: the edge-feature table (col 0 = mean boundary prob, last =
        # size); 1-D: an RF edge-probability vector (costs/predict.py path)
        probs = feats[:, 0] if feats.ndim == 2 else feats
        if cfg.get("invert_inputs"):
            probs = 1.0 - probs
        edge_sizes = None
        if cfg.get("weight_edges"):
            if feats.ndim != 2:
                with file_reader(cfg["features_path"], "r") as f:
                    table = f[cfg["features_key"]]
                    if len(table.shape) != 2:
                        raise ValueError(
                            "weight_edges needs the 2-D edge-feature table "
                            "for sizes; pass features_path/features_key "
                            "when the input is a 1-D probability vector")
                    edge_sizes = table[:, table.shape[1] - 1]
            else:
                edge_sizes = feats[:, feats.shape[1] - 1]
        if cfg.get("transform_to_costs", True):
            costs = transform_probabilities_to_costs(
                probs, beta=float(cfg.get("beta", 0.5)),
                edge_sizes=edge_sizes,
                weighting_exponent=float(cfg.get("weighting_exponent", 1.0)))
        else:
            costs = probs.astype("float32")

        if cfg.get("node_labels_path"):
            _, uv_ids, _ = g.load_graph(cfg["graph_path"], cfg["graph_key"])
            with file_reader(cfg["node_labels_path"], "r") as f:
                labels = f[cfg["node_labels_key"]][:]
            # 5x the extreme costs so label constraints dominate any natural
            # evidence (reference: probs_to_costs.py max_repulsive/attractive)
            max_rep = 5 * float(costs.min()) if len(costs) else -5.0
            max_att = 5 * float(costs.max()) if len(costs) else 5.0
            costs = apply_node_labels(costs, uv_ids,
                                      cfg.get("node_label_mode", "ignore"),
                                      labels, max_rep, max_att)

        with file_reader(cfg["output_path"]) as f:
            ds = f.require_dataset(cfg["output_key"], shape=(len(costs),),
                                   chunks=(max(len(costs), 1),),
                                   dtype="float32")
            ds[:] = costs.astype("float32")
        log_fn(f"wrote {len(costs)} costs")


class EdgeCostsWorkflow(Task):
    """[RF predict ->] ProbsToCosts (reference: costs_workflow.py — the
    optional sklearn RF edge classifier, costs/predict.py:104-147, replaces
    the mean-boundary probability with learned edge probabilities)."""

    def __init__(self, features_path: str, features_key: str,
                 output_path: str, output_key: str, graph_path: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "local", node_labels_path: str = "",
                 node_labels_key: str = "", graph_key: str = "graph",
                 rf_path: str = "", dependency: Optional[Task] = None):
        self.features_path = features_path
        self.features_key = features_key
        self.output_path = output_path
        self.output_key = output_key
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.node_labels_path = node_labels_path
        self.node_labels_key = node_labels_key
        self.rf_path = rf_path
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        dep = self.dependency
        input_path, input_key = self.features_path, self.features_key
        if self.rf_path:
            from .learning import RFPredict

            input_key = "rf_probs"
            dep = RFPredict(
                rf_path=self.rf_path, features_path=self.features_path,
                features_key=self.features_key,
                output_path=self.features_path, output_key=input_key,
                dependency=dep, **common)
            input_path = self.features_path
        return ProbsToCosts(
            input_path=input_path, input_key=input_key,
            output_path=self.output_path, output_key=self.output_key,
            graph_path=self.graph_path, graph_key=self.graph_key,
            node_labels_path=self.node_labels_path,
            node_labels_key=self.node_labels_key,
            features_path=self.features_path, features_key=self.features_key,
            dependency=dep, **common)

    def output(self):
        from ..core.workflow import FileTarget

        return FileTarget(os.path.join(self.tmp_folder,
                                       "probs_to_costs.status"))
