"""Decomposition multicut: distributed alternative solver.

Port of cluster_tools_tpu/workflows/decomposition.py (host numpy and the
C++ solvers, as in the JAX package), after the reference's
``decomposition_multicut/`` package
(decompose.py:93-150 — connected components of the graph restricted to
attractive edges; solve_subproblems.py:117-153 — independent per-component
solves; insert.py:96+ — recombine component solutions).  Unlike the
hierarchical ladder, the decomposition never merges across repulsive cuts,
so the components are embarrassingly parallel."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.runtime import BlockTask
from ..core.solvers import key_to_agglomerator
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .multicut import _load_costs, _load_scale_graph, save_assignment_table
from .write import WriteAssignments


class Decompose(BlockTask):
    """Connected components of the attractive subgraph (reference:
    decompose.py:93-150 via ndist.connectedComponents)."""

    task_name = "decompose"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, **kw):
        self.problem_path = problem_path
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {"problem_path": self.problem_path})

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native

        cfg = job_config["config"]
        uv_dense, n_nodes, _ = _load_scale_graph(cfg["problem_path"], 0)
        costs = _load_costs(cfg["problem_path"], 0)
        attractive = costs > 0
        roots = native.ufd_merge_pairs(n_nodes, uv_dense[attractive])
        _, comp = np.unique(roots, return_inverse=True)
        with file_reader(cfg["problem_path"]) as f:
            f.require_dataset("decomposition/labeling",
                              data=comp.astype("uint64"),
                              chunks=(min(int(1e6), max(len(comp), 1)),))
        log_fn(f"decomposed {n_nodes} nodes into {comp.max() + 1 if len(comp) else 0} components")


class SolveDecomposition(BlockTask):
    """Independent multicut per component, components sharded across jobs
    (reference: decomposition solve_subproblems.py:117-153)."""

    task_name = "solve_decomposition"

    def __init__(self, problem_path: str, **kw):
        self.problem_path = problem_path
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"agglomerator": "kernighan-lin"})
        return conf

    def run_impl(self):
        with file_reader(self.problem_path, "r") as f:
            comp = f["decomposition/labeling"][:]
        n_components = int(comp.max()) + 1 if len(comp) else 0
        self.run_jobs(list(range(n_components)), {
            "problem_path": self.problem_path,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        agglomerator = key_to_agglomerator(
            cfg.get("agglomerator", "kernighan-lin"))
        uv_dense, n_nodes, _ = _load_scale_graph(problem_path, 0)
        costs = _load_costs(problem_path, 0)
        with file_reader(problem_path, "r") as f:
            comp = f["decomposition/labeling"][:]
        edge_comp = comp[uv_dense[:, 0]]
        inner = comp[uv_dense[:, 0]] == comp[uv_dense[:, 1]]
        res_dir = os.path.join(problem_path, "decomposition", "results")
        os.makedirs(res_dir, exist_ok=True)

        for comp_id in job_config["block_list"]:
            sel = inner & (edge_comp == comp_id)
            sub_uv = uv_dense[sel]
            if len(sub_uv) == 0:
                log_fn(f"processed block {comp_id}")
                continue
            nodes, local_flat = np.unique(sub_uv, return_inverse=True)
            local_uv = local_flat.reshape(-1, 2).astype("int64")
            sub_res = agglomerator(len(nodes), local_uv, costs[sel])
            # np.savez appends .npz to names without the suffix
            tmp = os.path.join(res_dir, f"component_{comp_id}.tmp.npz")
            np.savez(tmp, nodes=nodes.astype("uint64"),
                     labels=sub_res.astype("uint64"))
            os.replace(tmp, os.path.join(res_dir,
                                         f"component_{comp_id}.npz"))
            log_fn(f"processed block {comp_id}")


class InsertDecomposition(BlockTask):
    """Combine the per-component solutions into one node labeling
    (reference: insert.py:96+)."""

    task_name = "insert_decomposition"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, assignment_path: str, **kw):
        self.problem_path = problem_path
        self.assignment_path = assignment_path
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path,
            "assignment_path": self.assignment_path,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        _, n_nodes, s0_nodes = _load_scale_graph(problem_path, 0)
        with file_reader(problem_path, "r") as f:
            comp = f["decomposition/labeling"][:].astype("uint64")
        # nodes not covered by any component solution keep their component
        # id; solved nodes get component-offset local labels
        final = comp.copy()
        offset = int(comp.max()) + 1 if len(comp) else 0
        res_dir = os.path.join(problem_path, "decomposition", "results")
        if os.path.isdir(res_dir):
            for name in sorted(os.listdir(res_dir)):
                if not name.endswith(".npz") or ".tmp." in name:
                    continue
                with np.load(os.path.join(res_dir, name)) as d:
                    nodes, labels = d["nodes"], d["labels"]
                final[nodes.astype("int64")] = labels + offset
                offset += int(labels.max()) + 1 if len(labels) else 0
        _, final = np.unique(final, return_inverse=True)
        nodes0 = (s0_nodes if s0_nodes is not None
                  else np.arange(n_nodes, dtype="uint64"))
        save_assignment_table(nodes0, final, cfg["assignment_path"])
        log_fn(f"inserted solutions: {len(np.unique(final))} segments")


class DecompositionWorkflow(Task):
    """Decompose -> per-component solves -> insert -> write (reference:
    decomposition_multicut workflow wiring)."""

    def __init__(self, problem_path: str, ws_path: str, ws_key: str,
                 output_path: str, output_key: str, tmp_folder: str,
                 config_dir: str, max_jobs: int = 1, target: str = "gpu",
                 dependency: Optional[Task] = None):
        self.problem_path = problem_path
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.output_path = output_path
        self.output_key = output_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        assignment_path = os.path.join(self.tmp_folder,
                                       "decomposition_assignments.npy")
        dec = Decompose(problem_path=self.problem_path,
                        dependency=self.dependency, **common)
        solve = SolveDecomposition(problem_path=self.problem_path,
                                   dependency=dec, **common)
        insert = InsertDecomposition(
            problem_path=self.problem_path, assignment_path=assignment_path,
            dependency=solve, **common)
        return WriteAssignments(
            input_path=self.ws_path, input_key=self.ws_key,
            output_path=self.output_path, output_key=self.output_key,
            assignment_path=assignment_path, identifier="decomposition",
            dependency=insert, **common)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_decomposition.status"))
