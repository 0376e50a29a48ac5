"""Hierarchical blockwise LIFTED multicut.

Port of cluster_tools_tpu/workflows/lifted_multicut.py (the reference's
``lifted_multicut/`` package: solve_lifted_subproblems.py:27-325,
reduce_lifted_problem.py:26, solve_lifted_global.py:21,
lifted_multicut_workflow.py), host work over the problem's graph files: the
multicut
solve->reduce ladder with long-range lifted edges carried along — per-block
subproblems pick up the lifted pairs entirely inside the block and solve the
lifted objective (native lmc_gaec + lmc_kl_refine); the reduce step maps
lifted pairs through the scale's node labeling and re-accumulates their
costs.

Container layout extends the multicut problem:

    s<i>/lifted_nh_<prefix>      (L, 2) uint64 lifted pairs
    s<i>/lifted_costs_<prefix>   (L,) float64
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core import graph as g
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import Task
from .multicut import (ReduceProblem, SolveSubproblems, _load_costs,
                       _load_scale_graph, compose_to_s0,
                       save_assignment_table)


def _lifted_keys(scale: int, prefix: str):
    return (f"s{scale}/lifted_nh_{prefix}",
            f"s{scale}/lifted_costs_{prefix}")


def _load_lifted(problem_path: str, scale: int, prefix: str):
    from .lifted_features import load_edge_list

    nh_key, costs_key = _lifted_keys(scale, prefix)
    with file_reader(problem_path, "r") as f:
        if nh_key not in f:
            return np.zeros((0, 2), "uint64"), np.zeros(0, "float64")
    lifted_uv = load_edge_list(problem_path, nh_key)
    with file_reader(problem_path, "r") as f:
        lifted_costs = f[costs_key][:][:len(lifted_uv)]
    return lifted_uv, lifted_costs.astype("float64")


def _save_lifted(problem_path: str, scale: int, prefix: str,
                 lifted_uv: np.ndarray, lifted_costs: np.ndarray) -> None:
    from .lifted_features import save_edge_list

    nh_key, costs_key = _lifted_keys(scale, prefix)
    save_edge_list(problem_path, nh_key, lifted_uv)
    # zero-size datasets are not representable; pad to one row, the true
    # count travels in the nh dataset's n_edges attr
    costs = (lifted_costs.astype("float64") if len(lifted_costs)
             else np.zeros(1, "float64"))
    with file_reader(problem_path) as f:
        f.require_dataset(costs_key, data=costs, shape=costs.shape,
                          chunks=(min(int(1e6), len(costs)),))


def find_inner_lifted(lifted_uv: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Indices of lifted pairs with BOTH endpoints in ``nodes`` (reference:
    solve_lifted_subproblems.py:131 ``_find_lifted_edges``)."""
    if len(lifted_uv) == 0:
        return np.zeros(0, "int64")
    lookup = np.sort(nodes)

    def _in(col):
        idx = np.searchsorted(lookup, col)
        return (idx < len(lookup)) & (
            lookup[np.minimum(idx, len(lookup) - 1)] == col)

    return np.flatnonzero(_in(lifted_uv[:, 0]) & _in(lifted_uv[:, 1]))


def _lifted_dense_pairs(lifted_uv: np.ndarray, scale: int, s0_nodes):
    """Lifted pairs are stored in original node labels at s0; map them to
    the dense node indexing used by the solver layer."""
    if scale == 0 and len(lifted_uv):
        graph0 = g.Graph(s0_nodes, np.zeros((0, 2), "uint64"))
        return np.stack([graph0.node_index(lifted_uv[:, 0]),
                         graph0.node_index(lifted_uv[:, 1])], axis=1)
    return lifted_uv.astype("int64")


class SolveLiftedSubproblems(SolveSubproblems):
    """Per-block lifted multicut (reference: SolveLiftedSubproblems,
    solve_lifted_subproblems.py:27-241).  Reuses the base block loop; only
    the per-block solve differs (lifted solver when the block holds lifted
    pairs)."""

    task_name = "solve_lifted_subproblems"

    def __init__(self, lifted_prefix: str, **kw):
        self.lifted_prefix = lifted_prefix
        super().__init__(**kw)

    def _extra_job_config(self):
        return {"lifted_prefix": self.lifted_prefix}

    @classmethod
    def _job_context(cls, cfg, s0_nodes):
        lifted_uv, lifted_costs = _load_lifted(
            cfg["problem_path"], int(cfg["scale"]), cfg["lifted_prefix"])
        return {"lifted_dense": _lifted_dense_pairs(
                    lifted_uv, int(cfg["scale"]), s0_nodes),
                "lifted_costs": lifted_costs}

    @classmethod
    def _solve_block(cls, cfg, ctx, nodes_dense, inner, uv_dense, costs):
        from .. import native

        inner_lifted = find_inner_lifted(ctx["lifted_dense"], nodes_dense)
        if len(inner_lifted) == 0:
            return SolveSubproblems._solve_block(cfg, ctx, nodes_dense,
                                                 inner, uv_dense, costs)
        sub_uv = uv_dense[inner]
        all_pairs = np.concatenate([sub_uv, ctx["lifted_dense"][inner_lifted]])
        sub_nodes, local_flat = np.unique(all_pairs, return_inverse=True)
        local_all = local_flat.reshape(-1, 2).astype("int64")
        local_uv = local_all[:len(sub_uv)]
        local_lifted = local_all[len(sub_uv):]
        sub_res = native.lifted_multicut_kernighan_lin(
            len(sub_nodes), local_uv, costs[inner], local_lifted,
            ctx["lifted_costs"][inner_lifted])
        cut_mask = sub_res[local_uv[:, 0]] != sub_res[local_uv[:, 1]]
        return inner[cut_mask]


class ReduceLiftedProblem(ReduceProblem):
    """ReduceProblem + map the lifted pairs through the scale labeling and
    re-accumulate their costs (reference: reduce_lifted_problem.py:26)."""

    task_name = "reduce_lifted_problem"

    def __init__(self, lifted_prefix: str, **kw):
        self.lifted_prefix = lifted_prefix
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.problem_path, "r") as f:
            shape = list(f["s0/graph"].attrs["shape"])
        base_bs = self.global_block_shape()
        scale_bs = [b * 2 ** self.scale for b in base_bs]
        self.run_jobs(None, {
            "problem_path": self.problem_path, "scale": self.scale,
            "shape": shape, "block_shape": base_bs,
            "expected_blocks": self.blocks_in_volume(shape, scale_bs),
            "lifted_prefix": self.lifted_prefix,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        ReduceProblem.process_job(job_id, job_config, log_fn)

        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        scale = int(cfg["scale"])
        prefix = cfg["lifted_prefix"]
        next_scale = scale + 1

        lifted_uv, lifted_costs = _load_lifted(problem_path, scale, prefix)
        if len(lifted_uv) == 0:
            _save_lifted(problem_path, next_scale, prefix,
                         np.zeros((0, 2), "uint64"), np.zeros(0, "float64"))
            return
        with file_reader(problem_path, "r") as f:
            scale_labeling = f[f"s{next_scale}/scale_node_labeling"][:]
        if scale == 0:
            # lifted pairs carry original s0 labels; the scale labeling is
            # indexed by dense node index
            _, _, s0_nodes = _load_scale_graph(problem_path, 0)
            graph0 = g.Graph(s0_nodes, np.zeros((0, 2), "uint64"))
            dense = np.stack([graph0.node_index(lifted_uv[:, 0]),
                              graph0.node_index(lifted_uv[:, 1])], axis=1)
        else:
            dense = lifted_uv.astype("int64")
        mapped = scale_labeling[dense]
        keep = mapped[:, 0] != mapped[:, 1]
        mu = np.minimum(mapped[keep][:, 0], mapped[keep][:, 1])
        mv = np.maximum(mapped[keep][:, 0], mapped[keep][:, 1])
        pairs = np.stack([mu, mv], axis=1)
        new_lifted, inverse = (np.unique(pairs, axis=0, return_inverse=True)
                               if len(pairs) else
                               (np.zeros((0, 2), "uint64"),
                                np.zeros(0, "int64")))
        new_costs = np.zeros(len(new_lifted), "float64")
        np.add.at(new_costs, inverse, lifted_costs[keep])
        _save_lifted(problem_path, next_scale, prefix, new_lifted, new_costs)
        log_fn(f"reduced lifted edges {len(lifted_uv)} -> {len(new_lifted)}")


class SolveLiftedGlobal(BlockTask):
    """Single global lifted solve -> final assignment table (reference:
    SolveLiftedGlobal, solve_lifted_global.py:21)."""

    task_name = "solve_lifted_global"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, scale: int, assignment_path: str,
                 lifted_prefix: str = "", **kw):
        self.problem_path = problem_path
        self.scale = scale
        self.assignment_path = assignment_path
        self.lifted_prefix = lifted_prefix
        super().__init__(**kw)

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path, "scale": self.scale,
            "assignment_path": self.assignment_path,
            "lifted_prefix": self.lifted_prefix,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native

        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        scale = int(cfg["scale"])
        prefix = cfg["lifted_prefix"]

        uv_dense, n_nodes, s0_nodes = _load_scale_graph(problem_path, scale)
        costs = _load_costs(problem_path, scale)
        lifted_uv, lifted_costs = _load_lifted(problem_path, scale, prefix)
        lifted_dense = _lifted_dense_pairs(lifted_uv, scale, s0_nodes)
        labels = native.lifted_multicut_kernighan_lin(
            n_nodes, uv_dense.astype("int64"), costs, lifted_dense,
            lifted_costs)
        log_fn(f"global lifted solve: {n_nodes} nodes -> "
               f"{len(np.unique(labels))} segments")

        final = compose_to_s0(problem_path, scale, labels)
        nodes0, _, _ = g.load_graph(problem_path, "s0/graph")
        table = save_assignment_table(nodes0, final, cfg["assignment_path"])
        log_fn(f"assignments saved: {len(table)} fragment ids")


class LiftedMulticutWorkflow(Task):
    """for scale: SolveLiftedSubproblems -> ReduceLiftedProblem; then
    SolveLiftedGlobal (reference: lifted_multicut_workflow.py)."""

    def __init__(self, problem_path: str, assignment_path: str,
                 lifted_prefix: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu", n_scales: int = 1,
                 dependency: Optional[Task] = None):
        self.problem_path = problem_path
        self.assignment_path = assignment_path
        self.lifted_prefix = lifted_prefix
        self.n_scales = n_scales
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
        dep = self.dependency
        for scale in range(self.n_scales):
            dep = SolveLiftedSubproblems(
                problem_path=self.problem_path, scale=scale,
                lifted_prefix=self.lifted_prefix, dependency=dep,
                **self._common())
            dep = ReduceLiftedProblem(
                problem_path=self.problem_path, scale=scale,
                lifted_prefix=self.lifted_prefix, dependency=dep,
                **self._common())
        return SolveLiftedGlobal(
            problem_path=self.problem_path, scale=self.n_scales,
            assignment_path=self.assignment_path,
            lifted_prefix=self.lifted_prefix, dependency=dep,
            **self._common())

    def output(self):
        from ..core.workflow import FileTarget

        return FileTarget(os.path.join(self.tmp_folder,
                                       "solve_lifted_global.status"))
