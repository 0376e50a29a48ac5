"""Hierarchical blockwise multicut — the flagship workflow.

Re-specification of the reference's ``multicut/`` package (SURVEY §3.3, the
ICCV'17 domain-decomposition ladder): solve per-block subproblems -> mark cut
edges -> reduce the graph by merging uncut edges -> recurse with doubled
blocks -> solve the reduced problem globally.  The combinatorial solvers are
first-party C++ (cluster_tools_tpu_torch.native: GAEC + KL-style local search,
union-find); everything else is vectorized host numpy over the flat graph
arrays produced by the device RAG stack.

Problem-container layout (mirrors the reference's problem_path, SURVEY §5.4):

    s0/graph            from GraphWorkflow (edges, nodes, attrs)
    s0/costs            from EdgeCostsWorkflow
    s<i>/sub_graphs/block_<b>.npz        per-block node sets
    s<i>/sub_results/block_<b>.npz       per-block cut edge ids
    s<i+1>/graph, s<i+1>/costs           reduced problem
    s<i+1>/node_labeling                 dense s0-node -> current-node map
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional

import numpy as np

from ..core import graph as g
from ..core.blocking import Blocking
from ..core.runtime import BlockTask, stage
from ..core.solvers import key_to_agglomerator
from ..core.storage import file_reader
from ..core.workflow import Task


def _load_costs(problem_path: str, scale: int) -> np.ndarray:
    with file_reader(problem_path, "r") as f:
        return f[f"s{scale}/costs"][:]


def _load_scale_graph(problem_path: str, scale: int):
    """(uv_dense, n_nodes, s0_nodes).  At scale 0, uv ids are original labels
    mapped to dense indices via the sorted node table; at scale > 0 the
    reduced graph is already dense."""
    nodes, edges, attrs = g.load_graph(problem_path, f"s{scale}/graph")
    if scale == 0:
        graph = g.Graph(nodes, edges)
        uv_dense = np.stack([graph.node_index(edges[:, 0]),
                             graph.node_index(edges[:, 1])], axis=1)
        return uv_dense, len(nodes), nodes
    n_nodes = int(attrs["n_nodes"])
    return edges.astype("int64"), n_nodes, None


def _problem_geometry(problem_path: str, fallback_bs):
    """(shape, base block shape) of the serialized problem: the s0 graph
    records the decomposition its sub-graphs were built on
    (``sub_graph_block_shape``, e.g. mesh-resident slabs); older
    containers fall back to the caller's global block shape."""
    with file_reader(problem_path, "r") as f:
        attrs = f["s0/graph"].attrs
        shape = list(attrs["shape"])
        base_bs = list(attrs.get("sub_graph_block_shape") or fallback_bs)
    return shape, base_bs


def _sub_result_path(problem_path: str, scale: int, block_id: int) -> str:
    return os.path.join(problem_path, f"s{scale}", "sub_results",
                        f"block_{block_id}.npz")


def subproblem_signature(nodes_dense: np.ndarray, inner_uv: np.ndarray,
                         inner_costs: np.ndarray) -> str:
    """Content signature of one subproblem: the block's dense node set plus
    its inner edge list and costs — exactly the inputs ``_solve_block``
    consumes, so equal signatures imply equal cut-edge output (the solvers
    are deterministic).  Keyed with the block id through the sub_result
    filename, this is what the edits/ incremental solver validates its
    warm-start cache against before reusing a persisted solution."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(
        np.asarray(nodes_dense, dtype="int64")).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(inner_uv, dtype="int64")).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(inner_costs, dtype="float64")).tobytes())
    return h.hexdigest()[:16]


def load_sub_result(problem_path: str, scale: int, block_id: int):
    """(cut_edge_ids, signature-or-None) for one persisted subproblem
    solution; None if the sub_result does not exist.  Pre-signature
    sub_results (older containers) load with signature None, which the
    incremental solver treats as a cache miss."""
    path = _sub_result_path(problem_path, scale, block_id)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        cut_ids = d["cut_edge_ids"]
        sig = str(d["signature"]) if "signature" in d.files else None
    return cut_ids.astype("int64"), sig


def compose_to_s0(problem_path: str, scale: int,
                  labels: np.ndarray) -> np.ndarray:
    """Map a scale-level node labeling back to s0 fragments through the
    composed node_labeling (reference: solve_global.py node labeling)."""
    if scale == 0:
        return labels
    with file_reader(problem_path, "r") as f:
        initial = f[f"s{scale}/node_labeling"][:]
    return labels[initial.astype("int64")]


def save_assignment_table(nodes: np.ndarray, labels: np.ndarray,
                          assignment_path: str) -> np.ndarray:
    """Inflate per-node labels to a dense assignment table over
    [0, max_label]; 0 and gaps stay background; segment ids start at 1."""
    _, consecutive = np.unique(labels, return_inverse=True)
    max_label = int(nodes.max()) if len(nodes) else 0
    table = np.zeros(max_label + 1, dtype="uint64")
    table[nodes.astype("int64")] = consecutive.astype("uint64") + 1
    np.save(assignment_path, table)
    return table


class SolveSubproblems(BlockTask):
    """Per-block multicut over the scale's merged blocks (reference:
    SolveSubproblems, solve_subproblems.py:128-213)."""

    task_name = "solve_subproblems"

    def __init__(self, problem_path: str, scale: int, **kw):
        self.problem_path = problem_path
        self.scale = scale
        self.identifier = f"s{scale}"
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"agglomerator": "kernighan-lin", "time_limit_solver": None})
        return conf

    def _extra_job_config(self) -> Dict[str, Any]:
        """Hook: extra per-job config for subclasses (lifted)."""
        return {}

    def run_impl(self):
        shape, base_bs = _problem_geometry(self.problem_path,
                                           self.global_block_shape())
        scale_bs = [b * 2 ** self.scale for b in base_bs]
        block_list = self.blocks_in_volume(shape, scale_bs)
        self.run_jobs(block_list, {
            "problem_path": self.problem_path, "scale": self.scale,
            "shape": shape, "block_shape": base_bs,
            **self._extra_job_config(),
        }, n_jobs=self.max_jobs)

    @classmethod
    def _job_context(cls, cfg: Dict[str, Any], s0_nodes) -> Dict[str, Any]:
        """Hook: load per-job solver state (lifted edge lists etc.)."""
        return {}

    @classmethod
    def _solve_block(cls, cfg: Dict[str, Any], ctx: Dict[str, Any],
                     nodes_dense: np.ndarray, inner: np.ndarray,
                     uv_dense: np.ndarray, costs: np.ndarray) -> np.ndarray:
        """Hook: solve one block's subproblem -> labeling over the block's
        local (unique-compacted) nodes' cut mask; returns inner cut ids."""
        agglomerator = key_to_agglomerator(
            cfg.get("agglomerator", "kernighan-lin"))
        sub_uv = uv_dense[inner]
        sub_nodes, local_uv_flat = np.unique(sub_uv, return_inverse=True)
        local_uv = local_uv_flat.reshape(-1, 2).astype("int64")
        sub_costs = costs[inner]
        with stage("host-solve"):
            sub_res = agglomerator(len(sub_nodes), local_uv, sub_costs,
                                   time_limit=cfg.get("time_limit_solver"))
        cut_mask = sub_res[local_uv[:, 0]] != sub_res[local_uv[:, 1]]
        return inner[cut_mask]

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        scale = int(cfg["scale"])

        with stage("store-read"):
            uv_dense, n_nodes, s0_nodes = _load_scale_graph(problem_path,
                                                            scale)
            costs = _load_costs(problem_path, scale)
        graph = g.Graph(np.arange(n_nodes, dtype="uint64"),
                        uv_dense.astype("uint64"))
        ctx = cls._job_context(cfg, s0_nodes)
        os.makedirs(os.path.join(problem_path, f"s{scale}", "sub_results"),
                    exist_ok=True)

        for block_id in job_config["block_list"]:
            data = g.load_sub_graph(problem_path, scale, block_id)
            nodes = data["nodes"]
            if scale == 0:
                # map original labels to dense ids; every block node is in
                # the global node table by construction (0 already stripped)
                nodes_dense = np.searchsorted(s0_nodes, nodes)
            else:
                nodes_dense = nodes.astype("int64")
            inner, outer = graph.extract_subgraph(nodes_dense.astype("uint64"))
            if len(inner) == 0:
                cut_ids = outer
            else:
                cut_inner = cls._solve_block(cfg, ctx, nodes_dense, inner,
                                             uv_dense, costs)
                cut_ids = np.concatenate([cut_inner, outer])
            # persist the solution keyed by (block id, content signature):
            # the filename carries the block id, the signature stamps the
            # subproblem inputs so the edits/ incremental solver can
            # validate a warm-start against the live graph (ISSUE 19)
            sig = subproblem_signature(nodes_dense, uv_dense[inner],
                                       costs[inner])
            path = _sub_result_path(problem_path, scale, block_id)
            tmp = path + ".tmp.npz"
            with stage("tmp-write"):
                np.savez(tmp, cut_edge_ids=cut_ids.astype("int64"),
                         signature=np.asarray(sig))
                os.replace(tmp, path)
            log_fn(f"processed block {block_id}")


class ReduceProblem(BlockTask):
    """Global job: merge uncut edges, relabel, build the reduced problem for
    the next scale (reference: ReduceProblem, reduce_problem.py:26-286)."""

    task_name = "reduce_problem"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, scale: int, **kw):
        self.problem_path = problem_path
        self.scale = scale
        self.identifier = f"s{scale}"
        super().__init__(**kw)

    def run_impl(self):
        shape, base_bs = _problem_geometry(self.problem_path,
                                           self.global_block_shape())
        scale_bs = [b * 2 ** self.scale for b in base_bs]
        self.run_jobs(None, {
            "problem_path": self.problem_path, "scale": self.scale,
            "shape": shape, "block_shape": base_bs,
            # ROI/mask-aware list of blocks SolveSubproblems must have
            # produced; a missing sub_result is a hard error, not all-merge
            "expected_blocks": self.blocks_in_volume(shape, scale_bs),
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native

        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        scale = int(cfg["scale"])
        shape = cfg["shape"]
        base_bs = cfg["block_shape"]

        with stage("store-read"):
            uv_dense, n_nodes, s0_nodes = _load_scale_graph(problem_path,
                                                            scale)
            costs = _load_costs(problem_path, scale)

        # gather cut edges from all blocks at this scale; a block whose
        # sub_result is missing would silently contribute "merge everything"
        # (ADVICE r1) — fail loudly instead
        scale_bs = [b * 2 ** scale for b in base_bs]
        blocking = Blocking(shape, scale_bs)
        expected = cfg.get("expected_blocks")
        if expected is None:
            expected = list(range(blocking.n_blocks))
        cut_lists = []
        missing = []
        for bid in expected:
            path = _sub_result_path(problem_path, scale, bid)
            if not os.path.exists(path):
                missing.append(bid)
                continue
            with stage("tmp-read"), np.load(path) as d:
                cut_lists.append(d["cut_edge_ids"])
        if missing:
            raise RuntimeError(
                f"missing sub_results for blocks {missing[:20]} at scale "
                f"{scale} ({len(missing)} total)")
        cut_ids = (np.unique(np.concatenate(cut_lists)) if cut_lists
                   else np.zeros(0, "int64"))
        merge_mask = np.ones(len(uv_dense), bool)
        merge_mask[cut_ids] = False
        log_fn(f"merging {int(merge_mask.sum())} / {len(uv_dense)} edges")

        # union-find merge of uncut edges -> consecutive node labeling
        with stage("host-reduce"):
            roots = native.ufd_merge_pairs(n_nodes, uv_dense[merge_mask])
        _, node_labeling = np.unique(roots, return_inverse=True)
        node_labeling = node_labeling.astype("uint64")
        n_new_nodes = int(node_labeling.max()) + 1 if n_nodes else 0
        log_fn(f"reduced {n_nodes} -> {n_new_nodes} nodes")

        # compose with the initial (s0 -> current) labeling
        if scale == 0:
            new_initial = node_labeling
        else:
            with file_reader(problem_path, "r") as f:
                initial = f[f"s{scale}/node_labeling"][:]
            new_initial = node_labeling[initial.astype("int64")]

        # edge mapping: relabeled uv, dropped self-edges, summed costs
        mapped = node_labeling[uv_dense]
        keep = mapped[:, 0] != mapped[:, 1]
        mu = np.minimum(mapped[keep][:, 0], mapped[keep][:, 1])
        mv = np.maximum(mapped[keep][:, 0], mapped[keep][:, 1])
        pair = np.stack([mu, mv], axis=1)
        new_uv, inverse = np.unique(pair, axis=0, return_inverse=True)
        new_costs = np.zeros(len(new_uv), "float64")
        np.add.at(new_costs, inverse, costs[keep])

        # next-scale sub-graphs: merged-block node sets mapped through the
        # labeling (reference: ndist.serializeMergedGraph)
        next_scale = scale + 1
        new_bs = [b * 2 ** next_scale for b in base_bs]
        new_blocking = Blocking(shape, new_bs)
        for new_bid in range(new_blocking.n_blocks):
            block = new_blocking.get_block(new_bid)
            child_ids = blocking.blocks_in_roi(block.begin, block.end)
            node_sets = []
            for cid in child_ids:
                data = g.load_sub_graph(problem_path, scale, cid)
                nodes = data["nodes"]
                if scale == 0:
                    nodes = np.searchsorted(s0_nodes, nodes)
                node_sets.append(node_labeling[nodes.astype("int64")])
            merged_nodes = (np.unique(np.concatenate(node_sets))
                            if node_sets else np.zeros(0, "uint64"))
            g.save_sub_graph(problem_path, next_scale, new_bid, merged_nodes,
                             np.zeros((0, 2), "uint64"))

        # serialize reduced problem
        g.save_graph(problem_path, f"s{next_scale}/graph",
                     np.arange(n_new_nodes, dtype="uint64"),
                     new_uv.astype("uint64"), shape)
        with file_reader(problem_path) as f:
            ds = f.require_dataset(f"s{next_scale}/costs",
                                   shape=(len(new_costs),),
                                   chunks=(max(len(new_costs), 1),),
                                   dtype="float64")
            ds[:] = new_costs
            ds2 = f.require_dataset(f"s{next_scale}/node_labeling",
                                    shape=(len(new_initial),),
                                    chunks=(max(len(new_initial), 1),),
                                    dtype="uint64")
            ds2[:] = new_initial
            # scale-local (s -> s+1) labeling: the lifted reduce step maps
            # its scale-s lifted pairs through this
            ds3 = f.require_dataset(f"s{next_scale}/scale_node_labeling",
                                    shape=(len(node_labeling),),
                                    chunks=(max(len(node_labeling), 1),),
                                    dtype="uint64")
            ds3[:] = node_labeling
        log_fn(f"reduced problem: {len(new_uv)} edges at scale {next_scale}")


class SolveGlobal(BlockTask):
    """Single global solve of the reduced problem; writes the final
    fragment -> segment assignment table (reference: SolveGlobal,
    solve_global.py:99+)."""

    task_name = "solve_global"
    global_task = True
    allow_retry = False

    def __init__(self, problem_path: str, scale: int, assignment_path: str,
                 assignment_key: str = "node_labels", **kw):
        self.problem_path = problem_path
        self.scale = scale
        self.assignment_path = assignment_path
        self.assignment_key = assignment_key
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"agglomerator": "kernighan-lin", "time_limit_solver": None})
        return conf

    def run_impl(self):
        self.run_jobs(None, {
            "problem_path": self.problem_path, "scale": self.scale,
            "assignment_path": self.assignment_path,
            "assignment_key": self.assignment_key,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        scale = int(cfg["scale"])
        agglomerator = key_to_agglomerator(
            cfg.get("agglomerator", "kernighan-lin"))

        with stage("store-read"):
            uv_dense, n_nodes, s0_nodes = _load_scale_graph(problem_path,
                                                            scale)
            costs = _load_costs(problem_path, scale)
        with stage("host-solve"):
            labels = agglomerator(n_nodes, uv_dense.astype("int64"), costs,
                                  time_limit=cfg.get("time_limit_solver"))
        log_fn(f"global solve: {n_nodes} nodes -> "
               f"{len(np.unique(labels))} segments")

        final = compose_to_s0(problem_path, scale, labels)
        nodes0, _, _ = g.load_graph(problem_path, "s0/graph")
        table = save_assignment_table(nodes0, final, cfg["assignment_path"])
        log_fn(f"assignments saved: {len(table)} fragment ids")


class SubSolutions(BlockTask):
    """Debug task: paint each block's local sub-solution into a volume so
    per-block multicut results can be inspected before the reduce step
    (reference: multicut/sub_solutions.py:31)."""

    task_name = "sub_solutions"

    def __init__(self, problem_path: str, scale: int, ws_path: str,
                 ws_key: str, output_path: str, output_key: str, **kw):
        self.problem_path = problem_path
        self.scale = scale
        self.ws_path = ws_path
        self.ws_key = ws_key
        self.output_path = output_path
        self.output_key = output_key
        self.identifier = f"s{scale}"
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.ws_path, "r") as f:
            shape = list(f[self.ws_key].shape)
        _, base_bs = _problem_geometry(self.problem_path,
                                       self.global_block_shape())
        scale_bs = [b * 2 ** self.scale for b in base_bs]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key, shape=shape,
                              chunks=[min(c, s)
                                      for c, s in zip(base_bs, shape)],
                              dtype="uint64")
        block_list = self.blocks_in_volume(shape, scale_bs)
        self.run_jobs(block_list, {
            "problem_path": self.problem_path, "scale": self.scale,
            "ws_path": self.ws_path, "ws_key": self.ws_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "shape": shape, "block_shape": base_bs,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from .. import native

        cfg = job_config["config"]
        problem_path = cfg["problem_path"]
        scale = int(cfg["scale"])
        scale_bs = [b * 2 ** scale for b in cfg["block_shape"]]
        blocking = Blocking(cfg["shape"], scale_bs)
        uv_dense, n_nodes, s0_nodes = _load_scale_graph(problem_path, scale)
        if scale > 0:
            # ws carries original fragment labels: compose through the s0
            # node table and the composed s0 -> scale node labeling (read
            # just the node table — the s0 edge array is the largest object
            # in the container and is not needed here)
            with file_reader(problem_path, "r") as f:
                s0_nodes = f["s0/graph"]["nodes"][:]
                to_scale = f[f"s{scale}/node_labeling"][:].astype("int64")
        else:
            to_scale = None
        f_ws = file_reader(cfg["ws_path"], "r")
        f_out = file_reader(cfg["output_path"])
        ds_ws = f_ws[cfg["ws_key"]]
        ds_out = f_out[cfg["output_key"]]

        for block_id in job_config["block_list"]:
            bb = blocking.get_block(block_id).bb
            with np.load(_sub_result_path(problem_path, scale,
                                          block_id)) as d:
                cut_ids = d["cut_edge_ids"]
            # block-local solution: merge every edge NOT cut by this block
            merge = np.ones(len(uv_dense), bool)
            merge[cut_ids] = False
            roots = native.ufd_merge_pairs(n_nodes, uv_dense[merge])
            ws = np.asarray(ds_ws[bb])
            idx = np.searchsorted(s0_nodes, ws)
            idx = np.minimum(idx, max(len(s0_nodes) - 1, 0))
            valid = s0_nodes[idx] == ws
            dense = idx if to_scale is None else to_scale[idx]
            painted = np.where(valid, roots[dense] + 1, 0)
            painted[ws == 0] = 0
            # per-block offset keeps neighboring blocks' ids distinct
            out = np.where(painted > 0,
                           painted.astype("uint64")
                           + np.uint64(block_id) * np.uint64(n_nodes + 1),
                           np.uint64(0))
            ds_out[bb] = out
            log_fn(f"processed block {block_id}")


class MulticutWorkflow(Task):
    """for scale in 0..n_scales-1: SolveSubproblems -> ReduceProblem; then
    SolveGlobal (reference: multicut_workflow.py:49-61)."""

    def __init__(self, problem_path: str, assignment_path: str,
                 tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "local", n_scales: int = 1,
                 dependency: Optional[Task] = None):
        self.problem_path = problem_path
        self.assignment_path = assignment_path
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
            dep = SolveSubproblems(problem_path=self.problem_path,
                                   scale=scale, dependency=dep,
                                   **self._common())
            dep = ReduceProblem(problem_path=self.problem_path, scale=scale,
                                dependency=dep, **self._common())
        return SolveGlobal(problem_path=self.problem_path,
                           scale=self.n_scales,
                           assignment_path=self.assignment_path,
                           dependency=dep, **self._common())

    def output(self):
        from ..core.workflow import FileTarget

        return FileTarget(os.path.join(self.tmp_folder, "solve_global.status"))
