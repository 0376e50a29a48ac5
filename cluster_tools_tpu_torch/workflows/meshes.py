"""Per-object surface meshes.

The reference's ``meshes/`` component is an empty placeholder
(compute_meshes.py / mesh_workflow.py are 0 LoC) with the mesh math in
utils/mesh_utils.py; this framework ships the full blockwise workflow: mesh
each object inside its morphology bounding box (label-id-range sharding)
using the first-party marching-tetrahedra extraction (utils/mesh).
Port of cluster_tools_tpu/workflows/meshes.py (host numpy, as in the JAX
package)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task
from .morphology import MorphologyWorkflow, decode_morphology


class ComputeMeshes(BlockTask):
    """Mesh each object over label-id ranges; one npz (vertices, faces) per
    label under ``<output_path>/<output_key>/``."""

    task_name = "compute_meshes"

    def __init__(self, input_path: str, input_key: str,
                 morphology_path: str, morphology_key: str,
                 output_path: str, output_key: str,
                 n_labels: Optional[int] = None, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.morphology_path = morphology_path
        self.morphology_key = morphology_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        super().__init__(**kw)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"id_chunk_size": 1000, "size_threshold": 0,
                     "smoothing_iterations": 0})
        return conf

    def run_impl(self):
        self.resolve_n_labels(self.input_path, self.input_key)
        chunk = int(self.task_config.get("id_chunk_size", 1000))
        os.makedirs(os.path.join(self.output_path, self.output_key),
                    exist_ok=True)
        self.run_jobs(self.id_chunks(self.n_labels, chunk), {
            "input_path": self.input_path, "input_key": self.input_key,
            "morphology_path": self.morphology_path,
            "morphology_key": self.morphology_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "n_labels": self.n_labels, "id_chunk_size": chunk,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..utils.mesh import object_mesh

        cfg = job_config["config"]
        chunk, n_labels = cfg["id_chunk_size"], cfg["n_labels"]
        smoothing = int(cfg.get("smoothing_iterations", 0))
        size_threshold = cfg.get("size_threshold", 0)
        f_morph = file_reader(cfg["morphology_path"], "r")
        ds_morph = f_morph[cfg["morphology_key"]]
        f_in = file_reader(cfg["input_path"], "r")
        ds_in = f_in[cfg["input_key"]]
        out_dir = os.path.join(cfg["output_path"], cfg["output_key"])

        for block_id in job_config["block_list"]:
            lo, hi = block_id * chunk, min((block_id + 1) * chunk, n_labels)
            morpho = ds_morph[lo:hi, :]
            sizes, bb_min, bb_max = decode_morphology(morpho)
            for label_id in range(max(lo, 1), hi):
                k = label_id - lo
                if sizes[k] == 0 or (size_threshold
                                     and sizes[k] < size_threshold):
                    continue
                bb = tuple(slice(b, e) for b, e in zip(bb_min[k], bb_max[k]))
                seg = np.asarray(ds_in[bb])
                verts, faces = object_mesh(seg, label_id,
                                           smoothing_iterations=smoothing)
                verts += bb_min[k]  # back to global coordinates
                tmp = os.path.join(out_dir, f"mesh_{label_id}.tmp.npz")
                np.savez(tmp, vertices=verts.astype("float32"),
                         faces=faces.astype("int64"))
                os.replace(tmp, os.path.join(out_dir,
                                             f"mesh_{label_id}.npz"))
            log_fn(f"processed block {block_id}")


def load_mesh(output_path: str, output_key: str, label_id: int):
    """(vertices, faces) of one object's mesh, or None."""
    path = os.path.join(output_path, output_key, f"mesh_{label_id}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return d["vertices"], d["faces"]


class MeshWorkflow(Task):
    """MorphologyWorkflow -> ComputeMeshes (the mesh_workflow.py the
    reference left empty)."""

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 n_labels: Optional[int] = None,
                 morphology_key: str = "morphology",
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_labels = n_labels
        self.morphology_key = morphology_key
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        morpho = MorphologyWorkflow(
            input_path=self.input_path, input_key=self.input_key,
            output_path=self.output_path, output_key=self.morphology_key,
            n_labels=self.n_labels, prefix="mesh",
            dependency=self.dependency, **common)
        return ComputeMeshes(
            input_path=self.input_path, input_key=self.input_key,
            morphology_path=self.output_path,
            morphology_key=self.morphology_key,
            output_path=self.output_path, output_key=self.output_key,
            n_labels=self.n_labels, dependency=morpho, **common)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "compute_meshes.status"))
