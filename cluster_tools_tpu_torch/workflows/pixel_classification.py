"""Filter-bank features + RF pixel classification — the ilastik replacement.

Port of cluster_tools_tpu/workflows/pixel_classification.py.  The
reference shells out to the external ilastik binary for headless pixel
classification (ilastik/prediction.py:104-228) and separately precomputes
filter features (features/image_filter.py:24); both are first-party here:

* ``ImageFilterTask`` — blockwise multi-filter/multi-scale feature stacks
  (gaussian, gaussian-gradient-magnitude, laplacian-of-gaussian — the core
  of ilastik's feature matrix), separable filters on the device with halo
  reads.
* ``TrainPixelClassifier`` / ``PredictPixelClassifier`` — sklearn RF over
  the device-computed features: trained from a sparse scribble volume
  (0 = unlabeled, 1..K = class labels), predicted blockwise with halo and
  written as per-class probability channels.  sklearn is imported where
  a job runs, so a host without it can import the module.
* ``WriteCarving`` — the graph and edge weights as an ilastik carving
  project, an HDF5 file written by the package's own writer
  (``core/hdf5.py``: no h5py).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.blocking import Blocking
from ..core.device import task_device
from ..core.runtime import BlockTask
from ..core.storage import file_reader
from ..core.workflow import FileTarget, Task

#: ilastik-style default feature matrix: (filter, sigma); names follow the
#: reference's vigra-style registry (ops/filters.FILTERS)
DEFAULT_FEATURES: Tuple[Tuple[str, float], ...] = (
    ("gaussianSmoothing", 0.7), ("gaussianSmoothing", 1.6),
    ("gaussianSmoothing", 3.5),
    ("gaussianGradientMagnitude", 1.6), ("gaussianGradientMagnitude", 3.5),
    ("laplacianOfGaussian", 1.6), ("laplacianOfGaussian", 3.5),
)


def compute_feature_stack(data: np.ndarray,
                          features: Sequence[Sequence] = DEFAULT_FEATURES,
                          device: str = "cuda") -> np.ndarray:
    """(n_features, *shape) float32 filter responses, computed on
    ``device``."""
    import torch

    from ..ops.filters import apply_filter

    x = torch.from_numpy(np.ascontiguousarray(data, dtype="float32")).to(
        device)
    out = [apply_filter(x, name, sigma).cpu().numpy()
           for name, sigma in features]
    return np.stack(out).astype("float32")


class ImageFilterTask(BlockTask):
    """Blockwise precomputed filter features (reference:
    features/image_filter.py:24): output channel c holds filter c of the
    configured feature matrix."""

    task_name = "image_filter"

    def __init__(self, input_path: str, input_key: str, output_path: str,
                 output_key: str,
                 features: Sequence[Sequence] = DEFAULT_FEATURES, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.output_path = output_path
        self.output_key = output_key
        self.features = [list(f) for f in features]
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape()[-len(shape):], shape)]
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key,
                              shape=[len(self.features)] + shape,
                              chunks=[1] + block_shape, dtype="float32")
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "output_path": self.output_path, "output_key": self.output_key,
            "features": self.features,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from ..core.device import resolve_device

        cfg = job_config["config"]
        device = str(resolve_device(cfg["device"]))
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        features = cfg["features"]
        halo = [_filter_halo(features)] * blocking.ndim
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        for block_id in job_config["block_list"]:
            bh = blocking.get_block_with_halo(block_id, halo)
            x = np.asarray(ds_in[bh.outer.bb]).astype("float32")
            stack = compute_feature_stack(x, features, device=device)
            ds_out[(slice(None),) + bh.inner.bb] = \
                stack[(slice(None),) + bh.inner_local.bb]
            log_fn(f"processed block {block_id}")


def _filter_halo(features) -> int:
    return int(max(4 * float(s) + 1 for _, s in features))


class TrainPixelClassifier(BlockTask):
    """Fit an RF on filter features at scribble-labeled voxels (the ilastik
    training step, first-party)."""

    task_name = "train_pixel_classifier"
    global_task = True
    allow_retry = False

    def __init__(self, input_path: str, input_key: str, labels_path: str,
                 labels_key: str, output_path: str,
                 features: Sequence[Sequence] = DEFAULT_FEATURES, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.features = [list(f) for f in features]
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"n_trees": 100})
        return conf

    def run_impl(self):
        self.run_jobs(None, {
            "input_path": self.input_path, "input_key": self.input_key,
            "labels_path": self.labels_path, "labels_key": self.labels_key,
            "output_path": self.output_path, "features": self.features,
            "device": self.device,
        })

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        from sklearn.ensemble import RandomForestClassifier

        cfg = job_config["config"]
        with file_reader(cfg["labels_path"], "r") as f:
            ds = f[cfg["labels_key"]]
            labels = ds[tuple(slice(0, s) for s in ds.shape)]
        # restrict feature computation to the scribble bounding box + filter
        # halo: scribbles cover a tiny fraction of cluster-scale volumes,
        # and the full-volume feature stack would not fit one host
        nz = np.nonzero(labels > 0)
        if len(nz[0]) == 0:
            raise ValueError("no scribble labels > 0 found")
        halo = _filter_halo(cfg["features"])
        lo = [max(int(c.min()) - halo, 0) for c in nz]
        hi = [min(int(c.max()) + 1 + halo, s)
              for c, s in zip(nz, labels.shape)]
        bb = tuple(slice(a, b) for a, b in zip(lo, hi))
        with file_reader(cfg["input_path"], "r") as f:
            data = np.asarray(f[cfg["input_key"]][bb])
        labels = labels[bb]
        stack = compute_feature_stack(data, cfg["features"],
                                      device=cfg["device"])
        sel = labels > 0
        X = stack[:, sel].T
        y = labels[sel]
        log_fn(f"training RF on {len(y)} scribble voxels, "
               f"{X.shape[1]} features, {len(np.unique(y))} classes")
        rf = RandomForestClassifier(
            n_estimators=int(cfg.get("n_trees", 100)),
            n_jobs=int(cfg.get("threads_per_job", 1)))
        rf.fit(X, y)
        with open(cfg["output_path"], "wb") as f:
            pickle.dump({"rf": rf, "features": cfg["features"]}, f)


class PredictPixelClassifier(BlockTask):
    """Blockwise RF prediction over filter features (the ilastik headless
    prediction step, ilastik/prediction.py:104-228): per-class probability
    channels, halo reads, uint8 or float32 output."""

    task_name = "predict_pixel_classifier"

    def __init__(self, input_path: str, input_key: str, classifier_path: str,
                 output_path: str, output_key: str, n_classes: int, **kw):
        self.input_path = input_path
        self.input_key = input_key
        self.classifier_path = classifier_path
        self.output_path = output_path
        self.output_key = output_key
        self.n_classes = n_classes
        super().__init__(**kw)
        self.device = task_device(self.global_config)

    @staticmethod
    def default_task_config():
        conf = BlockTask.default_task_config()
        conf.update({"dtype": "float32"})
        return conf

    def run_impl(self):
        with file_reader(self.input_path, "r") as f:
            shape = list(f[self.input_key].shape)
        block_shape = [min(b, s) for b, s in
                       zip(self.global_block_shape()[-len(shape):], shape)]
        dtype = self.task_config.get("dtype", "float32")
        with file_reader(self.output_path) as f:
            f.require_dataset(self.output_key,
                              shape=[self.n_classes] + shape,
                              chunks=[1] + block_shape, dtype=dtype)
        block_list = self.blocks_in_volume(shape, block_shape)
        self.run_jobs(block_list, {
            "input_path": self.input_path, "input_key": self.input_key,
            "classifier_path": self.classifier_path,
            "output_path": self.output_path, "output_key": self.output_key,
            "n_classes": self.n_classes,
            "shape": shape, "block_shape": block_shape,
            "device": self.device,
        }, n_jobs=self.max_jobs)

    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        with open(cfg["classifier_path"], "rb") as f:
            bundle = pickle.load(f)
        rf, features = bundle["rf"], bundle["features"]
        rf.n_jobs = int(cfg.get("threads_per_job", 1))
        halo = [_filter_halo(features)] * blocking.ndim
        ds_in = file_reader(cfg["input_path"], "r")[cfg["input_key"]]
        ds_out = file_reader(cfg["output_path"])[cfg["output_key"]]
        dtype = np.dtype(cfg.get("dtype", "float32"))
        classes = list(rf.classes_)
        bad = [int(c) for c in classes
               if not 1 <= int(c) <= cfg["n_classes"]]
        if bad:
            raise ValueError(
                f"classifier was trained on classes {classes} but the "
                f"workflow allocates n_classes={cfg['n_classes']} channels "
                f"(classes {bad} would be dropped) — scribble labels must "
                "be 1..n_classes")

        for block_id in job_config["block_list"]:
            bh = blocking.get_block_with_halo(block_id, halo)
            x = np.asarray(ds_in[bh.outer.bb]).astype("float32")
            stack = compute_feature_stack(x, features, device=cfg["device"])
            inner = stack[(slice(None),) + bh.inner_local.bb]
            flat = inner.reshape(inner.shape[0], -1).T
            proba = rf.predict_proba(flat)
            out = np.zeros((cfg["n_classes"],) + inner.shape[1:], "float32")
            for col, cls_label in enumerate(classes):
                ch = int(cls_label) - 1
                if 0 <= ch < cfg["n_classes"]:
                    out[ch] = proba[:, col].reshape(inner.shape[1:])
            if dtype == np.uint8:
                out = np.clip(np.round(out * 255), 0, 255)
            ds_out[(slice(None),) + bh.inner.bb] = out.astype(dtype)
            log_fn(f"processed block {block_id}")


class PixelClassificationWorkflow(Task):
    """Train on scribbles -> predict blockwise (the IlastikPredictionWorkflow
    capability, first-party)."""

    def __init__(self, input_path: str, input_key: str, labels_path: str,
                 labels_key: str, output_path: str, output_key: str,
                 n_classes: int, tmp_folder: str, config_dir: str,
                 max_jobs: int = 1, target: str = "gpu",
                 features: Sequence[Sequence] = DEFAULT_FEATURES,
                 dependency: Optional[Task] = None):
        self.input_path = input_path
        self.input_key = input_key
        self.labels_path = labels_path
        self.labels_key = labels_key
        self.output_path = output_path
        self.output_key = output_key
        self.n_classes = n_classes
        self.features = features
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = max_jobs
        self.target = target
        self.dependency = dependency
        super().__init__()

    def requires(self):
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                      max_jobs=self.max_jobs, target=self.target)
        classifier_path = os.path.join(self.tmp_folder,
                                       "pixel_classifier.pkl")
        train = TrainPixelClassifier(
            input_path=self.input_path, input_key=self.input_key,
            labels_path=self.labels_path, labels_key=self.labels_key,
            output_path=classifier_path, features=self.features,
            dependency=self.dependency, **common)
        return PredictPixelClassifier(
            input_path=self.input_path, input_key=self.input_key,
            classifier_path=classifier_path, output_path=self.output_path,
            output_key=self.output_key, n_classes=self.n_classes,
            dependency=train, **common)

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "predict_pixel_classifier.status"))


class WriteCarving(Task):
    """Export graph + edge weights as an ilastik carving project (.ilp h5)
    (reference: ilastik/carving.py:10-123 ``WriteCarving``).

    The graph dataset follows the serialization the reference targets
    (vigra adjacencyListGraph): a flat uint32 array
    ``[n_nodes, n_edges, max_node_id, max_edge_id] + uv_ids.ravel() +
    neighborhoods``.  ``n_nodes`` counts the DISTINCT node ids present
    (the vigra convention — smaller than ``max_node_id + 1`` when ids are
    non-consecutive), while ``neighborhoods`` is POSITIONAL over all
    ``max_node_id + 1`` ids in order — isolated ids contribute a degree-0
    record; readers must size the section from ``max_node_id``, not
    ``n_nodes``.  Each record is the node's degree followed by
    (neighbor_id, edge_id) pairs sorted by neighbor.
    Edge weights are the mean-probability feature column rescaled to the
    carving convention's 0-255 range (reference: carving.py:57-69)."""

    def __init__(self, graph_path: str, graph_key: str, features_path: str,
                 features_key: str, output_path: str, raw_path: str,
                 raw_key: str, uid: str, tmp_folder: str,
                 copy_inputs: bool = False,
                 dependency: Optional[Task] = None):
        self.graph_path = graph_path
        self.graph_key = graph_key
        self.features_path = features_path
        self.features_key = features_key
        self.output_path = output_path
        self.raw_path = raw_path
        self.raw_key = raw_key
        self.uid = uid
        self.copy_inputs = copy_inputs
        self.tmp_folder = tmp_folder
        self.dependency = dependency
        super().__init__()

    def requires(self):
        return self.dependency

    @staticmethod
    def serialize_graph(uv_ids: np.ndarray,
                        max_node_id: int) -> np.ndarray:
        """Flat uint32 serialization (header + uv ids + neighborhoods).

        The header matches the vigra adjacencyListGraph convention: n_nodes
        is the number of DISTINCT node ids present (not max_node_id + 1 —
        they differ for non-consecutive ids), and an empty graph's
        max_edge_id is -1, which wraps to 0xFFFFFFFF in uint32."""
        n_edges = len(uv_ids)
        n_nodes = len(np.unique(uv_ids)) if n_edges else 0
        header = np.array([n_nodes, n_edges,
                           max_node_id, n_edges - 1],
                          "int64").astype("uint32")
        # per-node adjacency: degree, then (neighbor, edge_id) by neighbor
        adj = [[] for _ in range(max_node_id + 1)]
        for eid, (u, v) in enumerate(uv_ids):
            adj[u].append((v, eid))
            adj[v].append((u, eid))
        hoods = []
        for node_adj in adj:
            hoods.append(len(node_adj))
            for nb, eid in sorted(node_adj):
                hoods.extend((nb, eid))
        return np.concatenate([header, uv_ids.astype("uint32").ravel(),
                               np.asarray(hoods, "uint32")])

    def run(self):
        import time

        from ..core import hdf5
        from ..core.graph import load_graph

        _, edges, attrs = load_graph(self.graph_path, self.graph_key)
        if len(edges) and int(edges.max()) >= 2 ** 32:
            raise ValueError(
                f"carving serialization is uint32; node ids reach "
                f"{int(edges.max())} — relabel to consecutive ids first")
        uv_ids = edges.astype("uint32")
        max_node_id = int(uv_ids.max()) if len(uv_ids) else 0
        serialization = self.serialize_graph(uv_ids, max_node_id)

        with file_reader(self.features_path, "r") as f:
            feats = np.asarray(f[self.features_key][:, 0])
        feats = feats * 255.0  # carving weights use the 0-255 range

        # mode 'w' truncates: a retry after a partial previous run must not
        # trip over half-written groups (the export is single-writer)
        with hdf5.File(self.output_path, "w") as f:
            g = f.create_group("preprocessing/graph")
            g.create_dataset("graph", data=serialization,
                             compression="gzip")
            g.create_dataset("nodeSeeds", shape=(max_node_id + 1,),
                             dtype="uint8")
            g.create_dataset("resultSegmentation", shape=(max_node_id + 1,),
                             dtype="uint8")
            g.attrs["numNodes"] = max_node_id + 1
            g.create_dataset("edgeWeights", data=feats)

            gi = f.create_group("Input Data")
            gi.create_dataset("Role Names",
                              data=[b"Raw Data", b"Overlay"])
            gi.create_dataset("StorageVersion", data="0.2")
            gi.create_group("local_data")
            lane = f.create_group("Input Data/infos/lane0000/Raw Data")
            lane.create_dataset("allowLabels", data=True)
            lane.create_dataset("axisorder", data=b"zyx")
            lane.create_dataset("fromstack", data=False)
            lane.create_dataset("datasetId", data=self.uid.encode("utf-8"))
            lane.create_dataset("display_mode", data=b"default")
            lane.create_dataset(
                "filePath",
                data=os.path.join(self.raw_path,
                                  self.raw_key).encode("utf-8"))
            lane.create_dataset(
                "location", data=b"ProjectInternal" if self.copy_inputs
                else b"FileSystem")
            lane.create_dataset("nickname", data=b"Input")

            f.create_dataset("workflowName", data=b"Carving")
            f.create_dataset("ilastikVersion", data=b"1.3.0b2")
            f.create_dataset("currentApplet", data=2)
            f.create_dataset("time", data=time.ctime().encode("utf-8"))
            f.create_dataset("preprocessing/StorageVersion", data="0.1")
            f.create_dataset("preprocessing/filter", data=3)
            f.create_dataset("preprocessing/sigma", data=1.0)
            f.create_dataset("preprocessing/invert_watershed_source",
                             data=False)
            f.create_dataset("preprocessing/watershed_source",
                             data=b"filtered")
            f.create_dataset("carving/StorageVersion", data="0.1")
            f.create_group("carving/objects")
        self.output().touch()

    def output(self):
        return FileTarget(os.path.join(self.tmp_folder,
                                       "write_carving.status"))
