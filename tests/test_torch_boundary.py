"""Import boundary and device default of the port.

The port (``cluster_tools_tpu_torch``) and its scripts for the card
(``chip_smoke.py``, ``chip_profile.py``, ``chip_edt_compare.py``) import
torch and never jax or the JAX package, nor h5py, tensorstore or
numcodecs (the port's storage formats are its own); the card is the
default device, and a run that asks for it on a host without one raises
instead of carrying on on the CPU."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cluster_tools_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _sources():
    for mod in _port_modules():
        path = os.path.join(ROOT, *mod.split("."))
        path = path + ".py" if os.path.exists(path + ".py") else \
            os.path.join(path, "__init__.py")
        yield path
    for script in ("chip_smoke.py", "chip_profile.py", "chip_edt_compare.py"):
        yield os.path.join(ROOT, script)


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "cluster_tools_tpu", "flax"):
                    bad.append((os.path.relpath(path, ROOT), name))
    assert not bad, bad


def test_no_source_imports_a_storage_library():
    """No source of the port imports h5py, tensorstore or numcodecs, at
    module level or inside a function, and importing every module loads
    none of them."""
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in ("h5py", "tensorstore",
                                           "numcodecs")]
    assert not bad, bad
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('h5py', 'tensorstore', 'numcodecs', 'sklearn', 'imageio'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok", res.stdout


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, runpy, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, "
        "run_name='chip_smoke_import')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cluster_tools_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok", res.stdout


def test_split_and_fused_chain_modules_are_held_to_the_rule():
    """The modules both chains run are among those the two checks above
    walk."""
    mods = set(_port_modules())
    for name in ("core.device", "core.volume_views", "ops.rag",
                 "workflows.watershed", "workflows.relabel",
                 "workflows.graph", "workflows.features",
                 "workflows.segmentation", "workflows.fused_pipeline"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name


def test_affinity_path_modules_are_held_to_the_rule():
    """The modules of the affinity path (U-Net inference, mutex
    watershed) are among those the two checks above walk."""
    mods = set(_port_modules())
    for name in ("models.unet", "models.checkpoint", "models.frameworks",
                 "ops.mws", "workflows.inference",
                 "workflows.mutex_watershed"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name


def test_components_stitching_and_evaluation_modules_are_held_to_the_rule():
    """The modules of connected components, block stitching, node labels
    and evaluation are among those the two checks above walk."""
    mods = set(_port_modules())
    for name in ("ops.components", "ops.overlaps", "utils.validation",
                 "workflows.thresholded_components", "workflows.stitching",
                 "workflows.node_labels", "workflows.evaluation",
                 "workflows.segmentation"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name


def test_affinity_path_raises_without_a_card(tmp_path):
    """InferenceTask and the mutex-watershed workflows default to the
    card too, and raise on a host without one before any work runs."""
    import numpy as np
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    path = str(tmp_path / "d.n5")
    with ctp.file_reader(path) as f:
        f.require_dataset("affs", shape=(3, 8, 8, 8), chunks=(1, 8, 8, 8),
                          dtype="uint8")[:] = np.zeros((3, 8, 8, 8), "uint8")
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8]})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctp.InferenceTask(input_path=path, input_key="raw",
                          output_path=path, output_key={"a": [0, 3]},
                          checkpoint_path="ckpt", halo=[0, 0, 0], **common)
    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    for wf in (ctp.MwsWorkflow(input_path=path, input_key="affs",
                               output_path=path, output_key="seg",
                               offsets=offsets, **common),
               ctp.TwoPassMwsWorkflow(input_path=path, input_key="affs",
                                      output_path=path, output_key="seg",
                                      offsets=offsets, halo=[1, 1, 1],
                                      **common)):
        assert wf.target == "gpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctp.build([wf])
    with ctp.file_reader(path, "r") as f:
        assert "seg" not in f


def test_default_device_is_the_card_and_raises_without_one(tmp_path):
    """The global config's device defaults to "cuda"; building the
    multicut workflow with it on this card-less host raises at DAG
    construction (before any work runs) — the split chain (the default)
    and the fused chain alike — and the workflow's target defaults to
    "gpu"."""
    import numpy as np
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import (ConfigDir,
                                                     default_global_config)

    assert default_global_config()["device"] == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    path = str(tmp_path / "d.n5")
    with ctp.file_reader(path) as f:
        f.require_dataset("bmap", shape=(8, 8, 8), chunks=(8, 8, 8),
                          dtype="uint8")[:] = np.zeros((8, 8, 8), "uint8")
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8]})
    kw = dict(input_path=path, input_key="bmap", ws_path=path, ws_key="ws",
              problem_path=str(tmp_path / "p.n5"), output_path=path,
              output_key="seg", tmp_folder=str(tmp_path / "tmp"),
              config_dir=cfg)
    wf = ctp.MulticutSegmentationWorkflow(**kw)
    assert wf.target == "gpu" and not wf.fused
    ws = ctp.WatershedWorkflow(
        input_path=path, input_key="bmap", output_path=path, output_key="ws",
        tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    assert ws.target == "gpu"
    for last in (ctp.MulticutSegmentationWorkflow(dependency=ws, **kw),
                 ctp.MulticutSegmentationWorkflow(fused=True, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctp.build([last])
    # nothing ran: no fragments were written, no task completed
    with ctp.file_reader(path, "r") as f:
        assert "ws" not in f
    assert not os.path.exists(str(tmp_path / "tmp" /
                                  "fused_segmentation.status"))


def test_port_exports_are_the_jax_package_exports():
    """Every name the port exports is one the JAX package exports, and the
    ported workflows the JAX package exports can be imported from the
    port's top level."""
    import cluster_tools_tpu
    import cluster_tools_tpu_torch as ctp

    assert set(ctp.__all__) <= set(cluster_tools_tpu.__all__), \
        sorted(set(ctp.__all__) - set(cluster_tools_tpu.__all__))
    for name in ("GraphWorkflow", "MulticutWorkflow", "RelabelWorkflow",
                 "LiftedMulticutSegmentationWorkflow",
                 "AgglomerativeClusteringWorkflow", "AgglomerateTask",
                 "WatershedFromSeedsTask",
                 "LiftedFeaturesFromNodeLabelsWorkflow",
                 "LiftedMulticutWorkflow"):
        assert name in ctp.__all__ and getattr(ctp, name).__module__ \
            .startswith("cluster_tools_tpu_torch."), name


def test_lifted_and_agglomeration_modules_are_held_to_the_rule():
    """The modules of the lifted multicut and agglomerative clustering
    segmentations are among those the two import checks walk."""
    mods = set(_port_modules())
    for name in ("native", "workflows.lifted_features",
                 "workflows.lifted_multicut",
                 "workflows.agglomerative_clustering"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name


def test_serving_and_edits_modules_are_held_to_the_rule():
    """The serving layer (the resident server, its load harness and SLO
    engine) and the proofreading subsystem are among the modules the two
    import checks walk, and the package exports no server name (the JAX
    package's top level exports none either)."""
    import cluster_tools_tpu_torch as ctp

    mods = set(_port_modules())
    for name in ("core.server", "core.loadgen", "core.slo", "edits",
                 "edits.log", "edits.resolver", "edits.incremental",
                 "edits.patcher", "edits.service", "workflows.paintera"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    for name in ("ResidentSegmentationServer", "FusedROIPipeline",
                 "EditPipeline", "EditSession"):
        assert name not in ctp.__all__, name


@pytest.mark.parametrize("which", ["watershed_from_seeds", "agglomerate",
                                   "lifted_multicut", "agglomerative"])
def test_new_device_tasks_raise_without_a_card(tmp_path, which):
    """The seeded watershed and agglomeration tasks and the two new
    segmentation workflows (whose problem assembly runs on the device)
    default to the card, and raise on a host without one before any work
    runs."""
    import torch

    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8]})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    io = dict(input_path="a.n5", input_key="x", output_path="a.n5",
              output_key="s")
    seg = dict(ws_path="a.n5", ws_key="w", problem_path="p.n5", **io)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "watershed_from_seeds":
            ctp.WatershedFromSeedsTask(seeds_path="a.n5", seeds_key="k",
                                       **io, **common)
        elif which == "agglomerate":
            ctp.AgglomerateTask(labels_path="a.n5", labels_key="w", **io,
                                **common)
        elif which == "lifted_multicut":
            ctp.build([ctp.LiftedMulticutSegmentationWorkflow(
                labels_path="a.n5", labels_key="l", lifted_prefix="l",
                **seg, **common)])
        else:
            ctp.build([ctp.AgglomerativeClusteringWorkflow(
                threshold=0.5, **seg, **common)])


@pytest.mark.parametrize("task,task_cfg,kw,match", [
    ("watershed", {}, {"target": "mesh"}, "ROADMAP A14"),
])
def test_unported_split_chain_options_raise(tmp_path, task, task_cfg, kw,
                                            match):
    """The split chain's options that once raised, naming their ROADMAP
    item, now construct (the watershed's ``target="mesh"``, A14:
    ``tests/test_torch_mesh_exec.py``; the filter-bank edge features,
    A13: ``tests/test_torch_edge_filters.py``; the random-forest edge
    probabilities, A16: ``test_edge_costs_rf_path_runs_rf_predict``), and
    no source of the port names the item in a raise any more."""
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows.watershed import WatershedTask

    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu"})
    ConfigDir(cfg).write_task_config(task, task_cfg)
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg, **kw)
    t = WatershedTask(input_path="a.n5", input_key="x",
                      output_path="a.n5", output_key="w", **common)
    assert t.target == kw["target"]
    _no_source_names(match)


def _no_source_names(item: str) -> None:
    bad = []
    for path in _sources():
        with open(path) as f:
            if item in f.read():
                bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


def test_edge_costs_rf_path_runs_rf_predict(tmp_path):
    """``EdgeCostsWorkflow(rf_path=...)`` puts the random forest's
    prediction before the cost transform, as the JAX package does: its
    dependency is an ``RFPredict`` into the features' container under
    ``rf_probs`` (``tests/test_torch_learning.py`` runs it)."""
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows.costs import EdgeCostsWorkflow
    from cluster_tools_tpu_torch.workflows.learning import RFPredict

    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu"})
    task = EdgeCostsWorkflow(features_path="p.n5", features_key="f",
                             output_path="p.n5", output_key="c",
                             graph_path="p.n5", rf_path="rf.pkl",
                             tmp_folder=str(tmp_path / "tmp"),
                             config_dir=cfg).requires()
    assert (task.input_path, task.input_key) == ("p.n5", "rf_probs")
    rf = task.dependency
    assert isinstance(rf, RFPredict) and rf.rf_path == "rf.pkl"
    assert (rf.output_path, rf.output_key) == ("p.n5", "rf_probs")


def test_no_raise_names_the_filter_bank_item():
    """A13 (filter banks and the workflows that use them) is ported: no
    ``NotImplementedError`` of the port names it."""
    bad = []
    for path in _sources():
        with open(path) as f:
            if "ROADMAP A13" in f.read():
                bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


def test_filter_bank_modules_are_held_to_the_rule():
    """The filter bank and the workflows that use it (affinities, volume
    copies, pyramids and object fitting, pixel classification, region
    features, post-processing) are among the modules the two import
    checks walk, and the package exports the JAX package's names of
    them."""
    import cluster_tools_tpu_torch as ctp

    mods = set(_port_modules())
    for name in ("ops.filters", "ops.edt", "workflows.affinities",
                 "workflows.copy_volume", "workflows.downscaling",
                 "workflows.pixel_classification",
                 "workflows.region_features", "workflows.postprocess"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    for name in ("InsertAffinities", "SmoothedGradients", "CopyVolumeTask",
                 "DownscalingWorkflow", "PainteraToBdvWorkflow",
                 "ScaleToBoundariesTask", "UpscaleTask", "ImageFilterTask",
                 "PixelClassificationWorkflow", "WriteCarving",
                 "RegionFeaturesWorkflow", "SizeFilterWorkflow",
                 "FilterLabelsWorkflow", "FilterByThresholdWorkflow",
                 "ConnectedComponentsWorkflow", "FilterOrphansWorkflow",
                 "SizeFilterAndGraphWatershedWorkflow"):
        assert name in ctp.__all__ and getattr(ctp, name).__module__ \
            .startswith("cluster_tools_tpu_torch.workflows."), name


@pytest.mark.parametrize("task_cfg,match", [
    ({"mesh_resident": True}, "ROADMAP A14"),
])
def test_unported_fused_options_raise(tmp_path, task_cfg, match):
    """The fused chain's ``mesh_resident`` (A14) once raised; it now
    constructs (``tests/test_torch_mesh_resident.py`` runs it) and no
    source of the port names A14 in a raise."""
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows.fused_pipeline import \
        FusedSegmentationBlocks

    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu"})
    ConfigDir(cfg).write_task_config("fused_segmentation", task_cfg)
    t = FusedSegmentationBlocks(
        input_path="a.n5", input_key="x", output_path="a.n5",
        output_key="w", problem_path="p.n5",
        tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    assert t.task_config["mesh_resident"] is True
    _no_source_names(match)


def test_unknown_fused_ws_method_raises(tmp_path):
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows.fused_pipeline import \
        FusedSegmentationBlocks

    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu"})
    ConfigDir(cfg).write_task_config("fused_segmentation",
                                     {"ws_method": "basins"})
    with pytest.raises(ValueError, match="unknown ws_method"):
        FusedSegmentationBlocks(
            input_path="a.n5", input_key="x", output_path="a.n5",
            output_key="w", problem_path="p.n5",
            tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)


def test_mesh_target_raises(tmp_path):
    """The ``mesh`` target once raised (A14); it is now the inline
    executor, as in the JAX package: mesh-aware tasks spread their blocks
    over the shard devices, the others run inline in the driver process."""
    from cluster_tools_tpu_torch.core.runtime import (EXECUTORS,
                                                      _InlineExecutor)

    assert isinstance(EXECUTORS["mesh"](), _InlineExecutor)
    assert EXECUTORS["mesh"] is EXECUTORS["gpu"]


def test_post_segmentation_modules_are_held_to_the_rule():
    """The tools run after a segmentation (morphology, meshes, skeletons,
    label multisets, the Paintera and BigCat exports), masking, the
    decomposition multicut, the debugging checks, the affine and mesh
    utilities, the telemetry rollups and the sweep ops are among the
    modules the two import checks walk; the package exports the JAX
    package's names of them, and no source of the port names their
    ROADMAP item (A17b) as still to come."""
    import cluster_tools_tpu_torch as ctp

    mods = set(_port_modules())
    for name in ("workflows.morphology", "workflows.masking",
                 "workflows.decomposition", "workflows.debugging",
                 "workflows.meshes", "workflows.skeletons",
                 "workflows.label_multisets", "workflows.paintera",
                 "utils", "utils.mesh", "utils.transformations",
                 "core.telemetry", "ops.sweep", "native"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    for name in ("BigcatWorkflow", "PainteraConversionWorkflow",
                 "LabelMultisetWorkflow", "MorphologyWorkflow",
                 "MeshWorkflow", "SkeletonWorkflow", "UpsampleSkeletons",
                 "BlocksFromMask", "MinFilterMask", "DecompositionWorkflow",
                 "CheckSubGraphs", "CheckComponents"):
        assert name in ctp.__all__ and getattr(ctp, name).__module__ \
            .startswith("cluster_tools_tpu_torch.workflows."), name
    bad = []
    for path in _sources():
        with open(path) as f:
            if "A17b" in f.read():
                bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


def test_storage_and_host_extras_are_held_to_the_rule():
    """The hand-written HDF5 and blosc, the Knossos reader, the random
    forest's workflows and the port's lint are among the modules the
    import checks walk; the port exports the JAX package's names of
    them (its ``__all__`` is now the JAX package's), and no source of the
    port names their ROADMAP item (A16) as still to come."""
    import cluster_tools_tpu
    import cluster_tools_tpu.utils
    import cluster_tools_tpu_torch as ctp
    import cluster_tools_tpu_torch.utils

    mods = set(_port_modules())
    for name in ("core.hdf5", "core.blosc", "utils.knossos",
                 "workflows.learning", "analysis", "analysis.base",
                 "analysis.sources", "analysis.registry",
                 "analysis.config_keys", "analysis.locks",
                 "analysis.atomic_write", "analysis.dtype_discipline",
                 "analysis.boundary", "analysis.fallback",
                 "analysis.__main__"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    assert sorted(ctp.__all__) == sorted(cluster_tools_tpu.__all__)
    assert ctp.LearningWorkflow.__module__ == \
        "cluster_tools_tpu_torch.workflows.learning"
    assert sorted(cluster_tools_tpu_torch.utils.__all__) == \
        sorted(cluster_tools_tpu.utils.__all__)
    bad = []
    for path in _sources():
        with open(path) as f:
            if "ROADMAP A16" in f.read():
                bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


def test_multi_device_modules_are_held_to_the_rule():
    """The multi-device modules (the device mesh, the halo ring, the
    multi-process runs, the mesh CC) are among the modules the two import
    checks walk, and importing them loads neither jax nor the JAX
    package."""
    mods = set(_port_modules())
    for name in ("parallel", "parallel.mesh", "parallel.stencil",
                 "parallel.multihost", "workflows.mesh_blockwise"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    code = ("import sys\n"
            "import cluster_tools_tpu_torch.parallel.mesh\n"
            "import cluster_tools_tpu_torch.parallel.stencil\n"
            "import cluster_tools_tpu_torch.parallel.multihost\n"
            "import cluster_tools_tpu_torch.workflows.mesh_blockwise\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cluster_tools_tpu', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_training_modules_are_held_to_the_rule():
    """The training module and the pipeline, expert and ring-attention
    primitives are among the modules the import checks walk; importing
    them loads neither jax, flax, optax, orbax nor the JAX package; no
    source imports optax or orbax; the port's ``parallel`` exports every
    name of the JAX package's ``parallel/__init__.py``; and no source of
    the port names A15 as still to come."""
    import cluster_tools_tpu.parallel as jpar
    import cluster_tools_tpu_torch.parallel as ppar

    mods = set(_port_modules())
    for name in ("models.train", "parallel.pipeline", "parallel.experts",
                 "parallel.ring_attention"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    code = ("import sys\n"
            "import cluster_tools_tpu_torch.models.train\n"
            "import cluster_tools_tpu_torch.models.checkpoint\n"
            "import cluster_tools_tpu_torch.parallel.pipeline\n"
            "import cluster_tools_tpu_torch.parallel.experts\n"
            "import cluster_tools_tpu_torch.parallel.ring_attention\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cluster_tools_tpu', 'flax', 'optax', "
            "'orbax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    bad = []
    for path in _sources():
        with open(path) as f:
            text = f.read()
        tree = ast.parse(text, path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in ("optax", "orbax")]
        if "ROADMAP A15" in text:
            bad.append((os.path.relpath(path, ROOT), "ROADMAP A15"))
    assert not bad, bad
    jax_names = [n for n in dir(jpar) if not n.startswith("_")
                 and callable(getattr(jpar, n))]
    for name in ("make_pipe_mesh", "pipeline_apply", "stack_stage_params",
                 "make_expert_mesh", "moe_apply", "make_seq_mesh",
                 "ring_attention", "make_mesh", "volume_sharding",
                 "param_sharding", "replicated", "halo_exchange",
                 "crop_halo", "sharded_stencil"):
        assert name in jax_names, name
        assert callable(getattr(ppar, name)), name
    missing = [n for n in jax_names if not hasattr(ppar, n)]
    assert not missing, missing


def test_orbax_reader_modules_are_held_to_the_rule():
    """The OCDBT reader and the orbax layout are among the modules the
    import checks walk; importing them (and the checkpoint module that
    dispatches to them) loads neither jax, the JAX package, orbax,
    tensorstore, optax, ml_dtypes nor zstandard; no source of the port
    imports ml_dtypes, zstandard or a CRC-32C library; and the port's
    lint forbids orbax, ml_dtypes and zstandard."""
    from cluster_tools_tpu_torch.analysis import boundary

    mods = set(_port_modules())
    for name in ("core.ocdbt", "models.orbax", "models.checkpoint",
                 "core.storage"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    code = ("import sys\n"
            "import cluster_tools_tpu_torch.core.ocdbt\n"
            "import cluster_tools_tpu_torch.models.orbax\n"
            "import cluster_tools_tpu_torch.models.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cluster_tools_tpu', 'flax', 'optax', "
            "'orbax', 'tensorstore', 'ml_dtypes', 'zstandard', "
            "'google_crc32c', 'crc32c')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    libs = {"ml_dtypes", "zstandard", "google_crc32c", "crc32c", "orbax"}
    bad = [(os.path.relpath(p, ROOT), sorted(_imports(p)[1] & libs))
           for p in _sources() if _imports(p)[1] & libs]
    assert not bad, bad
    assert {"orbax", "ml_dtypes", "zstandard", "tensorstore",
            "optax"} <= boundary.FORBIDDEN


FIXTURE_GENERATOR = os.path.join(ROOT, "tests", "data", "torch_formats",
                                 "make_fixtures.py")


def _imports(path):
    """(module-level, anywhere) top-level names of a file's imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top, anywhere = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        anywhere.update(n.split(".")[0] for n in names)
        if node in tree.body:
            top.update(n.split(".")[0] for n in names)
    return top, anywhere


def test_formats_modules_are_held_to_the_rule():
    """The codecs and the ``libver="latest"`` HDF5 structures are among
    the modules the import checks walk, and no source of the port (or a
    script for the card) imports a compression or HDF5 library: the
    Zstandard, Snappy, LZF and bitshuffle decoders and the lookup3
    checksum are the port's own."""
    mods = set(_port_modules())
    for name in ("core.codecs", "core.hdf5_v2", "core.blosc", "core.hdf5",
                 "native"):
        assert f"cluster_tools_tpu_torch.{name}" in mods, name
    libs = {"zstandard", "zstd", "pyzstd", "snappy", "blosc", "blosc2",
            "numcodecs", "lz4", "lzf", "hdf5plugin", "h5py", "tensorstore",
            "bitshuffle", "zarr"}
    bad = [(os.path.relpath(p, ROOT), sorted(_imports(p)[1] & libs))
           for p in _sources() if _imports(p)[1] & libs]
    assert not bad, bad


def test_fixture_generator_is_numpy_only():
    """``make_fixtures.py``'s arrays are regenerated on the card's
    machine (``chip_smoke.py`` phase 16e): at module level it imports the
    standard library and numpy only, nothing of JAX or the JAX package
    anywhere, and tensorstore and h5py only inside its writers."""
    top, anywhere = _imports(FIXTURE_GENERATOR)
    assert top <= {"__future__", "json", "os", "shutil", "typing",
                   "numpy"}, top
    assert not anywhere & {"jax", "jaxlib", "cluster_tools_tpu", "flax",
                           "torch"}, anywhere
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('make_fixtures', "
        f"{FIXTURE_GENERATOR!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "for name in mod.ARRAYS:\n"
        "    mod.expected(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cluster_tools_tpu', 'h5py', 'tensorstore', "
        "'torch'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok", res.stdout
