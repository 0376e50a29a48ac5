"""``ThresholdedComponentsWorkflow`` of the port against the JAX package's,
on the CPU, on one store.

Both write the same uint64 labels and ``maxId`` on every path: the
per-block path (targets ``inline`` and ``threads``, and ``gpu`` with a
mask), and the resident path (``CTT_FORCE_RESIDENT=1`` on both sides:
port target ``"gpu"`` on device ``"cpu"``, JAX target ``"tpu"`` on the CPU
backend) with the run-length download and with the dense download (a
tiny ``rle_cap``); the partition equals ``scipy.ndimage.label``'s.  An
empty volume and one component spanning every block too.
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

torch.set_num_threads(2)

SHAPE = (25, 30, 30)  # clipped border blocks included
BLOCK = [10, 10, 10]


def _volume(seed=3, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return ndimage.uniform_filter(rng.rand(*shape).astype("float32"), size=3)


def _mask(shape=SHAPE):
    m = np.ones(shape, "uint8")
    m[:, :, :7] = 0
    m[12:, 15:, 18:] = 0
    return m


def _run(pkg, root, path, key, target, mask_key="", task_cfg=None,
         threshold=0.5, mode="greater", input_key="raw"):
    """Run the workflow of ``pkg`` on ``path:input_key``, writing ``key``;
    returns (labels, maxId)."""
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows.fused_pipeline import clear_caches
        from cluster_tools_tpu.workflows.thresholded_components import \
            ThresholdedComponentsWorkflow as Wf
        extra = {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        from cluster_tools_tpu_torch.workflows.fused_pipeline import \
            clear_caches
        Wf = M.ThresholdedComponentsWorkflow
        extra = {"device": "cpu"}
    clear_caches()
    cfg = os.path.join(root, f"cfg_{pkg}_{key}")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK,
                                        "max_num_retries": 0, **extra})
    ConfigDir(cfg).write_task_config("block_components", task_cfg or {})
    wf = Wf(input_path=path, input_key=input_key, output_path=path,
            output_key=key, threshold=threshold, threshold_mode=mode,
            tmp_folder=os.path.join(root, f"tmp_{pkg}_{key}"),
            config_dir=cfg, max_jobs=2, target=target,
            mask_path=path if mask_key else "", mask_key=mask_key)
    assert M.build([wf], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return f[key][:], int(f[key].attrs["maxId"])


def _store(tmp_path, vol, mask=None):
    """The input (and the mask, and the input zeroed outside the mask)
    in one store."""
    from cluster_tools_tpu_torch.core.storage import file_reader

    path = str(tmp_path / "data.n5")
    with file_reader(path) as f:
        f.require_dataset("raw", shape=vol.shape, chunks=BLOCK,
                          dtype=vol.dtype)[:] = vol
        if mask is not None:
            f.require_dataset("mask", shape=mask.shape, chunks=BLOCK,
                              dtype=mask.dtype)[:] = mask
            f.require_dataset("raw_masked", shape=vol.shape, chunks=BLOCK,
                              dtype=vol.dtype)[:] = np.where(mask > 0, vol,
                                                             0)
    return path


def _same_partition(a, b):
    if not ((a == 0) == (b == 0)).all():
        return False
    fg = a != 0
    pairs = np.unique(np.stack([a[fg], b[fg]]), axis=1)
    return (len(np.unique(pairs[0])) == pairs.shape[1]
            and len(np.unique(pairs[1])) == pairs.shape[1])


def _check(pt, jx, fg):
    (lab, mx), (jlab, jmx) = pt, jx
    assert lab.dtype == jlab.dtype == np.uint64
    np.testing.assert_array_equal(lab, jlab)
    ref, n = ndimage.label(fg)
    assert mx == jmx == n == lab.max()
    assert _same_partition(lab, ref)


CASES = {
    # name: (port target, JAX target, resident, mask, task config)
    "inline": ("inline", "inline", False, False, None),
    "threads": ("threads", "inline", False, False, None),
    "masked": ("gpu", "inline", False, True, None),
    "masked_threads": ("threads", "inline", False, True, None),
    "resident_rle": ("gpu", "tpu", True, False, None),
    "resident_dense": ("gpu", "tpu", True, False, {"rle_cap": 4}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_workflow_matches_jax(tmp_path, monkeypatch, case):
    p_target, j_target, resident, masked, task_cfg = CASES[case]
    vol = _volume()
    mask = _mask() if masked else None
    path = _store(tmp_path, vol, mask)
    if resident:
        monkeypatch.setenv("CTT_FORCE_RESIDENT", "1")
    # the JAX package's BlockComponents cannot take a mask (it writes into
    # a read-only np.asarray of a jax array): it runs on the input zeroed
    # outside the mask, which the threshold 0.5 maps to background
    jx = _run("jax", str(tmp_path), path, "cc_jax", j_target,
              task_cfg=task_cfg,
              input_key="raw_masked" if masked else "raw")
    pt = _run("torch", str(tmp_path), path, "cc_torch", p_target,
              "mask" if masked else "", task_cfg)
    fg = vol > 0.5
    if masked:
        fg &= mask > 0
    _check(pt, jx, fg)
    tmp = str(tmp_path / "tmp_torch_cc_torch")
    # the resident pass folds the offsets into its one job
    assert os.path.exists(os.path.join(tmp, "merge_offsets.status")) \
        != resident


@pytest.mark.parametrize("mode,threshold", [("less", 0.45),
                                            ("equal", 0.0)])
def test_threshold_modes_resident_match_jax(tmp_path, monkeypatch, mode,
                                            threshold):
    """Modes under which the zero padding of border blocks would be
    foreground: the extent mask keeps it out on both sides."""
    vol = np.round(_volume(5), 1)
    path = _store(tmp_path, vol)
    monkeypatch.setenv("CTT_FORCE_RESIDENT", "1")
    jx = _run("jax", str(tmp_path), path, "cc_jax", "tpu",
              threshold=threshold, mode=mode)
    pt = _run("torch", str(tmp_path), path, "cc_torch", "gpu",
              threshold=threshold, mode=mode)
    fg = vol < threshold if mode == "less" else vol == threshold
    _check(pt, jx, fg)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["per_block", "resident"])
@pytest.mark.parametrize("kind", ["empty", "cross"])
def test_empty_and_spanning_volumes(tmp_path, monkeypatch, kind, resident):
    shape = (20, 20, 20)
    vol = np.zeros(shape, "float32")
    if kind == "cross":  # one component crossing every block on all axes
        vol[10, :, :] = vol[:, 10, :] = vol[:, :, 10] = 1.0
    path = _store(tmp_path, vol)
    if resident:
        monkeypatch.setenv("CTT_FORCE_RESIDENT", "1")
    jx = _run("jax", str(tmp_path), path, "cc_jax",
              "tpu" if resident else "inline")
    pt = _run("torch", str(tmp_path), path, "cc_torch",
              "gpu" if resident else "inline")
    _check(pt, jx, vol > 0.5)
    if kind == "cross":
        assert (pt[0][vol > 0.5] == 1).all()


def test_resident_cache_miss_reads_the_store(tmp_path, monkeypatch):
    """BlockFaces and the final write compose from the fragment cache
    when this process staged it, and read the store otherwise (another
    process): both give the same labels."""
    from cluster_tools_tpu_torch.workflows import fused_pipeline

    vol = _volume(4)
    path = _store(tmp_path, vol)
    monkeypatch.setenv("CTT_FORCE_RESIDENT", "1")
    want = _run("torch", str(tmp_path), path, "cc_a", "gpu")
    monkeypatch.setattr(fused_pipeline, "fragment_cache_get",
                        lambda *a, **k: None)
    got = _run("torch", str(tmp_path), path, "cc_b", "gpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    _check(got, want, vol > 0.5)


def test_mesh_and_missing_card_raise(tmp_path):
    """``target="mesh"`` runs the mesh phase (MeshBlockComponents, 4
    shards on the CPU) and writes the ``gpu`` run's labels; without a
    card the default device raises at the build."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.workflows.mesh_blockwise import \
        MeshBlockComponents

    vol = _volume()
    path = _store(tmp_path, vol)
    cpu_cfg = str(tmp_path / "cpu_cfg")
    ConfigDir(cpu_cfg).write_global_config({
        "block_shape": BLOCK, "device": "cpu", "mesh_devices": 4})
    labels = {}
    for target in ("mesh", "gpu"):
        wf = ctp.ThresholdedComponentsWorkflow(
            input_path=path, input_key="raw", output_path=path,
            output_key=f"cc_{target}", threshold=0.5,
            tmp_folder=str(tmp_path / f"tmp_{target}"), config_dir=cpu_cfg,
            target=target)
        if target == "mesh":
            assert isinstance(wf.requires().dependency.dependency
                              .dependency, MeshBlockComponents)
        assert ctp.build([wf], raise_on_failure=True)
        with ctp.file_reader(path, "r") as f:
            labels[target] = f[f"cc_{target}"][:]
    np.testing.assert_array_equal(labels["mesh"], labels["gpu"])
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK})
    kw = dict(input_path=path, input_key="raw", output_path=path,
              output_key="cc", threshold=0.5,
              tmp_folder=str(tmp_path / "tmp"), config_dir=cfg)
    wf = ctp.ThresholdedComponentsWorkflow(**kw)
    assert wf.target == "gpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctp.build([wf])
        with ctp.file_reader(path, "r") as f:
            assert "cc" not in f
