"""U-Net inference of the port against the JAX package, on the CPU.

* checkpoints: a checkpoint the JAX package saves loads into the port
  with identical arrays, and one the port saves loads into the JAX
  package with identical arrays;
* the U-Net in float32 (``UNet3D(dtype=jnp.float32)`` against the port's
  ``dtype=torch.float32``) from the same parameters, carried over by
  ``flax_params_to_state_dict``: within atol 2e-5 of flax on sigmoid
  outputs (measured 1.5e-6: float32 convolutions and GroupNorm statistics
  summed in other orders).  This pins the convolution layout, the
  transposed convolution's taps, GroupNorm and GELU: a wrong tap order
  or layout moves outputs by ~1e-1;
* the default bfloat16 U-Net: within atol 2e-2, mean 3e-3 (measured up
  to 9e-3 / 1.3e-3 through the predictor: bfloat16 rounds at the same
  places, after sums in other orders);
* ``make_predictor`` (standardize and normalize, an outer shape that needs
  the reflect pad, one and two input channels) within the bfloat16
  tolerance;
* ``InferenceTask`` against the JAX package's on the same store: channel
  mapping, mask skip, uint8 requantization within 6 steps (the bfloat16
  tolerance times 255, rounded up), ``framework="pytorch"`` with
  ``tta="mirror"`` in float32 within 1e-6;
* the chain ``InferenceTask`` -> ``MwsWorkflow`` on the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cluster_tools_tpu.models import checkpoint as jckpt  # noqa: E402
from cluster_tools_tpu.models.unet import UNet3D as JUNet3D  # noqa: E402
from cluster_tools_tpu.models.unet import create_unet as jcreate  # noqa: E402
from cluster_tools_tpu_torch.models import checkpoint as pckpt  # noqa: E402

#: (name, model.json, input channels)
MODELS = [
    ("aniso", {"out_channels": 3, "features": [4, 8, 16],
               "anisotropic": True}, 1),
    ("iso", {"out_channels": 2, "features": [8, 16], "anisotropic": False},
     2),
]
F32_ATOL = 2e-5
BF16_ATOL, BF16_MEAN = 2e-2, 3e-3
U8_STEPS = 6


def _jax_params(cfg, in_channels, seed):
    """Random flax parameters of the model's shapes (GroupNorm scales and
    all biases away from flax's init values 1 and 0, which would hide a
    wrong mapping)."""
    model = jcreate(**{**cfg, "features": tuple(cfg["features"])})
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            np.zeros((1, 4, 8, 8, in_channels), "float32"))
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:  # fan-in scaled, as flax's init
            scale = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            return (scale * rng.randn(*a.shape)).astype("float32")
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.randn(*a.shape)).astype("float32")

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (JAX-saved checkpoint path, model.json, in channels, flax
    params)."""
    out = {}
    for i, (name, cfg, cin) in enumerate(MODELS):
        path = str(tmp_path_factory.mktemp("ckpt") / name)
        params = _jax_params(cfg, cin, i)
        jckpt.save_checkpoint(path, cfg, params)
        out[name] = (path, cfg, cin, params)
    return out


def _flax_float32(cfg):
    m = jcreate(**{**cfg, "features": tuple(cfg["features"])})
    return JUNet3D(out_channels=m.out_channels, features=m.features,
                   scale_factors=m.scale_factors, dtype=jnp.float32)


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_checkpoint_jax_to_port(checkpoints, name):
    path, cfg, cin, params = checkpoints[name]
    model, sd = pckpt.load_checkpoint(path)
    flat = jckpt._flatten(params)
    back = pckpt.state_dict_to_flax_params(sd)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], flat[k])
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k])
    assert model.encoders[0].convs[0].in_channels == cin
    assert model.dtype == torch.bfloat16
    assert model.min_divisor() == jcreate(
        **{**cfg, "features": tuple(cfg["features"])}).min_divisor()


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_checkpoint_port_to_jax(checkpoints, tmp_path, name):
    path, cfg, _, params = checkpoints[name]
    _, sd = pckpt.load_checkpoint(path)
    out = str(tmp_path / "port_saved")
    pckpt.save_checkpoint(out, cfg, sd)
    model, loaded = jckpt.load_checkpoint(out)
    assert model.features == tuple(cfg["features"])
    want, got = jckpt._flatten(params), jckpt._flatten(loaded)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _compare_forward(checkpoints, name, jdtype, tdtype, shape):
    path, cfg, cin, params = checkpoints[name]
    x = np.random.RandomState(3).randn(1, *shape, cin).astype("float32")
    jmodel = (_flax_float32(cfg) if jdtype == jnp.float32 else
              jcreate(**{**cfg, "features": tuple(cfg["features"])}))
    want = np.asarray(jmodel.apply(params, x), dtype="float32")
    model, _ = pckpt.load_checkpoint(path, dtype=tdtype)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.float32
    return np.abs(got.permute(0, 2, 3, 4, 1).numpy() - want)


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_unet_float32_matches_flax(checkpoints, name):
    err = _compare_forward(checkpoints, name, jnp.float32, torch.float32,
                           (8, 24, 16))
    assert err.max() < F32_ATOL, err.max()


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_unet_bfloat16_matches_flax(checkpoints, name):
    err = _compare_forward(checkpoints, name, jnp.bfloat16, torch.bfloat16,
                           (8, 24, 16))
    assert err.max() < BF16_ATOL and err.mean() < BF16_MEAN, \
        (err.max(), err.mean())


def test_float32_forward_leaves_tf32_flags_alone(checkpoints):
    path = checkpoints["aniso"][0]
    model, _ = pckpt.load_checkpoint(path, dtype=torch.float32)
    before = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        model(torch.zeros((1, 1, 4, 8, 8)))
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.parametrize("preprocess", ["standardize", "normalize"])
@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_make_predictor_matches_jax(checkpoints, name, preprocess):
    from cluster_tools_tpu.workflows.inference import make_predictor as jmp
    from cluster_tools_tpu_torch.workflows.inference import make_predictor

    path, _, cin, _ = checkpoints[name]
    outer, halo = (11, 18, 22), (1, 2, 3)  # padded up to the divisor
    raw = (np.random.RandomState(4).rand(cin, *outer) * 255).astype("uint8")
    block = raw[0] if cin == 1 else raw
    want = jmp(path, outer, halo, preprocess)(block)
    got = make_predictor(path, outer, halo, preprocess, device="cpu")(block)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() < BF16_ATOL and err.mean() < BF16_MEAN, \
        (err.max(), err.mean())


def test_predict_sharded_and_train_state_raise(checkpoints, tmp_path):
    """``predict_sharded`` runs (it raised before the port had the mesh):
    two shards on the CPU give the per-block predictor's forwards, bit
    for bit.  The training-state checkpoints raised until the port had
    training (A15): a sharded state (8 shards, (2, 2, 2)) saved after one
    step restores bitwise onto its placements, with its step and count,
    and the next step from either state gives the same loss and the same
    parameters."""
    from cluster_tools_tpu_torch.models import train as ptrain
    from cluster_tools_tpu_torch.parallel.mesh import shard_devices
    from cluster_tools_tpu_torch.workflows.inference import (make_predictor,
                                                             predict_sharded)

    path = checkpoints["aniso"][0]
    raw = np.random.RandomState(2).rand(3, 8, 16, 16).astype("float32")
    got = predict_sharded(path, raw, devices=shard_devices("cpu", 2))
    assert got.shape == (3, 3, 8, 16, 16) and got.dtype == np.float32
    pred = make_predictor(path, (8, 16, 16), (0, 0, 0), device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(got[i], pred(raw[i]))

    step, state, (x, y) = ptrain.train_step_for_mesh(
        n_devices=8, features=(4, 8), shape=(2, 8, 16, 16), device="cpu")
    state1, _ = step(state, x, y)
    ckpt = str(tmp_path / "train_ckpt")
    pckpt.save_train_state(ckpt, state1)
    restored = pckpt.restore_train_state(ckpt, state)
    assert restored.step == state1.step == 1
    assert restored.opt_state.count == state1.opt_state.count == 1
    assert restored.mesh is state.mesh
    for k, pl in state1.placements.items():
        assert restored.placements[k] == pl
    for a, b in ((state1.params, restored.params),
                 (state1.opt_state.mu, restored.opt_state.mu),
                 (state1.opt_state.nu, restored.opt_state.nu)):
        for k in a:
            assert len(a[k]) == len(b[k]) == 8
            for sa, sb in zip(a[k], b[k]):
                assert torch.equal(sa, sb), k
    s_a, loss_a = step(state1, x, y)
    s_b, loss_b = step(restored, x, y)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-6)
    for k in s_a.params:
        assert all(torch.equal(u, v) for u, v in zip(s_a.params[k],
                                                     s_b.params[k])), k
    # an unsharded state restores onto an unsharded layout
    whole = ptrain.unplace_state(state1)
    pckpt.save_train_state(str(tmp_path / "whole"), whole)
    back = pckpt.restore_train_state(str(tmp_path / "whole"), whole)
    assert not back.sharded and back.step == 1
    assert all(torch.equal(v, back.params[k])
               for k, v in whole.params.items())


def test_jax_train_state_carries_across_and_back():
    """A JAX ``TrainState`` (flax params, optax adamw state after one
    update, step) taken to the port and back equals itself leaf by leaf;
    in the port, the moments carry the kernels' transposes and flips as
    the parameters do."""
    import optax

    from cluster_tools_tpu.models import train as jtrain

    params = _jax_params(MODELS[0][1], 1, 5)
    rng = np.random.RandomState(6)
    grads = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype("float32"), params)
    opt = jtrain.make_optimizer(1e-3)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    state = jtrain.TrainState(params, opt_state, jnp.asarray(1, jnp.int32))
    leaves = jax.tree_util.tree_map(np.asarray, state)

    port = pckpt.train_state_from_flax(leaves, device="cpu")
    assert port.step == 1 and port.opt_state.count == 1
    sd = pckpt.flax_params_to_state_dict(leaves.params)
    mu = pckpt.flax_params_to_state_dict(leaves.opt_state[0].mu)
    for k in sd:
        assert torch.equal(port.params[k], sd[k])
        assert torch.equal(port.opt_state.mu[k], mu[k])
    back = pckpt.train_state_to_flax(port)
    for want, got in ((leaves.params, back.params),
                      (leaves.opt_state[0].mu, back.opt_state[0].mu),
                      (leaves.opt_state[0].nu, back.opt_state[0].nu)):
        want, got = pckpt._flatten(want), pckpt._flatten(got)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(back.opt_state[0].count) == int(leaves.opt_state[0].count)
    assert int(back.step) == int(leaves.step)


# ---------------------------------------------------------------------------
# the task
# ---------------------------------------------------------------------------

SHAPE = (12, 40, 36)
BLOCK = [8, 16, 16]
HALO = [2, 4, 4]


def _store(root, raw, mask=None):
    from cluster_tools_tpu_torch.core.storage import file_reader

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "d.n5")
    with file_reader(path) as f:
        f.require_dataset("raw", shape=raw.shape,
                          chunks=list(raw.shape[:-3]) + BLOCK,
                          dtype=raw.dtype)[:] = raw
        if mask is not None:
            f.require_dataset("mask", shape=mask.shape, chunks=BLOCK,
                              dtype=mask.dtype)[:] = mask
    return path


def _run_task(pkg, root, raw, ckpt, output_key, mask=None, task_cfg=None):
    if pkg == "jax":
        import cluster_tools_tpu as M
        from cluster_tools_tpu.core.config import ConfigDir
        from cluster_tools_tpu.workflows.inference import InferenceTask
        target, extra = "tpu", {}
    else:
        import cluster_tools_tpu_torch as M
        from cluster_tools_tpu_torch.core.config import ConfigDir
        InferenceTask = M.InferenceTask
        target, extra = "gpu", {"device": "cpu"}
    path = _store(root, raw, mask)
    cfg = os.path.join(root, "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": BLOCK, **extra})
    ConfigDir(cfg).write_task_config("inference", task_cfg or {})
    task = InferenceTask(
        input_path=path, input_key="raw", output_path=path,
        output_key=output_key, checkpoint_path=ckpt, halo=HALO,
        mask_path=path if mask is not None else "",
        mask_key="mask" if mask is not None else "",
        tmp_folder=os.path.join(root, "tmp"), config_dir=cfg, max_jobs=2,
        target=target)
    assert M.build([task], raise_on_failure=True)
    with M.file_reader(path, "r") as f:
        return {k: f[k][:] for k in output_key}


def test_inference_task_matches_jax(checkpoints, tmp_path):
    """Channel mapping, mask skip and uint8 requantization."""
    path = checkpoints["aniso"][0]
    raw = (np.random.RandomState(5).rand(*SHAPE) * 255).astype("uint8")
    mask = np.zeros(SHAPE, "uint8")
    mask[:8, :16] = 1  # blocks outside it are skipped
    out_key = {"affs": [0, 3], "ch1": [1, 2]}
    jx = _run_task("jax", str(tmp_path / "jax"), raw, path, out_key, mask)
    pt = _run_task("torch", str(tmp_path / "torch"), raw, path, out_key,
                   mask)
    assert pt["affs"].shape == (3,) + SHAPE and pt["ch1"].shape == SHAPE
    for k in out_key:
        assert pt[k].dtype == jx[k].dtype == np.uint8
        steps = np.abs(pt[k].astype(int) - jx[k].astype(int))
        assert steps.max() <= U8_STEPS, steps.max()
    np.testing.assert_array_equal(pt["ch1"], pt["affs"][1])
    # skipped blocks stay empty, the others are written
    skipped = np.ones(SHAPE, bool)
    skipped[:8, :16] = False
    assert (pt["affs"][:, skipped] == 0).all()
    assert (jx["affs"][:, skipped] == 0).all()
    assert pt["affs"][:, :8, :16].any()


def test_inference_task_float32_multichannel_input(checkpoints, tmp_path):
    """A (C, Z, Y, X) input with the channel range of the task config and
    float32 output."""
    path = checkpoints["iso"][0]
    raw = np.random.RandomState(6).rand(3, *SHAPE).astype("float32")
    cfg = {"dtype": "float32", "channel_begin": 1, "channel_end": 3,
           "preprocess": "normalize"}
    jx = _run_task("jax", str(tmp_path / "jax"), raw, path,
                   {"p": [0, 2]}, task_cfg=cfg)
    pt = _run_task("torch", str(tmp_path / "torch"), raw, path,
                   {"p": [0, 2]}, task_cfg=cfg)
    err = np.abs(pt["p"] - jx["p"])
    assert pt["p"].dtype == np.float32
    assert err.max() < BF16_ATOL and err.mean() < BF16_MEAN, \
        (err.max(), err.mean())


def test_pytorch_framework_with_tta_matches_jax(tmp_path):
    """``framework="pytorch"`` (a torch.load-able module) with mirror
    test-time augmentation: both packages run the same float32 module on
    the CPU."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv3d(1, 2, 3, padding=1),
                                torch.nn.Sigmoid())
    ckpt = str(tmp_path / "model.pt")
    torch.save(model, ckpt)
    raw = (np.random.RandomState(7).rand(*SHAPE) * 255).astype("uint8")
    cfg = {"framework": "pytorch", "tta": "mirror", "dtype": "float32"}
    jx = _run_task("jax", str(tmp_path / "jax"), raw, ckpt, {"p": [0, 2]},
                   task_cfg=cfg)
    pt = _run_task("torch", str(tmp_path / "torch"), raw, ckpt,
                   {"p": [0, 2]}, task_cfg=cfg)
    np.testing.assert_allclose(pt["p"], jx["p"], rtol=0, atol=1e-6)


def test_wrap_tta_and_unknown_framework():
    from cluster_tools_tpu_torch.models.frameworks import (get_predictor,
                                                           wrap_tta)

    def shifted(block):
        out = np.zeros_like(block)
        out[1:] = block[:-1]
        return out[None].astype("float32")

    x = np.random.RandomState(0).rand(6, 8, 8).astype("float32")
    acc = np.zeros_like(x, dtype="float64")
    for fz in (False, True):
        for fy in (False, True):
            for fx in (False, True):
                axes = tuple(a for a, f in enumerate((fz, fy, fx)) if f)
                xb = np.flip(x, axes) if axes else x
                y = shifted(xb)[0]
                acc += np.flip(y, axes) if axes else y
    np.testing.assert_allclose(wrap_tta(shifted, "mirror")(x)[0], acc / 8,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        wrap_tta(shifted, "rotate")
    with pytest.raises(KeyError):
        get_predictor("tensorflow", "x", (8, 8, 8), (0, 0, 0), device="cpu")


def test_inference_to_mws_chain(checkpoints, tmp_path):
    """BASELINE config 5 on the port: the U-Net's affinities feed the
    mutex watershed over the same offsets."""
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu_torch.core.config import ConfigDir

    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    path, cfg, cin, _ = checkpoints["aniso"]
    assert cfg["out_channels"] == len(offsets) and cin == 1
    raw = (np.random.RandomState(8).rand(*SHAPE) * 255).astype("uint8")
    store = _store(str(tmp_path), raw)
    cfg_dir = str(tmp_path / "cfg")
    ConfigDir(cfg_dir).write_global_config({"block_shape": BLOCK,
                                            "device": "cpu"})
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=cfg_dir,
                  max_jobs=2)
    inf = ctp.InferenceTask(input_path=store, input_key="raw",
                            output_path=store, output_key={"affs": [0, 3]},
                            checkpoint_path=path, halo=HALO, **common)
    mws = ctp.MwsWorkflow(input_path=store, input_key="affs",
                          output_path=store, output_key="seg",
                          offsets=offsets, dependency=inf, **common)
    assert ctp.build([mws], raise_on_failure=True)
    with ctp.file_reader(store, "r") as f:
        affs, seg = f["affs"][:], f["seg"][:]
    assert affs.dtype == np.uint8 and affs.any()
    assert seg.shape == SHAPE and seg.dtype == np.uint64
    u = np.unique(seg)
    assert u[0] == 1 and u[-1] == len(u)  # every voxel labeled, consecutive
