"""Training of the port (``models/train.py``) against the JAX package's
``models/train.py`` on the CPU.

The same inputs, made from a numpy seed, go through both packages; the
U-Net's parameters are carried across (``flax_params_to_state_dict``):

* ``affinity_loss`` with and without a mask, and its gradient at the
  clip's ties: rtol 1e-6;
* the loss and every gradient of a float32 U-Net (features (4, 8)) against
  ``jax.value_and_grad``: rtol 1e-4 / atol 1e-7; the bfloat16 U-Net's loss
  at rtol 2e-2;
* the AdamW update from JAX's own gradients and optax state against
  ``optax.adamw`` for steps 1 and 2: 1e-7 absolute;
* ``shard_train_step`` on an 8-shard CPU mesh (2, 2, 2) against the
  unsharded step (loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-7; the
  parameters after one step within the AdamW gate below) and against the
  JAX package's sharded step;
* the torch-layout model split: a model-split convolution gathered back
  equals the whole one, and no GroupNorm group straddles a split;
* ``train_step_for_mesh`` learns; ``init_state`` draws flax's
  distributions.

The AdamW gate: a first Adam step moves every element by about
``lr * sign(g)``, so two gradients that differ in their last bits move a
parameter identically wherever ``|g|`` is well above their difference,
and by up to ``2 * lr`` where the true gradient is zero (a bias before a
GroupNorm of one channel per group) and rounding picks the sign.  The
parameters after one step must agree within 1e-7 where ``|g| > 1e-6``
and within ``2 * lr`` everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cluster_tools_tpu.models import train as jtrain  # noqa: E402
from cluster_tools_tpu.models.unet import UNet3D as JUNet3D  # noqa: E402
from cluster_tools_tpu_torch.models import checkpoint as pckpt  # noqa: E402
from cluster_tools_tpu_torch.models import train as ptrain  # noqa: E402
from cluster_tools_tpu_torch.models.unet import UNet3D  # noqa: E402
from cluster_tools_tpu_torch.parallel import mesh as pmesh  # noqa: E402

FEATURES = (4, 8)
SCALES = ((2, 2, 2),)
SHAPE = (2, 8, 16, 16)          # B, D, H, W
N_OUT = 3
LR = 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
UPDATE_ATOL = 1e-7


def _jax_model(dtype=jnp.float32):
    return JUNet3D(out_channels=N_OUT, features=FEATURES,
                   scale_factors=SCALES, dtype=dtype)


def _port_model(dtype=torch.float32):
    return UNet3D(in_channels=1, out_channels=N_OUT, features=FEATURES,
                  scale_factors=SCALES, dtype=dtype)


def _flax_params(seed=0):
    """Random flax parameters of the model's shapes (GroupNorm scales and
    biases away from flax's init values, which would hide a wrong
    mapping)."""
    shapes = jax.eval_shape(_jax_model().init, jax.random.PRNGKey(0),
                            np.zeros((1,) + SHAPE[1:] + (1,), "float32"))
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            scale = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            return (scale * rng.randn(*a.shape)).astype("float32")
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.randn(*a.shape)).astype("float32")

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(seed=0):
    """x (B, D, H, W, 1) and binary targets (B, D, H, W, 3), channels
    last (the JAX package's layout)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*SHAPE, 1).astype("float32")
    y = (rng.rand(*SHAPE, N_OUT) > 0.5).astype("float32")
    return x, y


def _cf(a):
    """Channels last -> channels first, as a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _flat(tree):
    return pckpt._flatten(tree)


@pytest.fixture(scope="module")
def jax_grads():
    """params, x, y and JAX's loss and gradients (float32 U-Net)."""
    params = _flax_params()
    x, y = _batch()
    model = _jax_model()

    def loss_fn(p):
        return jtrain.affinity_loss(model.apply(p, x), y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return params, x, y, float(loss), grads


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_affinity_loss_matches_jax(masked):
    rng = np.random.RandomState(3)
    pred = rng.rand(2, 3, 4, 8, 8).astype("float32")
    # exact clip ties, saturated values and zeros
    pred.reshape(-1)[:4] = [1e-6, 1.0 - 1e-6, 1.0, 0.0]
    pred = pred.astype("float32")
    target = (rng.rand(*pred.shape) > 0.5).astype("float32")
    mask = (rng.rand(*pred.shape) > 0.3).astype("float32") if masked \
        else None

    def jloss(p):
        return jtrain.affinity_loss(p, target, mask)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = ptrain.affinity_loss(p, torch.from_numpy(target),
                               None if mask is None
                               else torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_jax(jax_grads):
    params, x, y, want_loss, want = jax_grads
    sd = pckpt.flax_params_to_state_dict(params)
    loss, grads = ptrain.loss_and_grads(_port_model(), sd, _cf(x), _cf(y))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    got = pckpt.state_dict_to_flax_params(grads)
    want = _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_bfloat16_loss_matches_jax():
    params = _flax_params(1)
    x, y = _batch(1)
    want = float(jtrain.affinity_loss(
        _jax_model(jnp.bfloat16).apply(params, x), y))
    sd = pckpt.flax_params_to_state_dict(params)
    loss, grads = ptrain.loss_and_grads(_port_model(torch.bfloat16), sd,
                                        _cf(x), _cf(y))
    np.testing.assert_allclose(float(loss), want, rtol=2e-2)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_update_matches_optax(jax_grads):
    """Steps 1 and 2 of ``optax.adamw`` (the JAX package's optimizer)
    from JAX's gradients (the second step's scaled and shifted), the
    port's :class:`AdamW` on the same gradients and state."""
    params, _, _, _, grads = jax_grads
    opt = jtrain.make_optimizer(LR)
    jstate = opt.init(params)
    port = ptrain.make_optimizer(LR)
    sd = pckpt.flax_params_to_state_dict(params)
    pstate = port.init(sd)
    jparams = params
    for step, (a, b) in enumerate([(1.0, 0.0), (0.5, 1e-3)]):
        g = jax.tree_util.tree_map(lambda t: (a * t + b).astype("float32"),
                                   grads)
        jup, jstate = opt.update(g, jstate, jparams)
        pup, pstate = port.update(pckpt.flax_params_to_state_dict(g),
                                  pstate, sd)
        got, want = pckpt.state_dict_to_flax_params(pup), _flat(
            jax.tree_util.tree_map(np.asarray, jup))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=UPDATE_ATOL,
                                       err_msg=f"step {step + 1} {k}")
        assert pstate.count == int(jstate[0].count) == step + 1
        # the state carried forward: the JAX package's own parameters
        import optax

        jparams = optax.apply_updates(jparams, jup)
        sd = pckpt.flax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jparams))
    mu = pckpt.state_dict_to_flax_params(pstate.mu)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                             jstate[0].mu)).items():
        np.testing.assert_allclose(mu[k], v, rtol=1e-6, atol=1e-10)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _mesh8():
    return pmesh.make_mesh(devices=pmesh.shard_devices("cpu", 8))


def _whole_grads(state, grads):
    """Master gradients of a sharded state joined into whole tensors."""
    out = {}
    for name, shards in state.params.items():
        pl = state.placements[name]
        owner = ptrain._masters(state.mesh, pl, shards[0].ndim)
        out[name] = pmesh.unshard([grads[(name, o)] for o in owner],
                                  state.mesh, pl)
    return out


def _adamw_gate(got, want, grads, lr=LR):
    for k in want:
        d = (got[k] - want[k]).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), (k, float(d.max()))
        big = grads[k].abs() > 1e-6
        if big.any():
            assert float(d[big].max()) <= 1e-7, (k, float(d[big].max()))


def test_sharded_step_matches_unsharded(jax_grads):
    params, x, y, _, _ = jax_grads
    model = _port_model()
    sd = pckpt.flax_params_to_state_dict(params)
    state = ptrain.TrainState(sd, ptrain.make_optimizer(LR).init(sd), 0)
    mesh = _mesh8()
    assert mesh.shape == {"data": 2, "space": 2, "model": 2}
    step, sstate, pl = ptrain.shard_train_step(model, state, mesh, lr=LR)
    assert pl.spec == ("data", None, "space")
    # the model axis really splits: every 3x3x3 conv's output channels
    split = [k for k, p in sstate.placements.items() if "model" in p.spec]
    assert "encoders.0.convs.0.weight" in split
    assert "upsamplers.0.weight" in split
    xs, ys = pmesh.shard(_cf(x), mesh, pl), pmesh.shard(_cf(y), mesh, pl)
    loss, grads = ptrain.loss_and_grads(model, sd, _cf(x), _cf(y))
    sloss, sgrads = ptrain.sharded_loss_and_grads(model, sstate, xs, ys)
    np.testing.assert_allclose(float(sloss), float(loss), rtol=1e-5)
    whole = _whole_grads(sstate, sgrads)
    for k in grads:
        np.testing.assert_allclose(whole[k].numpy(), grads[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    s1, l1 = step(sstate, xs, ys)
    u1, lu = ptrain.make_train_step(model, lr=LR)(state, _cf(x), _cf(y))
    np.testing.assert_allclose(float(l1), float(lu), rtol=1e-5)
    assert s1.step == u1.step == 1 and s1.opt_state.count == 1
    joined = ptrain.unplace_state(s1)
    _adamw_gate(joined.params, u1.params, grads)
    # replicated pieces stay equal on every shard
    for name, shards in s1.params.items():
        owner = ptrain._masters(mesh, s1.placements[name], shards[0].ndim)
        for p, o in enumerate(owner):
            assert torch.equal(shards[p], shards[o])
            assert shards[p].data_ptr() != shards[o].data_ptr() or p == o
    # the state the step was given is unchanged
    for k, shards in sstate.params.items():
        assert all(torch.equal(a, b) for a, b in zip(
            shards, pmesh.shard(sd[k], mesh, sstate.placements[k]))), k


#: the leaf whose gradient the JAX package's 8-device step halves
#: (ROADMAP C, faults of the reference)
JAX_HALVED = "params/ConvBlock_0/Conv_0/kernel"


@pytest.mark.mesh
def test_sharded_step_matches_jax(jax_grads):
    """The JAX package's ``shard_train_step`` on its 8-device mesh and the
    port's on 8 CPU shards, from the same parameters, batch and optax
    state: the loss, the first moment (0.1 x the gradient) and the
    parameters after one step.  One leaf differs, by the reference's
    fault: on the (2, 2, 2) mesh GSPMD's step halves the gradient of the
    first convolution's kernel (one input channel, its output channels
    split over ``model``) against the JAX package's own unsharded
    gradient; the port's equals the unsharded one there."""
    params, x, y, _, grads = jax_grads
    jmodel = _jax_model()
    from cluster_tools_tpu.parallel import mesh as jmesh

    opt = jtrain.make_optimizer(LR)
    jstate = jtrain.TrainState(params, opt.init(params),
                               jnp.zeros((), jnp.int32))
    jitted, jstate, x_shard = jtrain.shard_train_step(
        jmodel, jstate, jmesh.make_mesh(8), lr=LR)
    jstate1, jloss = jitted(jstate, jax.device_put(x, x_shard),
                            jax.device_put(y, x_shard))
    jstate1 = jax.tree_util.tree_map(np.asarray, jstate1)

    model = _port_model()
    sd = pckpt.flax_params_to_state_dict(params)
    state = ptrain.TrainState(sd, ptrain.make_optimizer(LR).init(sd), 0)
    step, sstate, _ = ptrain.shard_train_step(model, state, _mesh8(), LR)
    s1, loss = step(sstate, _cf(x), _cf(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = pckpt.train_state_to_flax(s1)
    assert int(got.step) == int(jstate1.step) == 1
    mu_want = _flat(jstate1.opt_state[0].mu)
    mu_got = _flat(got.opt_state[0].mu)
    unsharded = {k: 0.1 * v for k, v in _flat(grads).items()}
    for k in mu_want:
        want = unsharded[k] if k == JAX_HALVED else mu_want[k]
        np.testing.assert_allclose(mu_got[k], want, rtol=GRAD_RTOL,
                                   atol=0.1 * GRAD_ATOL, err_msg=k)
    np.testing.assert_allclose(mu_want[JAX_HALVED],
                               0.5 * unsharded[JAX_HALVED], rtol=GRAD_RTOL,
                               atol=0.1 * GRAD_ATOL)
    p_got = pckpt.flax_params_to_state_dict(got.params)
    p_want = pckpt.flax_params_to_state_dict(jstate1.params)
    g_want = pckpt.flax_params_to_state_dict(grads)
    halved = "encoders.0.convs.0.weight"
    _adamw_gate({k: v for k, v in p_got.items() if k != halved},
                {k: v for k, v in p_want.items() if k != halved}, g_want)
    _adamw_gate({halved: p_got[halved]}, {halved: p_want[halved]},
                {halved: torch.zeros_like(g_want[halved])})


def test_model_split_conv_gathered_equals_whole():
    """``torch_param_sharding``: a Conv3d split on its output channels
    (weight dim 0, bias dim 0) and a ConvTranspose3d (weight dim 1),
    gathered back over ``model``, equal the whole layer; a GroupNorm
    splits with whole groups only."""
    mesh = _mesh8()
    model = UNet3D(in_channels=1, out_channels=12, features=(16, 32),
                   scale_factors=((1, 2, 2),), dtype=torch.float32)
    pls = pmesh.torch_param_sharding(mesh, model)
    assert pls["encoders.0.convs.0.weight"].spec == ("model",)
    assert pls["encoders.0.convs.0.bias"].spec == ("model",)
    assert pls["encoders.0.norms.0.weight"].spec == ("model",)
    assert pls["upsamplers.0.weight"].spec == (None, "model")
    assert pls["upsamplers.0.bias"].spec == ("model",)
    assert pls["head.weight"].spec == ("model",)
    # the flax-layout rule is left as it is: it splits the last dim (kw)
    assert pmesh.param_sharding(mesh, dict(model.state_dict()))[
        "encoders.0.convs.0.weight"].spec == ()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 16, 4, 8, 8), generator=gen)
    conv = model.encoders[0].convs[1]
    up = model.upsamplers[0]
    whole_c = torch.nn.functional.conv3d(x, conv.weight, conv.bias,
                                         padding=1)
    xu = torch.randn((1, 32, 2, 4, 4), generator=gen)
    whole_u = torch.nn.functional.conv_transpose3d(xu, up.weight, up.bias,
                                                   stride=(1, 2, 2))
    sd = dict(model.state_dict())
    w = pmesh.shard(sd["encoders.0.convs.1.weight"], mesh,
                    pls["encoders.0.convs.1.weight"])
    b = pmesh.shard(sd["encoders.0.convs.1.bias"], mesh,
                    pls["encoders.0.convs.1.bias"])
    wu = pmesh.shard(sd["upsamplers.0.weight"], mesh,
                     pls["upsamplers.0.weight"])
    bu = pmesh.shard(sd["upsamplers.0.bias"], mesh,
                     pls["upsamplers.0.bias"])
    net = ptrain._ShardedUNet(model, mesh, pls)
    with torch.no_grad():
        pieces = [torch.nn.functional.conv3d(x, wi, bi, padding=1)
                  for wi, bi in zip(w, b)]
        assert pieces[0].shape[1] == 8
        gathered = net.gather_model(pieces)
        upieces = [torch.nn.functional.conv_transpose3d(
            xu, wi, bi, stride=(1, 2, 2)) for wi, bi in zip(wu, bu)]
        ugathered = net.gather_model(upieces)
    for g in gathered:
        torch.testing.assert_close(g, whole_c, rtol=0, atol=0)
    for g in ugathered:
        torch.testing.assert_close(g, whole_u, rtol=0, atol=0)
    # 8 groups of one channel on 4 channels: a model axis of 8 would cut
    # a 4-channel layer's conv but not its norm, so neither splits
    small = UNet3D(in_channels=1, out_channels=3, features=(4, 8),
                   scale_factors=SCALES)
    wide = pmesh.make_mesh(axis_sizes=(1, 1, 8),
                           devices=pmesh.shard_devices("cpu", 8))
    pl8 = pmesh.torch_param_sharding(wide, small)
    assert pl8["encoders.0.convs.0.weight"].spec == ()
    assert pl8["encoders.0.norms.0.weight"].spec == ()
    assert pl8["bottleneck.convs.0.weight"].spec == ("model",)
    assert pl8["head.weight"].spec == ()


def test_train_step_for_mesh_learns():
    step, state, (x, y) = ptrain.train_step_for_mesh(
        n_devices=8, features=(4, 8), shape=(2, 8, 16, 16), device="cpu")
    assert state.mesh.shape == {"data": 2, "space": 2, "model": 2}
    state, loss0 = step(state, x, y)
    for _ in range(3):
        state, loss = step(state, x, y)
    assert np.isfinite(float(loss0))
    assert float(loss) < float(loss0)
    assert state.step == 4


def test_init_state_draws_flax_distributions():
    model = UNet3D(in_channels=1, out_channels=12, features=(16, 32, 64),
                   scale_factors=((1, 2, 2), (2, 2, 2)))
    gen = torch.Generator().manual_seed(5)
    state = ptrain.init_state(model, (1, 1, 8, 32, 32), generator=gen,
                              device="cpu")
    assert state.step == 0 and state.opt_state.count == 0
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            w = state.params[name + ".weight"]
            c_in = w.shape[1] if isinstance(mod, torch.nn.Conv3d) \
                else w.shape[0]
            want = 1.0 / np.sqrt(c_in * np.prod(w.shape[2:]))
            if w.numel() >= 1000:
                assert abs(float(w.std()) / want - 1) < 0.1, name
            # truncated at two standard deviations of the untruncated
            # normal (std / 0.8796)
            assert float(w.abs().max()) <= 2 * want / 0.8796 + 1e-6, name
            assert torch.count_nonzero(state.params[name + ".bias"]) == 0
        elif isinstance(mod, torch.nn.GroupNorm):
            assert torch.equal(state.params[name + ".weight"],
                               torch.ones(mod.num_channels))
            assert torch.count_nonzero(state.params[name + ".bias"]) == 0
    again = ptrain.init_state(model, (1, 1, 8, 32, 32),
                              generator=torch.Generator().manual_seed(5),
                              device="cpu")
    assert all(torch.equal(v, again.params[k])
               for k, v in state.params.items())
    with pytest.raises(ValueError, match="input shape"):
        ptrain.init_state(model, (1, 2, 8, 32, 32), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ptrain.init_state(model, (1, 1, 8, 32, 32))
