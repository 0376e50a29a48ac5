"""Swin UNETR (``models/swin_unetr.py``) against the plain reference
``tests/swin_unetr_reference.py`` on the CPU, on seeded random weights at
a small size: feature size 12, heads (1, 2, 3, 6), window 3, a 32^3 input,
so that stages 1-3 pad their extent to a multiple of the window and shift,
and stage 4 (2^3) clamps its window.

Forward, loss and every gradient in float32; the bfloat16 model under a
tolerance that a float8 model fails; one ``make_train_step`` against the
reference's AdamW step; unshifted windows and a dropped bias fail the
comparison; the windows, their reverse, the shift mask and the padding as
properties; the paths that stay U-Net-only raise by name.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
import swin_unetr_reference as ref

from cluster_tools_tpu_torch.core import telemetry
from cluster_tools_tpu_torch.models import swin_unetr as S
from cluster_tools_tpu_torch.models import train as T

DEPTHS, HEADS, WINDOW, FEATURE = (2, 2, 2, 2), (1, 2, 3, 6), 3, 12
SHAPE = (2, 1, 32, 32, 32)


def _model(dtype=torch.float32):
    return S.create_swin_unetr(feature_size=FEATURE, num_heads=HEADS,
                               window_size=WINDOW, dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    """Weights from ``init_params`` (the bias tables and the norms' scales
    and shifts moved off their initial values, so that every term shows),
    a batch of random crops and targets, and the reference's loss and
    gradients in float32."""
    model = _model()
    params = T.init_params(model, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    for k in params:
        if k.endswith("relative_position_bias_table"):
            params[k] = params[k] * 25.0
        elif ".norm" in k:
            params[k] = params[k] + 0.1 * torch.randn(params[k].shape,
                                                      generator=gen)
    x = torch.randn(SHAPE, generator=gen)
    y = (torch.rand((2, 12) + SHAPE[2:], generator=gen) > 0.5).float()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pred = ref.forward(leaves, x, DEPTHS, HEADS, WINDOW)
    loss = ref.loss(pred, y)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return params, x, y, pred.detach(), loss.detach(), grads


def _grad_errors(got, want):
    """Per leaf, ``||g - r||`` over the larger of ``||r||`` and a thousandth
    of the median leaf's ``||r||`` (leaves whose exact gradient is 0 carry
    rounding only: the bottom block's single-voxel InstanceNorms)."""
    norms = {k: float(want[k].norm()) for k in want}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return {k: float((got[k] - want[k]).norm()) / max(norms[k], floor)
            for k in want}


def _attn_error(got, want):
    """The largest relative error over the attention leaves (bias tables,
    q/k/v and output projections), whole vectors compared."""
    return max(float((got[k] - want[k]).norm() / want[k].norm())
               for k in want if k.endswith((
                   "relative_position_bias_table", "qkv.weight",
                   "proj.weight")))


#: float32 against float32: the model sums in another order (SDPA against
#: an explicit softmax, the norm op against a written-out InstanceNorm)
#: through some 60 layers; measured 2e-7 on the output and 2e-6 on the
#: gradients.  One leaf is looser: the 1x1x1 kernel on the single input
#: channel, whose scale its InstanceNorm divides out, so that its gradient
#: is epsilon's share alone, a difference of nearly equal terms (measured
#: 2.3e-3)
F32_OUT_RTOL = 1e-5
F32_GRAD_RTOL = 1e-4
EPS_ONLY = {"encoders.0.conv3.weight": 1e-2}


def _assert_f32_grads(got, want):
    errs = _grad_errors(got, want)
    bad = {k: e for k, e in errs.items()
           if e >= EPS_ONLY.get(k, F32_GRAD_RTOL)}
    assert not bad, bad


def test_forward_loss_and_gradients_match_in_float32(setup):
    params, x, y, pred, loss, grads = setup
    model = _model()
    model.load_state_dict(params)
    with torch.no_grad():
        out = model(x)
    assert out.shape == (2, 12) + SHAPE[2:] and out.dtype == torch.float32
    torch.testing.assert_close(out, pred, rtol=F32_OUT_RTOL, atol=1e-6)
    got_loss, got = T.loss_and_grads(model, params, x, y)
    assert float(got_loss) == pytest.approx(float(loss), rel=F32_OUT_RTOL)
    assert set(got) == set(grads)
    _assert_f32_grads(got, grads)


def _bf16_and_fp8_errors(setup):
    params, x, y, pred, loss, grads = setup
    model = _model(torch.bfloat16)
    model.load_state_dict(params)
    with torch.no_grad():
        out = model(x)
    _, got = T.loss_and_grads(model, params, x, y)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pred8 = ref.forward(leaves, x, DEPTHS, HEADS, WINDOW, quantize=True)
    g8 = torch.autograd.grad(ref.loss(pred8, y), list(leaves.values()))
    g8 = dict(zip(leaves, g8))

    def out_err(p):
        return float((p.detach() - pred).norm() / pred.norm())
    return ((out_err(out), _attn_error(got, grads)),
            (out_err(pred8), _attn_error(g8, grads)))


#: bfloat16 against float32: the output within 1 % (bfloat16 keeps 8
#: significant bits, 0.4 % per rounding, and the decoder rounds some 30
#: times); the attention leaves' gradients within 50 % (they reach the
#: loss through the LayerNorm of every hidden state, whose backward
#: cancels most of what it is given).  A float8 e4m3 model (4 significant
#: bits) fails both
BF16_OUT_RTOL = 1e-2
BF16_ATTN_GRAD_RTOL = 0.5


def test_bfloat16_within_a_tolerance_that_float8_fails(setup):
    (b_out, b_attn), (q_out, q_attn) = _bf16_and_fp8_errors(setup)
    print(json.dumps({"bf16": [b_out, b_attn], "fp8": [q_out, q_attn]}))
    assert b_out < BF16_OUT_RTOL and b_attn < BF16_ATTN_GRAD_RTOL
    assert q_out > BF16_OUT_RTOL and q_attn > BF16_ATTN_GRAD_RTOL


def test_one_train_step_against_the_reference_adamw(setup):
    params, x, y, _, loss, grads = setup
    model = _model()
    lr, wd = 1e-4, 1e-5
    opt = T.make_optimizer(lr, wd)
    state = T.TrainState(dict(params), opt.init(params), 0,
                         config=T.model_config(model),
                         optimizer=opt.config())
    new, got_loss = T.make_train_step(model, lr)(state, x, y)
    assert float(got_loss) == pytest.approx(float(loss), rel=F32_OUT_RTOL)
    assert new.step == 1 and new.config["model"] == "swin_unetr"
    # the step is AdamW on the model's gradient: the reference's update
    # from the port's gradient, to float32 rounding
    _, g = T.loss_and_grads(model, params, x, y)
    want = ref.adamw_first_step(params, g, lr, wd)
    for k in params:
        torch.testing.assert_close(new.params[k], want[k], rtol=1e-6,
                                   atol=1e-9)
    # and that gradient is the reference's (above)
    _assert_f32_grads(g, grads)


@pytest.mark.parametrize("fault", ["no_shift", "no_bias"])
def test_planted_faults_fail_the_comparison(setup, monkeypatch, fault):
    """Windows that never shift, or the bias left out: the float32
    gradients of the attention leaves leave the float32 tolerance by far."""
    params, x, y, _, _, grads = setup
    if fault == "no_shift":
        orig = S.window_and_shift
        monkeypatch.setattr(S, "window_and_shift",
                            lambda e, w, shifted: orig(e, w, False))
    else:
        orig_bias = S.relative_bias
        monkeypatch.setattr(S, "relative_bias",
                            lambda t, i, n: orig_bias(t, i, n) * 0.0)
    model = _model()
    _, got = T.loss_and_grads(model, params, x, y)
    assert _attn_error(got, grads) > 100 * F32_GRAD_RTOL
    assert max(_grad_errors(got, grads).values()) > F32_GRAD_RTOL


# ---------------------------------------------------------------------------
# windows, shifts, padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,win", [((6, 6, 6), (3, 3, 3)),
                                      ((4, 6, 8), (2, 3, 4)),
                                      ((2, 2, 2), (2, 2, 2))])
def test_partition_and_reverse(dims, win):
    t = torch.randn((2,) + dims + (5,))
    w = S.partition(t, win)
    assert w.shape == (2, math.prod(d // v for d, v in zip(dims, win)),
                       math.prod(win), 5)
    torch.testing.assert_close(w, ref.windows(t, win), rtol=0, atol=0)
    assert torch.equal(S.reverse(w, win, dims), t)
    torch.testing.assert_close(ref.unwindows(w, win, dims), t, rtol=0,
                               atol=0)
    # a window holds a contiguous box: its first token is its corner
    assert torch.equal(w[:, 0, 0], t[:, 0, 0, 0])
    assert torch.equal(w[:, 0, -1], t[:, win[0] - 1, win[1] - 1,
                                      win[2] - 1])


@pytest.mark.parametrize("extent,shifted,want", [
    ((16, 16, 16), True, ((3, 3, 3), (1, 1, 1))),
    ((16, 16, 16), False, ((3, 3, 3), (0, 0, 0))),
    ((2, 2, 2), True, ((2, 2, 2), (0, 0, 0))),
    ((48, 48, 48), True, ((3, 3, 3), (1, 1, 1))),
    ((3, 8, 2), True, ((3, 3, 2), (0, 1, 0)))])
def test_window_and_shift(extent, shifted, want):
    assert S.window_and_shift(extent, 3, shifted) == want


@pytest.mark.parametrize("dims,win,shift", [((6, 6, 6), (3, 3, 3),
                                             (1, 1, 1)),
                                            ((14, 14, 14), (7, 7, 7),
                                             (3, 3, 3)),
                                            ((6, 9, 3), (3, 3, 3),
                                             (1, 1, 0))])
def test_shift_mask(dims, win, shift):
    m = S.shift_mask(dims, win, shift, "cpu", torch.float32)
    n_win = math.prod(d // w for d, w in zip(dims, win))
    n = math.prod(win)
    assert m.shape == (n_win, n, n)
    assert set(m.unique().tolist()) <= {0.0, S.MASK_VALUE}
    assert torch.equal(m, m.transpose(1, 2))
    assert torch.all(m.diagonal(dim1=1, dim2=2) == 0)
    # the windows away from the high end of every shifted axis see one
    # region; the last window sees every region of the shifted axes
    assert torch.all(m[0] == 0)
    assert int((m[-1] == 0).sum()) == sum(
        c * c for c in _region_sizes(win, shift))
    reg = ref.windows(ref.shift_regions(dims, win, shift)[None, ..., None],
                      win)[0, ..., 0]
    want = torch.where(reg[:, None, :] == reg[:, :, None], 0.0,
                       S.MASK_VALUE)
    assert torch.equal(m, want)


def _region_sizes(win, shift):
    """Tokens of each region in the last window (the product of each
    shifted axis's split w - s, s)."""
    sizes = [1]
    for w, s in zip(win, shift):
        parts = [w - s, s] if s else [w]
        sizes = [a * b for a in sizes for b in parts]
    return sizes


@pytest.mark.parametrize("win", [(3, 3, 3), (2, 2, 2), (3, 2, 1)])
def test_relative_index(win):
    idx = S.relative_index(win, 3, "cpu")
    n = math.prod(win)
    assert idx.shape == (n * n,)
    assert int(idx.min()) >= 0 and int(idx.max()) < 5 ** 3
    # a token against itself: the table's centre row
    centre = (2 * 5 + 2) * 5 + 2
    assert torch.all(idx.view(n, n).diagonal() == centre)
    assert torch.equal(idx.view(n, n), ref.bias_rows(win, 3))


def test_padding_leaves_the_tokens_shape_and_matches_the_reference():
    """A block on an extent that is no multiple of its window (5 -> 6)
    returns the tokens' shape, computes the reference's block, and its
    padded tokens change nothing of the others but through attention."""
    torch.manual_seed(7)
    blk = S.SwinBlock(12, 2, 3, shifted=True)
    p = {f"b.{k}": v.detach() for k, v in blk.state_dict().items()}
    p["b.attn.relative_position_bias_table"] = torch.randn(125, 2)
    blk.load_state_dict({k[2:]: v for k, v in p.items()})
    t = torch.randn(2, 5, 5, 4, 12)
    counts = [0, 0]
    out = blk(t, torch.float32, 0, counts)
    assert out.shape == t.shape
    assert counts == [2 * 2 * 2 * 2, 2 * (6 * 6 * 6 - 5 * 5 * 4)]
    want = ref.block(p, "b", t, 2, 3, True, lambda v: v, True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the paths that stay U-Net-only, configuration, init, spans
# ---------------------------------------------------------------------------

def test_unet_only_paths_raise_by_name(tmp_path):
    from cluster_tools_tpu_torch.models import checkpoint
    from cluster_tools_tpu_torch.models.frameworks import get_predictor
    from cluster_tools_tpu_torch.parallel import mesh as mesh_lib

    model = _model()
    state = T.init_state(model, SHAPE, device="cpu")
    with pytest.raises(TypeError, match="not SwinUNETR"):
        T.make_sharded_step(model)
    mesh = mesh_lib.make_mesh(devices=[torch.device("cpu")])
    with pytest.raises(TypeError, match="not SwinUNETR"):
        T.shard_train_step(model, state, mesh)
    with pytest.raises(ValueError, match="SwinUNETR"):
        checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state.config,
                                   model.state_dict())
    with pytest.raises(ValueError, match="SwinUNETR"):
        checkpoint.save_train_state(str(tmp_path / "state"), state)
    assert not (tmp_path / "ckpt").exists()
    assert not (tmp_path / "state").exists()
    # InferenceTask's "self" framework reads model.json: a Swin
    # configuration there is refused by name
    (tmp_path / "swin").mkdir()
    (tmp_path / "swin" / "model.json").write_text(json.dumps(state.config))
    with pytest.raises(ValueError, match="SwinUNETR"):
        get_predictor("self", str(tmp_path / "swin"), (32, 32, 32),
                      (0, 0, 0), device="cpu")


def test_model_config_and_init():
    model = S.create_swin_unetr()
    cfg = T.model_config(model)
    assert cfg == {"model": "swin_unetr", "in_channels": 1,
                   "out_channels": 12, "feature_size": 48,
                   "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
                   "window_size": 7}
    # the published parameter count (62.2 M at 14 outputs)
    assert sum(p.numel() for p in S.create_swin_unetr(
        out_channels=14).parameters()) == 62187296
    p = T.init_params(_model(), torch.Generator().manual_seed(0))
    lin = p["stages.2.blocks.0.mlp.fc1.weight"]
    assert float(lin.abs().max()) <= 2 * T.SWIN_INIT_STD
    assert 0.8 * T.SWIN_INIT_STD < float(lin.std()) < T.SWIN_INIT_STD
    table = p["stages.0.blocks.1.attn.relative_position_bias_table"]
    assert float(table.abs().max()) <= 2 * T.SWIN_INIT_STD
    assert torch.all(p["stages.1.merge.norm.weight"] == 1)
    assert torch.all(p["stages.1.blocks.0.attn.qkv.bias"] == 0)
    conv = p["decoders.4.block.conv1.weight"]       # fan in 24 * 27
    assert float(conv.std()) == pytest.approx(math.sqrt(1 / (24 * 27)),
                                              rel=0.1)
    assert "encoders.1.conv3.weight" not in p      # no width change there
    # the U-Net's configuration has no "model" key
    from cluster_tools_tpu_torch.models.unet import create_unet

    assert "model" not in T.model_config(create_unet())


def _adamw_tensor_by_tensor(opt, grads, state, params):
    """optax's AdamW written out tensor by tensor."""
    count = state.count + 1
    bc1 = float(np.float32(1) - np.float32(opt.B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(opt.B2) ** np.float32(count))
    mu, nu, upd = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - opt.B1) * g + opt.B1 * state.mu[k]
        nu[k] = (1 - opt.B2) * (g * g) + opt.B2 * state.nu[k]
        d = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + opt.EPS_ROOT)
                             + opt.EPS)
        upd[k] = (-opt.lr) * (d + opt.weight_decay * params[k])
    return upd, T.AdamState(count, mu, nu)


def test_adamw_over_flat_groups_is_the_tensor_by_tensor_update():
    """``AdamW.update`` and ``apply_updates`` run each op once over every
    tensor (``torch._foreach_*``): bit for bit the update tensor by
    tensor, key order and shapes kept, a float64 tensor beside float32."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (3,), "b": (17, 5), "c": (8, 1, 3, 3, 3), "d": (1,),
              "e": (7, 7, 13), "f": (1000,)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    params["d"] = params["d"].double()
    opt = T.make_optimizer(1e-3, 1e-5)
    st_flat = st_each = opt.init(params)
    p_flat = p_each = params
    for i in range(3):
        g = {k: torch.randn(v.shape, generator=gen, dtype=v.dtype) * 10 ** i
             for k, v in params.items()}
        u_flat, st_flat = opt.update(g, st_flat, p_flat)
        u_each, st_each = _adamw_tensor_by_tensor(opt, g, st_each, p_each)
        p_flat = T.apply_updates(p_flat, u_flat)
        p_each = {k: p + u_each[k] for k, p in p_each.items()}
        for got, want in ((u_flat, u_each), (st_flat.mu, st_each.mu),
                          (st_flat.nu, st_each.nu), (p_flat, p_each)):
            assert list(got) == list(shapes)
            for k in shapes:
                assert got[k].dtype == want[k].dtype
                assert torch.equal(got[k], want[k]), (i, k)
    assert st_flat.count == 3


def test_spans_and_ranges_with_telemetry_on():
    model = _model()
    x = torch.randn(1, 1, 32, 32, 32)
    telemetry.reset()
    try:
        with torch.no_grad():
            model(x)
        assert telemetry.spans_snapshot() == []
        telemetry.configure(enabled=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                model(x)
        spans = telemetry.spans_snapshot()
    finally:
        telemetry.reset()
    names = [s.name for s in spans]
    for name in ("swin-forward", "swin-embed", "swin-window-attn",
                 "swin-mlp", "swin-merge", "swin-decoder"):
        assert telemetry.is_registered(name)
        assert name in names
    assert names.count("swin-window-attn") == sum(DEPTHS)
    top = next(s for s in spans if s.name == "swin-forward")
    # windows: 6^3 + 3^3 + 2^3 + 1 per crop over the two blocks of each
    # stage; padding: stages 1-3 pad 16 -> 18, 8 -> 9, 4 -> 6
    assert top.attrs["windows"] == 2 * (216 + 27 + 8 + 1)
    assert top.attrs["padded_tokens"] == 2 * (
        18 ** 3 - 16 ** 3 + 9 ** 3 - 8 ** 3 + 6 ** 3 - 4 ** 3)
    shifted = [s.attrs["shifted"] for s in spans
               if s.name == "swin-window-attn"]
    assert shifted == [False, True] * 3 + [False, False]
    ranges = {e.name for e in prof.events()}
    assert {"swin-forward", "swin-window-attn", "swin-decoder"} <= ranges
