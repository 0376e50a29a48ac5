"""The norm pair's InstanceNorm variants (``ops/norm.py``
``group_norm_act``): LeakyReLU or no activation after the norm, no affine
parameters, one group per channel; and the pair's float16 instance.

On the CPU: the plain version of each activation, with and without affine
parameters, against ``F.instance_norm`` / ``F.group_norm`` and the
activation; the checks the card path makes; no kernel launched on the CPU.
Marked ``card``: the kernels against the plain version at Swin UNETR's
decoder shapes, with ``tests/test_torch_groupnorm.py``'s tolerances, the
float16 instance, and the launch counts of each variant.  Run those on a
machine with a CUDA device with ``python3 -m pytest
tests/test_torch_instnorm.py -q -m card --noconftest`` (``-s`` prints the
gaps).
"""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F

from cluster_tools_tpu_torch import kernels
from cluster_tools_tpu_torch.ops import norm

ACTS = ("gelu_tanh", "leaky_relu", "none")
VARIANTS = {"gelu_tanh": "groupnorm_gelu", "leaky_relu": "groupnorm_leaky_relu",
            "none": "groupnorm_none"}


def _act(z, activation):
    if activation == "gelu_tanh":
        return F.gelu(z, approximate="tanh")
    if activation == "leaky_relu":
        return F.leaky_relu(z, 0.01)
    return z


def _expected(x, w, b, groups, eps, activation):
    """The function in float32, by the library's InstanceNorm where there is
    one group per channel and no affine step, else its GroupNorm."""
    if w is None and groups == x.shape[1]:
        z = F.instance_norm(x.float(), eps=eps)
    else:
        z = F.group_norm(x.float(), groups, w, b, eps)
    return _act(z, activation)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["instance", "grouped"])
@pytest.mark.parametrize("activation", ACTS)
def test_plain_version_of_each_variant(activation, per_channel, affine,
                                       dtype):
    """Output and gradients of the plain path: float32 inputs to 1e-6 of
    the library's InstanceNorm / GroupNorm (the same float32 function by
    other kernels); bfloat16 outputs within one bfloat16 rounding."""
    gen = torch.Generator().manual_seed(len(activation) + 2 * affine)
    shape = (2, 6, 3, 5, 4)
    groups = 6 if per_channel else 3
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen)
    w = b = None
    if affine:
        w = (1 + 0.2 * torch.randn(6, generator=gen)).requires_grad_(True)
        b = (0.2 * torch.randn(6, generator=gen)).requires_grad_(True)
    outs = []
    for fn in (lambda t: norm.group_norm_act(t, w, b, groups, 1e-5, dtype,
                                             activation),
               lambda t: _expected(t, w, b, groups, 1e-5, activation)):
        xr = x.clone().requires_grad_(True)
        y = fn(xr)
        params = [w, b] if affine else []
        grads = torch.autograd.grad(y.float(), [xr] + params,
                                    dy.to(y.dtype).float())
        outs.append((y.float(), *grads))
    got, want = outs
    assert got[0].shape == shape
    if dtype == torch.float32:
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
    else:
        # both round one float32 value to bfloat16: equal, or one bfloat16
        # ulp apart where the float32 values straddle a rounding boundary
        torch.testing.assert_close(got[0], want[0].to(dtype).float(),
                                   rtol=2 ** -7, atol=1e-6)


def test_group_norm_gelu_is_the_gelu_variant():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 4, 4, 4, generator=gen)
    w, b = torch.rand(8, generator=gen), torch.rand(8, generator=gen)
    assert torch.equal(norm.group_norm_gelu(x, w, b, 4, 1e-6, x.dtype),
                       norm.group_norm_act(x, w, b, 4, 1e-6, x.dtype))


def test_checks_of_the_new_arguments():
    x = torch.zeros(2, 8, 4, 4, 4, dtype=torch.bfloat16)
    w, b = torch.ones(8), torch.zeros(8)
    norm._check(x, None, None, 8, torch.bfloat16, "leaky_relu")
    norm._check(x.half(), w, b, 8, torch.float16, "none")
    with pytest.raises(ValueError, match="no activation 'relu'"):
        norm._check(x, w, b, 8, torch.bfloat16, "relu")
    with pytest.raises(ValueError, match="no activation 'relu'"):
        norm.group_norm_act(x, w, b, 8, 1e-5, torch.bfloat16, "relu")
    with pytest.raises(ValueError, match="a weight and a bias, or neither"):
        norm._check(x, w, None, 8, torch.bfloat16, "none")
    with pytest.raises(ValueError, match="no group_norm_gelu or "
                                         "group_norm_act implementation"):
        norm.group_norm_act(x.to("meta"), None, None, 8, 1e-5,
                            torch.bfloat16, "none")


def test_variants_registered_and_not_launched_on_the_cpu():
    from cluster_tools_tpu_torch.models.swin_unetr import create_swin_unetr

    for act, name in VARIANTS.items():
        for key in (name, name + "_bwd"):
            k = kernels.KERNELS[key]
            assert k.route == "cuda"
            assert k.source == "cluster_tools_tpu_torch/csrc/groupnorm.cu"
    assert {norm._COUNTER[a] for a in ACTS} == set(VARIANTS.values())
    kernels.reset_counts()
    model = create_swin_unetr(feature_size=12, num_heads=(1, 2, 3, 6),
                              window_size=3)
    model(torch.randn(1, 1, 32, 32, 32)).sum().backward()
    assert sum(kernels.counts().values()) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _ulp(t, mantissa_bits):
    """One ulp at each value of ``t`` (float32) of a float format with
    ``mantissa_bits`` stored bits."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       torch.clamp(e - 1 - mantissa_bits, min=-133))


#: Swin UNETR's decoder at the benchmark's batch of 4 96^3 crops (feature
#: size 48): the top level, a mid level, hidden state 4 (27 voxels: no
#: vector loads) and a ragged row
CARD_CASES = [("top", (4, 48, 96, 96, 96)), ("level2", (4, 96, 24, 24, 24)),
              ("deepest", (4, 768, 3, 3, 3)), ("ragged", (3, 16, 3, 17, 19))]
#: tests/test_torch_groupnorm.py's tolerances: an output value within one
#: ulp of the plain version's float32 value or beyond it by at most
#: OUT_ATOL (where z = x a + b cancels near 0 the two round z in another
#: order); float32 outputs relative to the largest; gradients relative to
#: the largest reference value.  float16 keeps 3 more mantissa bits than
#: bfloat16: its dx limit is bfloat16's / 8
OUT_ATOL = 1e-5
F32_OUT_REL = 1e-5
PARAM_GRAD_REL = 1e-4
DX_REL = {torch.bfloat16: 2e-2, torch.float16: 2.5e-3, torch.float32: 1e-4}
#: |z| below which a value's LeakyReLU slope is the rounding's choice:
#: float32 rounding of z = (x - mean) rstd, of a few units, is under 1e-6
KINK = 1e-5
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _inputs(shape, dtype, seed, affine):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
         + torch.randn((1, c) + (1,) * (len(shape) - 2), device="cuda",
                       generator=gen)).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    if not affine:
        return x, None, None, dy
    w = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    b = 0.2 * torch.randn(c, device="cuda", generator=gen)
    return x, w, b, dy


def _fwd_bwd(fn, x, w, b, dy, groups, activation):
    xr = x.clone().requires_grad_(True)
    leaves = [xr]
    if w is not None:
        w, b = (t.clone().requires_grad_(True) for t in (w, b))
        leaves += [w, b]
    y = fn(xr, w, b, groups, 1e-5, activation)
    grads = torch.autograd.grad(y, leaves, dy)
    return (y.detach(),) + grads


def _kernel(x, w, b, groups, eps, activation):
    return norm.group_norm_act(x, w, b, groups, eps, x.dtype, activation)


def _plain_f32(x, w, b, groups, eps, activation):
    """The plain version before its cast."""
    return _act(F.group_norm(x.float(), groups, w, b, eps), activation)


def _compare(name, dtype, activation, got, want, z=None):
    """``z``: the plain version's normalized values; where LeakyReLU's
    slope jumps (|z| under KINK) the two round z to either side of 0 and
    take either slope, both right: dx is compared elsewhere."""
    y, dx = got[0], got[1]
    ry, rdx = want[0], want[1]
    rec = {"case": name, "dtype": str(dtype), "activation": activation,
           "out_rel": _rel(y, ry)}
    if activation == "leaky_relu" and z is not None:
        kink = z.abs() < KINK
        rec["at_kink"] = int(kink.sum())
        dx = torch.where(kink, 0, dx.float())
        rdx = torch.where(kink, 0, rdx.float())
    rec["dx_rel"] = _rel(dx, rdx)
    if len(got) > 2:
        rec["dweight_rel"] = _rel(got[2], want[2])
        rec["dbias_rel"] = _rel(got[3], want[3])
    if dtype != torch.float32:
        err = (y.float() - ry).abs()
        ulp = _ulp(ry, MANTISSA[dtype])
        rec["out_share_beyond_1ulp"] = float((err > ulp).float().mean())
        rec["out_max_abs_beyond_1ulp"] = float(
            torch.where(err > ulp, err, 0).max())
    print("instnorm-card " + json.dumps(rec))
    assert torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
    if dtype == torch.float32:
        assert rec["out_rel"] <= F32_OUT_REL, rec
    else:
        assert rec["out_max_abs_beyond_1ulp"] <= OUT_ATOL, rec
    assert rec["dx_rel"] <= DX_REL[dtype], rec
    for k in ("dweight_rel", "dbias_rel"):
        if k in rec:
            assert rec[k] <= PARAM_GRAD_REL, rec


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("activation", ["leaky_relu", "none"])
@pytest.mark.parametrize("name,shape", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_card_instance_norm_matches_the_plain_version(card, name, shape,
                                                      activation, dtype):
    x, _, _, dy = _inputs(shape, dtype, len(name), affine=False)
    kernels.reset_counts()
    got = _fwd_bwd(_kernel, x, None, None, dy, shape[1], activation)
    torch.cuda.synchronize()
    counts = kernels.counts()
    assert counts[VARIANTS[activation]] == 1
    assert counts[VARIANTS[activation] + "_bwd"] == 1
    assert sum(counts.values()) == 2
    want = _fwd_bwd(_plain_f32, x, None, None, dy.float(), shape[1],
                    activation)
    assert got[0].dtype == got[1].dtype == dtype
    z = F.group_norm(x.float(), shape[1], eps=1e-5)
    _compare(name, dtype, activation, got, want, z)


@pytest.mark.card
@pytest.mark.parametrize("activation", ACTS)
def test_card_float16_instance(card, activation):
    """float16 through the pair (the U-Net's GroupNorm + GELU with affine
    parameters, and the InstanceNorm variants)."""
    shape = (2, 64, 16, 64, 64)
    affine = activation == "gelu_tanh"
    groups = 8 if affine else shape[1]
    x, w, b, dy = _inputs(shape, torch.float16, 11, affine)
    got = _fwd_bwd(_kernel, x, w, b, dy, groups, activation)
    torch.cuda.synchronize()
    want = _fwd_bwd(_plain_f32, x, w, b, dy.float(), groups, activation)
    assert got[0].dtype == torch.float16
    z = F.group_norm(x.float(), groups, w, b, eps=1e-5)
    _compare("float16", torch.float16, activation, got, want, z)


@pytest.mark.card
def test_card_float16_unet_trains(card):
    """A float16 U-Net steps on the card (it raised before the pair took
    float16)."""
    from cluster_tools_tpu_torch.models import train as T
    from cluster_tools_tpu_torch.models.unet import create_unet

    model = create_unet(features=(16, 32), anisotropic=False,
                        dtype=torch.float16).cuda()
    x = torch.randn(2, 1, 16, 32, 32, device="cuda")
    y = (torch.rand(2, 12, 16, 32, 32, device="cuda") > 0.5).float()
    state = T.init_state(model, tuple(x.shape),
                         generator=torch.Generator().manual_seed(0))
    kernels.reset_counts()
    _, loss = T.make_train_step(model)(state, x, y)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert kernels.counts()["groupnorm_gelu"] == 6


@pytest.mark.card
def test_card_swin_step_launch_counts(card, monkeypatch):
    """One training step of Swin UNETR: 10 LeakyReLU InstanceNorms (one per
    residual block) and 16 without activation (the second of each block
    and the 1x1x1 path of the six blocks that change width), each forward
    and backward; no GELU instance and no call of ``F.group_norm``."""
    from cluster_tools_tpu_torch.models import train as T
    from cluster_tools_tpu_torch.models.swin_unetr import create_swin_unetr

    def refuse(*args, **kwargs):
        raise AssertionError("torch.nn.functional.group_norm called")

    model = create_swin_unetr(feature_size=12, num_heads=(1, 2, 3, 6),
                              window_size=3).cuda()
    x = torch.randn(2, 1, 32, 32, 32, device="cuda")
    y = (torch.rand(2, 12, 32, 32, 32, device="cuda") > 0.5).float()
    state = T.init_state(model, tuple(x.shape),
                         generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(F, "group_norm", refuse)
    kernels.reset_counts()
    _, loss = T.make_train_step(model, 1e-4)(state, x, y)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    counts = kernels.counts()
    assert counts["groupnorm_leaky_relu"] == 10
    assert counts["groupnorm_leaky_relu_bwd"] == 10
    assert counts["groupnorm_none"] == 16
    assert counts["groupnorm_none_bwd"] == 16
    assert counts["groupnorm_gelu"] == counts["groupnorm_gelu_bwd"] == 0
