"""GroupNorm + tanh GELU of the U-Net's ConvBlock (``ops/norm.py``).

On the CPU: the chunk plan of the CUDA kernels ``csrc/groupnorm.cu``
covers every value once; the wrapper on CPU tensors is the code
``ConvBlock`` ran before, bitwise, forward and gradients, and so are
``UNet3D`` and ``loss_and_grads``; the kernels are registered and never
launched there.  Marked ``card``: the kernel pair against the plain
version on the card.  Run those on a machine with a CUDA device with
``python3 -m pytest tests/test_torch_groupnorm.py -q -m card --noconftest``
(``tests/conftest.py`` imports the JAX package, which the port's machines
need not have).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from cluster_tools_tpu_torch import kernels
from cluster_tools_tpu_torch.models import train as T
from cluster_tools_tpu_torch.models import unet as U
from cluster_tools_tpu_torch.ops import norm

#: the unet-train.crops cell: batch, crop, level widths (2x2x2 pooling)
CELL_BATCH, CELL_CROP = 2, (32, 256, 256)
CELL_FEATURES = (64, 128, 256, 512)
H100_SMS = 132


def cell_shapes():
    """(N, C, S) of the 14 GroupNorms of one step of the training cell, in
    the order the forward runs them."""
    levels = len(CELL_FEATURES)
    vols = [int(np.prod(CELL_CROP)) // 8 ** lv for lv in range(levels)]
    enc = [(CELL_BATCH, f, vols[lv]) for lv, f in
           enumerate(CELL_FEATURES[:-1]) for _ in range(2)]
    mid = [(CELL_BATCH, CELL_FEATURES[-1], vols[-1])] * 2
    dec = [(CELL_BATCH, CELL_FEATURES[lv], vols[lv])
           for lv in reversed(range(levels - 1)) for _ in range(2)]
    return enc + mid + dec


#: rows whose length is no multiple of the pack, shorter than one chunk,
#: one value, or a few values over a whole number of chunks
RAGGED = [(1, 3, 37), (2, 8, 4099), (1, 1, 1), (3, 5, 65549),
          (1, 64, 40000), (8, 16, 7)]


def _spans(row_len, length, chunks, vec):
    """Per chunk, the values a block reads, as ``(start, packed, end)``:
    ``[start, packed)`` in vector loads of PACK values, ``[packed, end)``
    one at a time (``csrc/groupnorm.cu`` ``chunk_of_block`` and
    ``walk_chunk``)."""
    out = []
    for k in range(chunks):
        start, end = k * length, min((k + 1) * length, row_len)
        out.append((start, end // norm.PACK * norm.PACK if vec else start,
                    end))
    return out


def _coverage(row_len, length, chunks, vec):
    """How often the blocks read each value of a row: every thread's loads
    as ``walk_chunk`` makes them (pack p = first + t, t + 256, ... while
    below the packed end; then value i = packed + t, t + 256, ...)."""
    seen = np.zeros(row_len, np.int64)
    for start, packed, end in _spans(row_len, length, chunks, vec):
        assert start < end and start % norm.PACK == 0
        assert (packed - start) % norm.PACK == 0 and end - packed < \
            (norm.PACK if vec else end - start + 1)
        for t in range(norm.THREADS):
            packs = np.arange(start // norm.PACK + t, packed // norm.PACK,
                              norm.THREADS)
            np.add.at(seen, (packs[:, None] * norm.PACK
                             + np.arange(norm.PACK)).ravel(), 1)
            np.add.at(seen, np.arange(packed + t, end, norm.THREADS), 1)
    return seen


@pytest.mark.parametrize("shape", sorted(set(cell_shapes())) + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [H100_SMS, 1])
def test_chunk_plan_covers_every_value_once(shape, sms):
    n, c, s = shape
    length, chunks = norm.chunk_plan(n * c, s, sms)
    assert length % norm.PACK == 0
    assert (chunks - 1) * length < s <= chunks * length
    assert length <= max(norm.MAX_CHUNK, -(-s // norm.PACK) * norm.PACK)
    for vec in {s % norm.PACK == 0, False}:
        np.testing.assert_array_equal(
            _coverage(s, length, chunks, vec), np.ones(s, np.int64))


def test_chunk_plan_fills_the_card_at_the_cell_shapes():
    """Every GroupNorm of the training cell above the bottleneck puts at
    least BLOCKS_PER_SM blocks on each of the H100's SMs, where one block
    per (sample, group) row put 16 on all 132; the bottleneck's rows are
    too short to cut."""
    for n, c, s in cell_shapes():
        length, chunks = norm.chunk_plan(n * c, s, H100_SMS)
        if s >= 2 * norm.MIN_CHUNK:
            assert n * c * chunks >= norm.BLOCKS_PER_SM * H100_SMS
        else:
            assert chunks == 1
    assert [norm.chunk_plan(n * c, s, H100_SMS)
            for n, c, s in sorted(set(cell_shapes()))] == [
        (32768, 64), (32768, 8), (16384, 2), (4096, 1)]


def _old_block_norm(x, gn: nn.GroupNorm, dtype):
    """``ConvBlock``'s normalisation as it was written before the kernels."""
    return F.gelu(gn(x.to(torch.float32)), approximate="tanh").to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", [((2, 16, 4, 6, 6), 8),
                                          ((1, 4, 3, 5, 7), 4),
                                          ((3, 64, 2, 2, 2), 8)])
def test_plain_version_is_the_old_convblock_code(dtype, shape, groups):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(dtype)
    gn = nn.GroupNorm(groups, shape[1], eps=1e-6)
    with torch.no_grad():
        gn.weight.copy_(1 + 0.1 * torch.randn(shape[1], generator=gen))
        gn.bias.copy_(0.1 * torch.randn(shape[1], generator=gen))
    dy = torch.randn(shape, generator=gen).to(dtype)
    outs = []
    for fn in (lambda t: _old_block_norm(t, gn, dtype),
               lambda t: norm.group_norm_gelu(t, gn.weight, gn.bias, groups,
                                              gn.eps, dtype)):
        xr = x.clone().requires_grad_(True)
        gn.zero_grad()
        y = fn(xr)
        y.backward(dy)
        outs.append((y.detach(), xr.grad, gn.weight.grad.clone(),
                     gn.bias.grad.clone()))
    for old, new in zip(*outs):
        assert old.dtype == new.dtype
        assert torch.equal(old, new)


def test_kernels_registered_and_not_launched_on_the_cpu():
    for name in ("groupnorm_gelu", "groupnorm_gelu_bwd"):
        k = kernels.KERNELS[name]
        assert k.route == "cuda"
        assert k.source == "cluster_tools_tpu_torch/csrc/groupnorm.cu"
        assert os.path.isfile(kernels.source_path(name))
        assert k.replaces.startswith("cluster_tools_tpu/models/unet.py:")
    with open(kernels.source_path("groupnorm_gelu")) as f:
        src = f.read()
    # the profiler's breakdown names every kernel of the pair; no atomics
    names = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\)\s*)?"
                       r"(\w+)\(", src)
    assert len(names) == 6 and all("groupnorm" in n for n in names)
    assert not re.search(r"\batomic\w*\(", src)
    kernels.reset_counts()
    model = U.create_unet(features=(4, 8, 16), anisotropic=False)
    x = torch.randn(1, 1, 8, 16, 16)
    model(x).sum().backward()
    assert kernels.counts()["groupnorm_gelu"] == 0
    assert kernels.counts()["groupnorm_gelu_bwd"] == 0


def test_wrapper_checks_what_the_kernels_take():
    """The card's checks, called directly (the CPU takes the plain version
    before them)."""
    x = torch.zeros(2, 8, 4, 4, 4, dtype=torch.bfloat16)
    w, b = torch.ones(8), torch.zeros(8)
    norm._check(x, w, b, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        norm._check(x.transpose(2, 3), w, b, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        norm._check(x.half(), w, b, 8, torch.float16)
    with pytest.raises(ValueError, match="writes the input's dtype"):
        norm._check(x, w, b, 8, torch.float32)
    with pytest.raises(ValueError, match="do not split"):
        norm._check(x, w, b, 3, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 weight"):
        norm._check(x, w.bfloat16(), b, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="bias of shape"):
        norm._check(x, w, torch.zeros(4), 8, torch.bfloat16)
    with pytest.raises(ValueError, match="no group_norm_gelu"):
        norm.group_norm_gelu(x.to("meta"), w.to("meta"), b.to("meta"), 8,
                             1e-6, torch.bfloat16)


def _old_convblock_forward(self, x):
    for conv, gn in zip(self.convs, self.norms):
        x = U._conv(x, conv, self.dtype)
        x = _old_block_norm(x, gn, self.dtype)
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unet_and_its_gradients_unchanged_on_the_cpu(dtype, monkeypatch):
    """``UNet3D``'s output and ``loss_and_grads`` on the CPU equal, bitwise,
    those of the ConvBlock code the kernels replaced."""
    torch.manual_seed(3)
    model = U.create_unet(features=(4, 8, 16), anisotropic=True, dtype=dtype)
    params = T.init_params(model, torch.Generator().manual_seed(4))
    for k in params:  # GroupNorm's scales and shifts away from 1 and 0
        if ".norms." in k:
            params[k] = params[k] + 0.1 * torch.randn(params[k].shape)
    model.load_state_dict(params)
    x = torch.randn(2, 1, 4, 16, 16)
    y = (torch.rand(2, 12, 4, 16, 16) > 0.5).float()
    runs = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(U.ConvBlock, "forward",
                                _old_convblock_forward)
        with torch.no_grad():
            out = model(x)
        loss, grads = T.loss_and_grads(model, params, x, y)
        runs.append((out, loss, grads))
    (o1, l1, g1), (o2, l2, g2) = runs
    assert torch.equal(o1, o2)
    assert torch.equal(l1, l2)
    assert set(g1) == set(g2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bf16_ulp(t):
    """One bfloat16 ulp at each value of ``t`` (float32)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       torch.clamp(e - 8, min=-133))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


#: (name, shape, groups): the cell's level 0 and bottleneck (64 channels per
#: group), one channel per group and a row whose length is no multiple of 8
CARD_CASES = [("level0", (2, 64, 32, 256, 256), 8),
              ("bottleneck", (2, 512, 4, 32, 32), 8),
              ("cpg1", (2, 4, 16, 64, 64), 4),
              ("ragged", (3, 16, 3, 17, 19), 8)]
#: the card against the plain version.  Output: bfloat16 within one ulp of
#: the plain version's float32 value, or beyond it by at most BF16_OUT_ATOL
#: (where z = x a + b cancels near 0 both sides round z in float32, in
#: another order, and an ulp of the output is far below that rounding);
#: float32 relative to the largest value.  Gradients: relative to the
#: largest reference value
BF16_OUT_ATOL = 1e-5
F32_OUT_REL = 1e-5
PARAM_GRAD_REL = 1e-4
DX_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _plain_f32(x, w, b, groups, eps, out_dtype):
    """The plain version before its cast to ``out_dtype``."""
    return F.gelu(F.group_norm(x.float(), groups, w, b, eps),
                  approximate="tanh")


def _inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    # a convolution's output: a per-channel offset and scale
    x = (torch.randn(shape, device="cuda", generator=gen) * 2.0
         + torch.randn((1, c) + (1,) * (len(shape) - 2), device="cuda",
                       generator=gen)).to(dtype)
    w = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    b = 0.2 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, w, b, dy


def _fwd_bwd(fn, x, w, b, dy, groups):
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = fn(xr, wr, br, groups, 1e-6, x.dtype)
    y.backward(dy)
    return y.detach(), xr.grad, wr.grad, br.grad


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name,shape,groups", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_card_kernels_match_the_plain_version(card, name, shape, groups,
                                              dtype):
    x, w, b, dy = _inputs(shape, dtype, seed=len(name))
    kernels.reset_counts()
    got = _fwd_bwd(norm.group_norm_gelu, x, w, b, dy, groups)
    torch.cuda.synchronize()
    assert kernels.counts()["groupnorm_gelu"] == 1
    assert kernels.counts()["groupnorm_gelu_bwd"] == 1
    want = _fwd_bwd(_plain_f32, x, w, b, dy.float(), groups)
    y, dx, dw, db = got
    ry, rdx, rdw, rdb = want
    assert y.dtype == dtype and dx.dtype == rdx.dtype == dtype
    err = (y.float() - ry).abs()
    rec = {"case": name, "dtype": str(dtype), "shape": list(shape),
           "out_rel": _rel(y, ry), "dweight_rel": _rel(dw, rdw),
           "dbias_rel": _rel(db, rdb), "dx_rel": _rel(dx, rdx)}
    if dtype == torch.bfloat16:
        ulp = _bf16_ulp(ry)
        rec["out_max_ulps"] = float((err / ulp).max())
        rec["out_share_beyond_1ulp"] = float((err > ulp).float().mean())
        rec["out_max_abs_beyond_1ulp"] = float(
            torch.where(err > ulp, err, 0).max())
        rec["ref_bf16_share_differing"] = float(
            (y != ry.to(dtype)).float().mean())
    print("groupnorm-card " + json.dumps(rec))
    assert torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
    if dtype == torch.bfloat16:
        assert rec["out_max_abs_beyond_1ulp"] <= BF16_OUT_ATOL, rec
    else:
        assert rec["out_rel"] <= F32_OUT_REL, rec
    assert rec["dweight_rel"] <= PARAM_GRAD_REL, rec
    assert rec["dbias_rel"] <= PARAM_GRAD_REL, rec
    assert rec["dx_rel"] <= DX_REL[dtype], rec


@pytest.mark.card
def test_card_two_calls_are_bitwise_equal(card):
    x, w, b, dy = _inputs((2, 128, 16, 128, 128), torch.bfloat16, seed=7)
    first = _fwd_bwd(norm.group_norm_gelu, x, w, b, dy, 8)
    second = _fwd_bwd(norm.group_norm_gelu, x, w, b, dy, 8)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def _cell_model_step():
    model = U.create_unet(features=CELL_FEATURES, anisotropic=False).cuda()
    x = torch.randn(2, 1, 16, 64, 64, device="cuda")
    y = (torch.rand(2, 12, 16, 64, 64, device="cuda") > 0.5).float()
    state = T.init_state(model, tuple(x.shape),
                         generator=torch.Generator().manual_seed(0))
    return T.make_train_step(model), state, x, y


@pytest.mark.card
def test_card_training_step_launches_each_kernel_14_times(card):
    step, state, x, y = _cell_model_step()
    kernels.reset_counts()
    _, loss = step(state, x, y)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    counts = kernels.counts()
    assert counts["groupnorm_gelu"] == 14
    assert counts["groupnorm_gelu_bwd"] == 14


@pytest.mark.card
def test_card_convblock_takes_channels_last_kernels(card):
    """Kernels in channels-last strides (as a restore that transposes
    them leaves them) make cuDNN write channels-last outputs; the U-Net
    still runs the pair, and computes what it computes from contiguous
    kernels."""
    torch.manual_seed(5)
    model = U.create_unet(features=(8, 16), anisotropic=False,
                          dtype=torch.float32).cuda()
    params = dict(model.state_dict())
    strided = {k: v.to(memory_format=torch.channels_last_3d)
               if v.dim() == 5 else v for k, v in params.items()}
    assert not strided["encoders.0.convs.1.weight"].is_contiguous()
    x = torch.randn(2, 1, 8, 32, 32, device="cuda")
    y = (torch.rand(2, 12, 8, 32, 32, device="cuda") > 0.5).float()
    kernels.reset_counts()
    loss_s, grads_s = T.loss_and_grads(model, strided, x, y)
    loss_c, grads_c = T.loss_and_grads(model, params, x, y)
    torch.cuda.synchronize()
    assert kernels.counts()["groupnorm_gelu"] == 2 * 6
    assert kernels.counts()["groupnorm_gelu_bwd"] == 2 * 6
    torch.testing.assert_close(loss_s, loss_c, rtol=1e-5, atol=0)
    for k in grads_c:
        torch.testing.assert_close(grads_s[k], grads_c[k], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.card
def test_card_path_never_calls_torch_group_norm(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.nn.functional.group_norm called")

    step, state, x, y = _cell_model_step()
    monkeypatch.setattr(F, "group_norm", refuse)
    _, loss = step(state, x, y)
    with torch.no_grad():
        U.create_unet(dtype=torch.float32).cuda()(x[:1, :, :8])
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
