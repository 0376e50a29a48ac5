"""Plain reference of Swin UNETR for the port's CPU tests.

Plain PyTorch, no import of the port or of JAX: the equations of
arXiv:2201.01266 as MONAI's ``SwinUNETR`` computes them, with the choices
``cluster_tools_tpu_torch/models/swin_unetr.py`` states (patch merging in
(dz, dy, dx) order, dx fastest; the bias of a clamped window indexed by the
tokens' true offsets; InstanceNorm without affine parameters; 12 sigmoid
outputs).  Attention is an explicit softmax per window and head; the
windows are cut with ``unfold``-free reshapes, the shift mask is built
voxel by voxel from region ids, the bias rows from coordinate lists.
``shift=False`` and ``bias=False`` give the planted faults, ``fp8``
quantizes the inputs of every convolution, linear and attention product to
float8 e4m3 (a precision below the model's).  Parameters are a dict keyed
by the port's ``state_dict`` names.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5
SLOPE = 0.01


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a per-tensor scale, gradient passed straight."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def instance_norm(h: torch.Tensor) -> torch.Tensor:
    mean = h.mean(dim=(2, 3, 4), keepdim=True)
    var = ((h - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    return (h - mean) / torch.sqrt(var + EPS)


def windows(t: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, nW, n, C), windows and tokens in z, y, x
    order."""
    b, d, h, w, c = t.shape
    t = t.reshape(b, d // win[0], win[0], h // win[1], win[1], w // win[2],
                  win[2], c)
    return t.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, -1, win[0] * win[1] * win[2], c)


def unwindows(t: torch.Tensor, win: Sequence[int],
              dims: Sequence[int]) -> torch.Tensor:
    b, c = t.shape[0], t.shape[-1]
    out = torch.zeros((b,) + tuple(dims) + (c,), dtype=t.dtype,
                      device=t.device)
    nd, nh, nw = (s // w for s, w in zip(dims, win))
    k = 0
    for i, j, l in itertools.product(range(nd), range(nh), range(nw)):
        out[:, i * win[0]:(i + 1) * win[0], j * win[1]:(j + 1) * win[1],
            l * win[2]:(l + 1) * win[2]] = t[:, k].reshape(
                b, win[0], win[1], win[2], c)
        k += 1
    return out


def bias_rows(win: Sequence[int], m: int) -> torch.Tensor:
    """(n, n) row of the ((2m - 1)^3, heads) table for each token pair."""
    coords = list(itertools.product(*[range(w) for w in win]))
    side = 2 * m - 1
    rows = [[((a[0] - b[0] + m - 1) * side + a[1] - b[1] + m - 1) * side
             + a[2] - b[2] + m - 1 for b in coords] for a in coords]
    return torch.tensor(rows)


def shift_regions(dims: Sequence[int], win: Sequence[int],
                  shift: Sequence[int]) -> torch.Tensor:
    """Region id of each voxel of the rolled, padded volume: per shifted
    axis [0, P - w), [P - w, P - s), [P - s, P)."""
    def axis_id(v, p, w, s):
        if not s:
            return 0
        return 0 if v < p - w else (1 if v < p - s else 2)

    ids = torch.zeros(tuple(dims))
    for z, y, x in itertools.product(*[range(p) for p in dims]):
        ids[z, y, x] = (axis_id(z, dims[0], win[0], shift[0]) * 3
                        + axis_id(y, dims[1], win[1], shift[1])) * 3 \
            + axis_id(x, dims[2], win[2], shift[2])
    return ids


def block(p, pre, t, heads, m, shifted, q, use_bias):
    b, *dims, c = t.shape
    win = [min(e, m) for e in dims]
    sh = [m // 2 if shifted and e > m else 0 for e in dims]
    x = F.layer_norm(t, (c,), p[pre + ".norm1.weight"],
                     p[pre + ".norm1.bias"], EPS)
    pad = [(-e) % w for e, w in zip(dims, win)]
    x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    padded = [e + v for e, v in zip(dims, pad)]
    if any(sh):
        x = torch.roll(x, shifts=[-v for v in sh], dims=(1, 2, 3))
    xw = windows(x, win)
    nw, n = xw.shape[1], xw.shape[2]
    d = c // heads
    qkv = F.linear(q(xw), q(p[pre + ".attn.qkv.weight"]),
                   p[pre + ".attn.qkv.bias"])
    qkv = qkv.reshape(b, nw, n, 3, heads, d)
    qq = qkv[:, :, :, 0].transpose(2, 3) * d ** -0.5        # (B, nW, h, n, d)
    kk = qkv[:, :, :, 1].transpose(2, 3)
    vv = qkv[:, :, :, 2].transpose(2, 3)
    s = q(qq) @ q(kk).transpose(-1, -2)
    if use_bias:
        table = p[pre + ".attn.relative_position_bias_table"]
        s = s + table[bias_rows(win, m)].permute(2, 0, 1)
    if any(sh):
        reg = windows(shift_regions(padded, win, sh)[None, ..., None],
                      win)[0, ..., 0]
        s = s + torch.where(reg[:, None, :] == reg[:, :, None], 0.0,
                            -100.0)[:, None]
    a = torch.softmax(s, dim=-1)
    o = (q(a) @ q(vv)).transpose(2, 3).reshape(b, nw, n, c)
    o = F.linear(q(o), q(p[pre + ".attn.proj.weight"]),
                 p[pre + ".attn.proj.bias"])
    o = unwindows(o, win, padded)
    if any(sh):
        o = torch.roll(o, shifts=sh, dims=(1, 2, 3))
    t = t + o[:, :dims[0], :dims[1], :dims[2]]
    x = F.layer_norm(t, (c,), p[pre + ".norm2.weight"],
                     p[pre + ".norm2.bias"], EPS)
    x = F.gelu(F.linear(q(x), q(p[pre + ".mlp.fc1.weight"]),
                        p[pre + ".mlp.fc1.bias"]))
    return t + F.linear(q(x), q(p[pre + ".mlp.fc2.weight"]),
                        p[pre + ".mlp.fc2.bias"])


def merge(p, pre, t, q):
    x = torch.cat([t[:, i::2, j::2, k::2] for i, j, k in
                   itertools.product(range(2), repeat=3)], dim=-1)
    x = F.layer_norm(x, (x.shape[-1],), p[pre + ".norm.weight"],
                     p[pre + ".norm.bias"], EPS)
    return F.linear(q(x), q(p[pre + ".reduction.weight"]))


def res_block(p, pre, x, q):
    h = F.conv3d(q(x), q(p[pre + ".conv1.weight"]), padding=1)
    h = F.leaky_relu(instance_norm(h), SLOPE)
    h = instance_norm(F.conv3d(q(h), q(p[pre + ".conv2.weight"]), padding=1))
    if pre + ".conv3.weight" in p:
        x = instance_norm(F.conv3d(q(x), q(p[pre + ".conv3.weight"])))
    return F.leaky_relu(h + x, SLOPE)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
            depths: Sequence[int], heads: Sequence[int], window: int,
            shift: bool = True, bias: bool = True,
            quantize: bool = False) -> torch.Tensor:
    """Sigmoid probabilities ``(B, out, D, H, W)`` in float32."""
    q = fp8 if quantize else (lambda v: v)
    t = F.conv3d(q(x), q(p["patch_embed.weight"]), p["patch_embed.bias"],
                 stride=2).permute(0, 2, 3, 4, 1)
    hidden = [t]
    for i in range(4):
        for j in range(depths[i]):
            t = block(p, f"stages.{i}.blocks.{j}", t, heads[i], window,
                      shift and j % 2 == 1, q, bias)
        t = merge(p, f"stages.{i}.merge", t, q)
        hidden.append(t)
    hs = [F.layer_norm(v, (v.shape[-1],), eps=EPS).permute(0, 4, 1, 2, 3)
          for v in hidden]
    enc = [res_block(p, f"encoders.{k}", v, q)
           for k, v in enumerate([x] + hs[:3])]
    h = res_block(p, "encoders.4", hs[4], q)
    for k, skip in enumerate([hs[3]] + enc[::-1]):
        up = F.conv_transpose3d(q(h), q(p[f"decoders.{k}.up.weight"]),
                                stride=2)
        h = res_block(p, f"decoders.{k}.block", torch.cat([up, skip], 1), q)
    return torch.sigmoid(F.conv3d(q(h), q(p["head.weight"]), p["head.bias"]))


def loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean BCE (predictions clipped to [1e-6, 1 - 1e-6]) + soft Dice over
    the whole batch."""
    pc = pred.clamp(1e-6, 1 - 1e-6)
    bce = -(target * torch.log(pc) + (1 - target) * torch.log(1 - pc))
    dice = 1 - (2 * (pc * target).sum() + 1) / \
        ((pc * pc).sum() + (target * target).sum() + 1)
    return bce.mean() + dice


def adamw_first_step(p, g, lr: float, wd: float):
    """optax's AdamW, one step from zero moments."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {}
    for k in p:
        mu = (1 - b1) * g[k] / (1 - b1)
        nu = (1 - b2) * g[k] * g[k] / (1 - b2)
        out[k] = p[k] - lr * (mu / (torch.sqrt(nu) + eps) + wd * p[k])
    return out
