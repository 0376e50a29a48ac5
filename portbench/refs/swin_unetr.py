"""Plain reference of Swin UNETR's training step, in float32.

Swin UNETR (arXiv:2201.01266, MONAI's ``SwinUNETR``) as the configuration
gives it (``feature_size`` F, ``depths``, ``num_heads``, ``window_size``
M, patch 2):

* patch embedding: a 2x2x2 convolution, stride 2, with bias, to F channels;
* four stages at C = F * 2**i; each block ``x + Attn(LN1(x))``, then
  ``x + MLP(LN2(x))`` (LayerNorm eps 1e-5, affine; MLP Linear(C, 4C), the
  exact GELU, Linear(4C, C));
* the attention of a block: LN1's output zero-padded at the high end of
  each axis to a multiple of the window; odd blocks rolled by -(M // 2) on
  each axis; cut into windows (windows and tokens in z, y, x order); per
  window and head ``softmax(q k^T * d**-0.5 + B + mask) v`` with q, k, v
  from one Linear(C, 3C) with bias, d = C / heads, B the rows of the
  ((2M - 1)^3, heads) table at the pair's offset ``(dz + M - 1) (2M - 1)^2
  + (dy + M - 1) (2M - 1) + dx + M - 1`` (token i's coordinates minus token
  j's), and mask -100 between tokens whose regions differ in the rolled
  volume (per shifted axis of padded extent P: [0, P - M), [P - M, P - M //
  2), [P - M // 2, P)); then Linear(C, C), the windows put back, the roll
  undone, the padding cut.  Where an axis's extent is at most M, the window
  is that extent along it and the block does not shift along it;
* patch merging after each stage: the voxels (dz, dy, dx) of each 2x2x2
  cell concatenated in the order (0,0,0), (0,0,1), (0,1,0), (0,1,1),
  (1,0,0), ... (dx fastest), LayerNorm(8C), Linear(8C, 2C) without bias;
* hidden states: the embedding and each stage's merged output, each
  through a LayerNorm without affine parameters;
* decoder: residual blocks (3x3x3 conv, InstanceNorm, LeakyReLU(0.01),
  3x3x3 conv, InstanceNorm, plus the input through a 1x1x1 conv and an
  InstanceNorm where the width changes, then LeakyReLU(0.01)) on the input
  and on hidden states 0, 1, 2, 4; up-blocks (2x2x2 transposed conv,
  stride 2, concatenated as ``[up, skip]``, a residual block) from hidden
  state 4 with skips hidden state 3 and the four residual blocks' outputs,
  deepest first; a 1x1x1 head with bias and the sigmoid.  No convolution
  but the embedding and the head has a bias; InstanceNorm eps 1e-5, no
  affine parameters.

The loss is ``refs/unet.py``'s (mean BCE + soft Dice over the whole
batch), the optimizer AdamW in optax's form at the configuration's rate
and decay.  Everything runs in float32 with TF32 off, attention as an
explicit softmax, in micro-batches (a first pass without gradients takes
the Dice sums of the whole batch).  ``fp8`` quantizes the inputs of every
convolution, linear and attention product to float8 e4m3 (the control);
``shift=False`` and ``bias=False`` leave out the shifted windows or the
relative-position bias (planted faults).  The parameter names are those of
the port's module; nothing here imports the program.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.refs.unet import B1, B2, EPS, _q8, _sums, compare

LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01
MASK = -100.0


def architecture(cfg) -> Tuple[int, Tuple[int, ...], Tuple[int, ...], int]:
    """(feature size, depths, heads, window) of the configuration."""
    return (int(cfg["feature_size"]), tuple(int(v) for v in cfg["depths"]),
            tuple(int(v) for v in cfg["num_heads"]), int(cfg["window_size"]))


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape."""
    fs, depths, heads, m = architecture(cfg)
    cin, cout = int(cfg["in_channels"]), int(cfg["out_channels"])
    s: Dict[str, Tuple[int, ...]] = {
        "patch_embed.weight": (fs, cin, 2, 2, 2), "patch_embed.bias": (fs,)}
    for i in range(4):
        c = fs * 2 ** i
        for j in range(depths[i]):
            pre = f"stages.{i}.blocks.{j}"
            for ln in ("norm1", "norm2"):
                s[f"{pre}.{ln}.weight"] = (c,)
                s[f"{pre}.{ln}.bias"] = (c,)
            s[f"{pre}.attn.relative_position_bias_table"] = \
                ((2 * m - 1) ** 3, heads[i])
            s[f"{pre}.attn.qkv.weight"] = (3 * c, c)
            s[f"{pre}.attn.qkv.bias"] = (3 * c,)
            s[f"{pre}.attn.proj.weight"] = (c, c)
            s[f"{pre}.attn.proj.bias"] = (c,)
            s[f"{pre}.mlp.fc1.weight"] = (4 * c, c)
            s[f"{pre}.mlp.fc1.bias"] = (4 * c,)
            s[f"{pre}.mlp.fc2.weight"] = (c, 4 * c)
            s[f"{pre}.mlp.fc2.bias"] = (c,)
        s[f"stages.{i}.merge.norm.weight"] = (8 * c,)
        s[f"stages.{i}.merge.norm.bias"] = (8 * c,)
        s[f"stages.{i}.merge.reduction.weight"] = (2 * c, 8 * c)

    def res(pre, a, b):
        s[f"{pre}.conv1.weight"] = (b, a, 3, 3, 3)
        s[f"{pre}.conv2.weight"] = (b, b, 3, 3, 3)
        if a != b:
            s[f"{pre}.conv3.weight"] = (b, a, 1, 1, 1)

    for k, (a, b) in enumerate([(cin, fs), (fs, fs), (2 * fs, 2 * fs),
                                (4 * fs, 4 * fs), (16 * fs, 16 * fs)]):
        res(f"encoders.{k}", a, b)
    for k, (a, b) in enumerate([(16 * fs, 8 * fs), (8 * fs, 4 * fs),
                                (4 * fs, 2 * fs), (2 * fs, fs), (fs, fs)]):
        s[f"decoders.{k}.up.weight"] = (a, b, 2, 2, 2)
        res(f"decoders.{k}.block", 2 * b, b)
    s["head.weight"] = (cout, fs, 1, 1, 1)
    s["head.bias"] = (cout,)
    return s


def _bias_rows(win, m: int, device) -> torch.Tensor:
    """(n, n) table rows of a window's token pairs."""
    coords = list(itertools.product(*[range(w) for w in win]))
    c = torch.tensor(coords, device=device)
    d = c[:, None, :] - c[None, :, :] + (m - 1)
    side = 2 * m - 1
    return (d[..., 0] * side + d[..., 1]) * side + d[..., 2]


def _regions(dims, win, shift, device) -> torch.Tensor:
    """Region id of every voxel of the rolled, padded volume."""
    img = torch.zeros(dims, device=device)
    cnt = 0
    axes = []
    for p, w, s in zip(dims, win, shift):
        axes.append([slice(0, p - w), slice(p - w, p - s), slice(p - s, p)]
                    if s else [slice(0, p)])
    for sl in itertools.product(*axes):
        img[sl] = cnt
        cnt += 1
    return img


def _windows(t: torch.Tensor, win) -> torch.Tensor:
    b, d, h, w, c = t.shape
    t = t.reshape(b, d // win[0], win[0], h // win[1], win[1], w // win[2],
                  win[2], c)
    return t.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, -1, win[0] * win[1] * win[2], c)


def _unwindows(t: torch.Tensor, win, dims) -> torch.Tensor:
    b, c = t.shape[0], t.shape[-1]
    d, h, w = dims
    t = t.reshape(b, d // win[0], h // win[1], w // win[2], win[0], win[1],
                  win[2], c)
    return t.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def _block(p, pre, t, heads, m, shifted, q, use_bias):
    b, d_, h_, w_, c = t.shape
    dims = (d_, h_, w_)
    win = [min(e, m) for e in dims]
    sh = [m // 2 if shifted and e > m else 0 for e in dims]
    x = F.layer_norm(t, (c,), p[pre + ".norm1.weight"],
                     p[pre + ".norm1.bias"], LN_EPS)
    pad = [(-e) % w for e, w in zip(dims, win)]
    x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    padded = tuple(e + v for e, v in zip(dims, pad))
    if any(sh):
        x = torch.roll(x, shifts=[-v for v in sh], dims=(1, 2, 3))
    xw = _windows(x, win)                                   # (B, nW, n, C)
    nw, n = xw.shape[1], xw.shape[2]
    hd = c // heads
    qkv = F.linear(q(xw), q(p[pre + ".attn.qkv.weight"]),
                   p[pre + ".attn.qkv.bias"])
    qkv = qkv.reshape(b, nw, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    qq, kk, vv = qkv[0] * hd ** -0.5, qkv[1], qkv[2]        # (B, nW, h, n, d)
    s = q(qq) @ q(kk).transpose(-1, -2)                      # (B, nW, h, n, n)
    if use_bias:
        rows = _bias_rows(win, m, t.device)
        table = p[pre + ".attn.relative_position_bias_table"]
        s = s + table[rows].permute(2, 0, 1)
    if any(sh):
        reg = _windows(_regions(padded, win, sh, t.device)[None, ..., None],
                       win)[0, ..., 0]                       # (nW, n)
        mask = torch.where(reg[:, None, :] != reg[:, :, None], MASK, 0.0)
        s = s + mask[:, None]
    a = torch.softmax(s, dim=-1)
    o = (q(a) @ q(vv)).transpose(2, 3).reshape(b, nw, n, c)
    o = F.linear(q(o), q(p[pre + ".attn.proj.weight"]),
                 p[pre + ".attn.proj.bias"])
    o = _unwindows(o, win, padded)
    if any(sh):
        o = torch.roll(o, shifts=sh, dims=(1, 2, 3))
    t = t + o[:, :d_, :h_, :w_]
    x = F.layer_norm(t, (c,), p[pre + ".norm2.weight"],
                     p[pre + ".norm2.bias"], LN_EPS)
    x = F.gelu(F.linear(q(x), q(p[pre + ".mlp.fc1.weight"]),
                        p[pre + ".mlp.fc1.bias"]))
    x = F.linear(q(x), q(p[pre + ".mlp.fc2.weight"]), p[pre + ".mlp.fc2.bias"])
    return t + x


def _merge(p, pre, t, q):
    cells = [t[:, i::2, j::2, k::2] for i, j, k in
             itertools.product(range(2), repeat=3)]
    x = torch.cat(cells, dim=-1)
    x = F.layer_norm(x, (x.shape[-1],), p[pre + ".norm.weight"],
                     p[pre + ".norm.bias"], LN_EPS)
    return F.linear(q(x), q(p[pre + ".reduction.weight"]))


def _instance_norm(h: torch.Tensor) -> torch.Tensor:
    """InstanceNorm without affine parameters, written out:
    ``F.instance_norm`` refuses a single voxel, which a small input's
    deepest hidden state has (it normalizes to 0)."""
    mean = h.mean(dim=(2, 3, 4), keepdim=True)
    var = ((h - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    return (h - mean) / torch.sqrt(var + IN_EPS)


def _res(p, pre, x, q):
    h = F.conv3d(q(x), q(p[pre + ".conv1.weight"]), padding=1)
    h = F.leaky_relu(_instance_norm(h), SLOPE)
    h = _instance_norm(F.conv3d(q(h), q(p[pre + ".conv2.weight"]),
                                padding=1))
    if pre + ".conv3.weight" in p:
        x = _instance_norm(F.conv3d(q(x), q(p[pre + ".conv3.weight"])))
    return F.leaky_relu(h + x, SLOPE)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
            fp8: bool = False, shift: bool = True,
            bias: bool = True) -> torch.Tensor:
    q = _q8 if fp8 else (lambda v: v)
    _, depths, heads, m = architecture(cfg)
    t = F.conv3d(q(x), q(p["patch_embed.weight"]), p["patch_embed.bias"],
                 stride=2).permute(0, 2, 3, 4, 1)
    hidden = [t]
    for i in range(4):
        for j in range(depths[i]):
            t = _block(p, f"stages.{i}.blocks.{j}", t, heads[i], m,
                       shift and j % 2 == 1, q, bias)
        t = _merge(p, f"stages.{i}.merge", t, q)
        hidden.append(t)
    hs = [F.layer_norm(v, (v.shape[-1],), eps=LN_EPS).permute(0, 4, 1, 2, 3)
          for v in hidden]
    enc = [_res(p, f"encoders.{k}", v, q)
           for k, v in enumerate([x] + hs[:3])]
    h = _res(p, "encoders.4", hs[4], q)
    for k, skip in enumerate([hs[3]] + enc[::-1]):
        up = F.conv_transpose3d(q(h), q(p[f"decoders.{k}.up.weight"]),
                                stride=2)
        h = _res(p, f"decoders.{k}.block", torch.cat([up, skip], dim=1), q)
    h = F.conv3d(q(h), q(p["head.weight"]), p["head.bias"])
    return torch.sigmoid(h)


def loss_and_grads(p, x, y, micro: int, cfg, **kw):
    """The batch loss (float) and its gradient, micro-batch by micro-batch
    (``kw``: ``forward``'s ``fp8``, ``shift``, ``bias``)."""
    n = float(y.numel())
    sums = torch.zeros(4, dtype=torch.float64, device=x.device)
    with torch.no_grad():
        for i in range(0, x.shape[0], micro):
            pred = forward(p, x[i:i + micro], cfg, **kw)
            sums += torch.stack([s.to(torch.float64) for s in
                                 _sums(pred, y[i:i + micro].float())])
    bce, pt, pp, tt = (float(v) for v in sums)
    d = pp + tt + 1.0
    loss = bce / n + 1.0 - (2.0 * pt + 1.0) / d
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    for i in range(0, x.shape[0], micro):
        pred = forward(leaves, x[i:i + micro], cfg, **kw)
        b, s_pt, s_pp, _ = _sums(pred, y[i:i + micro].float())
        part = b / n - (2.0 / d) * s_pt + ((2.0 * pt + 1.0) / (d * d)) * s_pp
        gs = torch.autograd.grad(part, list(leaves.values()),
                                 allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                grads[k] += g
    return loss, grads


def adamw_step(p, mu, nu, g, count: int, lr: float, wd: float):
    bc1 = 1.0 - B1 ** count
    bc2 = 1.0 - B2 ** count
    out_p, out_mu, out_nu = {}, {}, {}
    for k in p:
        out_mu[k] = (1 - B1) * g[k] + B1 * mu[k]
        out_nu[k] = (1 - B2) * g[k] * g[k] + B2 * nu[k]
        d = (out_mu[k] / bc1) / (torch.sqrt(out_nu[k] / bc2) + EPS) \
            + wd * p[k]
        out_p[k] = p[k] - lr * d
    return out_p, out_mu, out_nu


def train_steps(p0: Dict[str, torch.Tensor], batches: List[Tuple],
                micro: int, cfg, **kw):
    """``len(batches)`` steps from ``p0`` at the configuration's AdamW:
    (losses, the first step's gradient, the parameters after the last)."""
    opt = cfg["optimizer"]
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = {k: v.detach().float().clone() for k, v in p0.items()}
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, g1 = [], None
        for i, (x, y) in enumerate(batches):
            loss, g = loss_and_grads(p, x, y, micro, cfg, **kw)
            losses.append(loss)
            if g1 is None:
                g1 = g
            p, mu, nu = adamw_step(p, mu, nu, g, i + 1,
                                   float(opt["lr"]),
                                   float(opt["weight_decay"]))
        return losses, g1, p
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


#: the leaves ``attn_grad_err`` compares: each block's bias table and its
#: q/k/v and output projections
ATTN_LEAVES = (".attn.relative_position_bias_table", ".attn.qkv.weight",
               ".attn.proj.weight")


def epsilon_only(grad: torch.Tensor) -> bool:
    """A convolution kernel with one weight per output channel (the 1x1x1
    kernel on the single input channel of the decoder's first residual
    block): the InstanceNorm without affine parameters after it divides
    each channel's weight out, so the loss reaches the weight through the
    norm's epsilon alone and its gradient is a difference of nearly equal
    terms, round-off in any precision."""
    return grad.dim() == 5 and grad[0].numel() == 1


def swin_compare(prog_losses, prog_g1, prog_p0, prog_p3, ref_losses,
                 ref_g1, ref_p3) -> Dict[str, float]:
    """``refs/unet.py``'s three gaps over every leaf but the
    :func:`epsilon_only` ones, and ``attn_grad_err``: over the attention
    leaves, the largest ``||g_p - g_r|| / ||g_r||`` of the first gradient,
    whole vectors compared (the norms alone do not see a window shifted
    elsewhere or a bias left out)."""
    keep = [k for k in ref_g1 if not epsilon_only(ref_g1[k])]

    def sub(tree):
        return {k: tree[k] for k in keep}

    out = compare(prog_losses, sub(prog_g1), sub(prog_p0), sub(prog_p3),
                  ref_losses, sub(ref_g1), sub(ref_p3))
    errs = []
    for k in ref_g1:
        if k.endswith(ATTN_LEAVES):
            r = ref_g1[k].double()
            d = prog_g1[k].double() - r
            errs.append(float(d.norm() / r.norm().clamp(min=1e-300)))
    out["attn_grad_err"] = max(errs)
    return out
