"""Plain reference of the affinity U-Net's training step, in float32.

The U-Net of the configuration (``features`` per level, pooled by
``scales``): per level two 3x3x3 convolutions (zero padding), each
followed by GroupNorm (min(8, C) groups, eps 1e-6) and the tanh
approximation of GELU; max pooling down; transposed convolutions (kernel =
stride = the level's factor) up, concatenated as ``[up, skip]``; a 1x1x1
head and a sigmoid.  The loss is the mean binary
cross-entropy (predictions clipped to [1e-6, 1 - 1e-6]) plus the soft Dice
``1 - (2 sum(p t) + 1) / (sum(p^2) + sum(t^2) + 1)`` over the whole batch;
the optimizer is AdamW in optax's form (b1 0.9, b2 0.999, eps 1e-8, the
decay ``wd * p`` added to the Adam direction, lr 1e-3, wd 1e-5).

Everything runs in float32 with TF32 off, in micro-batches: a first pass
without gradients takes the Dice sums of the whole batch, a second pass
back-propagates each micro-batch's exact share of the batch loss.
``fp8`` quantizes every convolution's input and kernel to float8 e4m3
(per-tensor scale, straight-through gradient): the control.  The
parameter names are those of the port's module (its state dict's keys),
so that both sides start from the same weights.  Nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

CLIP = 1e-6
B1, B2, EPS = 0.9, 0.999, 1e-8
LR, WD = 1e-3, 1e-5


def param_shapes(features: Sequence[int], scales, in_ch: int = 1,
                 out_ch: int = 12) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the module's order."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def block(pre, c_in, f):
        for i, ci in enumerate((c_in, f)):
            shapes[f"{pre}.convs.{i}.weight"] = (f, ci, 3, 3, 3)
            shapes[f"{pre}.convs.{i}.bias"] = (f,)
        for i in range(2):
            shapes[f"{pre}.norms.{i}.weight"] = (f,)
            shapes[f"{pre}.norms.{i}.bias"] = (f,)

    chans = (in_ch,) + tuple(features[:-2])
    for i, (c, f) in enumerate(zip(chans, features[:-1])):
        block(f"encoders.{i}", c, f)
    block("bottleneck", features[-2], features[-1])
    levels = list(reversed(range(len(features) - 1)))
    for j, lv in enumerate(levels):
        shapes[f"upsamplers.{j}.weight"] = (features[lv + 1], features[lv]) \
            + tuple(scales[lv])
        shapes[f"upsamplers.{j}.bias"] = (features[lv],)
    for j, lv in enumerate(levels):
        block(f"decoders.{j}", 2 * features[lv], features[lv])
    shapes["head.weight"] = (out_ch, features[0], 1, 1, 1)
    shapes["head.bias"] = (out_ch,)
    return shapes


def _q8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 quantize-dequantize, per-tensor scale, straight-through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, scales,
            fp8: bool = False) -> torch.Tensor:
    q = _q8 if fp8 else (lambda t: t)

    def block(pre, h):
        for i in range(2):
            h = F.conv3d(q(h), q(p[f"{pre}.convs.{i}.weight"]),
                         p[f"{pre}.convs.{i}.bias"], padding=1)
            c = h.shape[1]
            h = F.gelu(F.group_norm(h, min(8, c), p[f"{pre}.norms.{i}.weight"],
                                    p[f"{pre}.norms.{i}.bias"], eps=1e-6),
                       approximate="tanh")
        return h

    skips = []
    h = x
    for i, s in enumerate(scales):
        h = block(f"encoders.{i}", h)
        skips.append(h)
        h = F.max_pool3d(h, kernel_size=s, stride=s)
    h = block("bottleneck", h)
    for j, lv in enumerate(reversed(range(len(scales)))):
        s = scales[lv]
        h = F.conv_transpose3d(q(h), q(p[f"upsamplers.{j}.weight"]),
                               p[f"upsamplers.{j}.bias"], stride=s)
        h = block(f"decoders.{j}", torch.cat([h, skips.pop()], dim=1))
    h = F.conv3d(q(h), q(p["head.weight"]), p["head.bias"])
    return torch.sigmoid(h)


def _sums(pred: torch.Tensor, t: torch.Tensor):
    pc = torch.clamp(pred, CLIP, 1.0 - CLIP)
    bce = -(t * torch.log(pc) + (1.0 - t) * torch.log(1.0 - pc))
    return bce.sum(), (pc * t).sum(), (pc * pc).sum(), (t * t).sum()


def loss_and_grads(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor, micro: int, scales, fp8: bool = False):
    """The batch loss (float) and its gradient, micro-batch by micro-batch."""
    n = float(y.numel())
    sums = torch.zeros(4, dtype=torch.float64, device=x.device)
    with torch.no_grad():
        for i in range(0, x.shape[0], micro):
            pred = forward(p, x[i:i + micro], scales, fp8)
            sums += torch.stack([s.to(torch.float64) for s in
                                 _sums(pred, y[i:i + micro].float())])
    bce, pt, pp, tt = (float(v) for v in sums)
    d = pp + tt + 1.0
    loss = bce / n + 1.0 - (2.0 * pt + 1.0) / d
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    for i in range(0, x.shape[0], micro):
        pred = forward(leaves, x[i:i + micro], scales, fp8)
        b, s_pt, s_pp, _ = _sums(pred, y[i:i + micro].float())
        part = b / n - (2.0 / d) * s_pt + ((2.0 * pt + 1.0) / (d * d)) * s_pp
        gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
    return loss, grads


def adamw_step(p, mu, nu, g, count: int):
    bc1 = 1.0 - B1 ** count
    bc2 = 1.0 - B2 ** count
    out_p, out_mu, out_nu = {}, {}, {}
    for k in p:
        out_mu[k] = (1 - B1) * g[k] + B1 * mu[k]
        out_nu[k] = (1 - B2) * g[k] * g[k] + B2 * nu[k]
        d = (out_mu[k] / bc1) / (torch.sqrt(out_nu[k] / bc2) + EPS) \
            + WD * p[k]
        out_p[k] = p[k] - LR * d
    return out_p, out_mu, out_nu


def train_steps(p0: Dict[str, torch.Tensor], batches: List[Tuple], micro: int,
                scales, fp8: bool = False):
    """Three (or ``len(batches)``) steps from ``p0``: (losses, the first
    step's gradient, the parameters after the last step)."""
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
            loss, g = loss_and_grads(p, x, y, micro, scales, fp8)
            losses.append(loss)
            if g1 is None:
                g1 = g
            p, mu, nu = adamw_step(p, mu, nu, g, i + 1)
        return losses, g1, p
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


def compare(prog_losses, prog_g1, prog_p0, prog_p3, ref_losses, ref_g1,
            ref_p3) -> Dict[str, float]:
    """The training cell's numbers: the widest relative loss gap over the
    steps; per leaf, the gap of the program's first-gradient norm to the
    reference's and of the norms of the parameters' change over the steps,
    each over the larger of the reference leaf's norm and the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog_losses,
                                                        ref_losses))
    keys = list(ref_g1)
    gn_ref = torch.stack([ref_g1[k].norm() for k in keys]).double()
    gn_prog = torch.stack([prog_g1[k].float().norm() for k in keys]).double()
    med_g = gn_ref.median()
    grad_gap = float(((gn_prog - gn_ref).abs()
                      / torch.maximum(gn_ref, med_g)).max())
    dn_ref = torch.stack([(ref_p3[k] - prog_p0[k].float()).norm()
                          for k in keys]).double()
    dn_prog = torch.stack([(prog_p3[k].float() - prog_p0[k].float()).norm()
                           for k in keys]).double()
    moved = gn_ref >= 1e-3 * med_g
    med_d = dn_ref[moved].median()
    change_gap = float(((dn_prog - dn_ref).abs()
                        / torch.maximum(dn_ref, med_d))[moved].max())
    return {"loss_gap": float(loss_gap), "grad_gap": grad_gap,
            "change_gap": change_gap}
