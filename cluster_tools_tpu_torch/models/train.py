"""Training of the U-Net: the port of cluster_tools_tpu/models/train.py.

* loss = balanced BCE + soft Dice on the affinity channels, in float32
  (:func:`affinity_loss`);
* optimizer = AdamW with optax's update (``optax.adamw``: b1 0.9, b2
  0.999, eps 1e-8, eps_root 0, the decay ``weight_decay * p`` added to the
  Adam direction, no mask), written on tensors (:class:`AdamW`);
* :func:`init_state` draws flax's initial distributions (LeCun-normal
  kernels, truncated at two standard deviations; zero biases; GroupNorm
  scale 1) from an explicit ``torch.Generator``; the gradient is autograd's;
* :func:`shard_train_step` runs the step over a ``data`` x ``space`` x
  ``model`` mesh (:mod:`..parallel.mesh`) in one driver process: the batch
  split over ``data``, z over ``space`` (a one-plane halo from the
  neighbouring slabs before every 3x3x3 convolution, zeros at the
  volume's ends), the convolutions' output channels over ``model``
  (:func:`~..parallel.mesh.torch_param_sharding`, the activation gathered
  back after each).  GroupNorm's moments and the loss's sums are reduced
  over the shards before they are used, and every exchange is a
  differentiable copy or sum, so the backward pass of the assembled loss
  is the unsharded step's.  Replicated parameters live once, as master
  tensors that every step sends to the shards: autograd sums their
  gradients.

Tensors are channels-first, as the port's ``UNet3D`` takes them: ``x`` is
``(B, C_in, D, H, W)``, the targets ``(B, C_out, D, H, W)``.  Parameters
and both Adam moments are dicts keyed by the ``UNet3D`` ``state_dict``
names; the JAX package's train state carries over through
``models/checkpoint.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import mesh as mesh_lib
from ..parallel.mesh import Mesh, Placement, send
from ..parallel.stencil import halo_exchange
from .unet import UNet3D, create_unet, no_tf32

#: the loss clips its predictions to [CLIP, 1 - CLIP]
CLIP = 1e-6
#: flax GroupNorm's epsilon
GN_EPS = 1e-6


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _clip(pred: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(pred, CLIP, 1 - CLIP)`` as JAX forms it (a max, then a
    min): at an exact tie the gradient is split in half, as JAX's is."""
    lo = pred.new_tensor(CLIP)
    hi = pred.new_tensor(1.0 - CLIP)
    return torch.minimum(torch.maximum(pred, lo), hi)


def _loss_sums(pred: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> List[Any]:
    """The additive parts of :func:`affinity_loss` over one piece of the
    data: the BCE sum, its element count (the mask's sum where masked),
    and the Dice sums of ``pred * target``, ``pred ** 2``, ``target ** 2``."""
    pred = _clip(pred.to(torch.float32))
    target = target.to(torch.float32)
    bce = -(target * torch.log(pred)
            + (1.0 - target) * torch.log(1.0 - pred))
    if mask is not None:
        mask = mask.to(torch.float32)
        bce = bce * mask
        count: Any = mask.sum()
    else:
        count = float(bce.numel())
    return [bce.sum(), count, (pred * target).sum(), (pred ** 2).sum(),
            (target ** 2).sum()]


def _loss_from_sums(bce, count, inter, p2, t2, masked: bool
                    ) -> torch.Tensor:
    denom = torch.clamp(count, min=1.0) if masked else count
    dice = 1.0 - (2.0 * inter + 1.0) / (p2 + t2 + 1.0)
    return bce / denom + dice


def affinity_loss(pred: torch.Tensor, target: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Balanced BCE + soft Dice on affinity channels (float32 math): the
    BCE averaged over the elements (or the mask's sum), the Dice ratio of
    sums over the whole batch."""
    return _loss_from_sums(*_loss_sums(pred, target, mask),
                           masked=mask is not None)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and both moments."""
    count: int
    mu: Dict[Any, torch.Tensor]
    nu: Dict[Any, torch.Tensor]


class AdamW:
    """``optax.adamw`` on dicts of tensors, in optax's order of operations:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, both
    bias-corrected by ``1 - b**count`` (float32), the direction ``mu_hat /
    (sqrt(nu_hat + eps_root) + eps)`` plus ``weight_decay * p``, scaled by
    ``-lr``.  (``torch.optim.AdamW`` decays multiplicatively before the
    step and defaults to another decay.)"""

    B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, lr: float = 1e-3, weight_decay: float = 1e-5):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)

    def config(self) -> Dict[str, Any]:
        return {"name": "adamw", "lr": self.lr,
                "weight_decay": self.weight_decay, "b1": self.B1,
                "b2": self.B2, "eps": self.EPS, "eps_root": self.EPS_ROOT}

    def init(self, params: Dict[Any, torch.Tensor]) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(p)
                             for k, p in params.items()},
                         {k: torch.zeros_like(p)
                          for k, p in params.items()})

    def update(self, grads: Dict[Any, torch.Tensor], state: AdamState,
               params: Dict[Any, torch.Tensor]
               ) -> Tuple[Dict[Any, torch.Tensor], AdamState]:
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.B1) ** f32(count))
        bc2 = float(f32(1) - f32(self.B2) ** f32(count))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            g = g.detach()
            mu[k] = (1 - self.B1) * g + self.B1 * state.mu[k]
            nu[k] = (1 - self.B2) * (g * g) + self.B2 * state.nu[k]
            direction = (mu[k] / bc1) / (
                torch.sqrt(nu[k] / bc2 + self.EPS_ROOT) + self.EPS)
            direction = direction + self.weight_decay * params[k].detach()
            updates[k] = (-self.lr) * direction
        return updates, AdamState(count, mu, nu)


def apply_updates(params: Dict[Any, torch.Tensor],
                  updates: Dict[Any, torch.Tensor]
                  ) -> Dict[Any, torch.Tensor]:
    return {k: (p.detach() + updates[k]).to(p.dtype)
            for k, p in params.items()}


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-5) -> AdamW:
    return AdamW(lr, weight_decay=weight_decay)


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------

class TrainState:
    """Parameters, optimizer state and step count.

    Unsharded, ``params`` and the moments map ``state_dict`` names to
    tensors.  Sharded (``mesh`` set), each maps a name to the list of its
    per-shard tensors (one per mesh position, as :func:`~..parallel.mesh.
    shard` cuts them by ``placements[name]``).  ``config`` holds the
    U-Net's ``create_unet`` kwargs, ``optimizer`` the AdamW settings."""

    def __init__(self, params, opt_state: AdamState, step: int,
                 config: Optional[Dict[str, Any]] = None,
                 optimizer: Optional[Dict[str, Any]] = None,
                 mesh: Optional[Mesh] = None,
                 placements: Optional[Dict[str, Placement]] = None):
        self.params = params
        self.opt_state = opt_state
        self.step = int(step)
        self.config = dict(config or {})
        self.optimizer = dict(optimizer or make_optimizer().config())
        self.mesh = mesh
        self.placements = placements

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def replace(self, **kw) -> "TrainState":
        fields = {"params": self.params, "opt_state": self.opt_state,
                  "step": self.step, "config": self.config,
                  "optimizer": self.optimizer, "mesh": self.mesh,
                  "placements": self.placements}
        fields.update(kw)
        return TrainState(**fields)


def model_config(model: UNet3D) -> Dict[str, Any]:
    """The ``create_unet`` kwargs of a U-Net (``model.json``'s keys, with
    the input channels)."""
    return {"out_channels": int(model.head.out_channels),
            "features": list(model.features),
            "anisotropic": tuple(model.scale_factors[0]) == (1, 2, 2),
            "in_channels": int(model.encoders[0].convs[0].in_channels)}


def init_params(model: UNet3D, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """flax's initial parameters for ``model``, drawn on the CPU from
    ``generator`` (default: seed 0): every convolution and up-convolution
    kernel LeCun-normal (a normal truncated at +-2, scaled to variance
    1 / fan_in, fan_in = in_channels * kd * kh * kw), biases 0, GroupNorm
    scales 1."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    params = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            w = mod.weight
            c_in = w.shape[1] if isinstance(mod, torch.nn.Conv3d) \
                else w.shape[0]
            fan_in = c_in * int(np.prod(w.shape[2:]))
            # flax's variance_scaling divides by the truncated normal's
            # standard deviation, so the draws have variance 1 / fan_in
            std = float(np.sqrt(1.0 / fan_in) / .87962566103423978)
            t = torch.empty(w.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            params[pre + "weight"] = t * std
            params[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, torch.nn.GroupNorm):
            params[pre + "weight"] = torch.ones(mod.weight.shape)
            params[pre + "bias"] = torch.zeros(mod.bias.shape)
    return {k: params[k] for k in model.state_dict()}


def init_state(model: UNet3D, input_shape: Sequence[int],
               generator: Optional[torch.Generator] = None,
               lr: float = 1e-3, device: str = "cuda") -> TrainState:
    """A fresh train state for ``model`` on ``device`` (the card unless
    the caller asks for the CPU); ``input_shape`` is ``(B, C_in, D, H,
    W)`` and must match the model's input channels."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    cfg = model_config(model)
    if len(input_shape) != 5 or int(input_shape[1]) != cfg["in_channels"]:
        raise ValueError(f"input shape {tuple(input_shape)} is not (B, "
                         f"{cfg['in_channels']}, D, H, W)")
    params = {k: v.to(dev) for k, v in init_params(model, generator).items()}
    opt = make_optimizer(lr)
    return TrainState(params, opt.init(params), 0, config=cfg,
                      optimizer=opt.config())


def loss_and_grads(model: UNet3D, params: Dict[str, torch.Tensor],
                   x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``affinity_loss(model(x), y)`` and its gradient with respect to
    every parameter (``jax.value_and_grad``), float32 convolutions without
    TF32 in both passes."""
    names = list(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with no_tf32():
        pred = torch.func.functional_call(model, leaves, (x,))
        loss = affinity_loss(pred, y)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def _optimizer_of(state: TrainState, lr: Optional[float]) -> AdamW:
    return AdamW(state.optimizer["lr"] if lr is None else lr,
                 state.optimizer["weight_decay"])


def make_train_step(model: UNet3D, lr: float = 1e-3):
    """The train-step function ``(state, x, y) -> (state, loss)``; the
    state it returns is new, the one it was given stays valid."""

    def step(state: TrainState, x, y):
        opt = _optimizer_of(state, lr)
        loss, grads = loss_and_grads(model, state.params, x, y)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        return state.replace(params=params, opt_state=opt_state,
                             step=state.step + 1), loss

    return step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

#: a channels-first ``(B, C, D, H, W)`` batch: B over ``data``, D over
#: ``space``
BATCH_PLACEMENT = Placement(("data", None, "space"))


def _masters(mesh: Mesh, placement: Placement, ndim: int) -> List[int]:
    """For every mesh position, the first position holding the same piece
    of a tensor placed by ``placement`` (its master)."""
    first: Dict[tuple, int] = {}
    out = []
    for p, coord in enumerate(mesh_lib._coords(mesh)):
        key = tuple(mesh_lib._split_index(mesh, coord,
                                          placement.axes_of(d))[0]
                    for d in range(ndim))
        out.append(first.setdefault(key, p))
    return out


class _ShardedUNet:
    """The U-Net's forward pass over the shards of a (data, space, model)
    mesh, layer by layer on all shards, mirroring ``UNet3D._forward``'s
    casts and op order."""

    def __init__(self, model: UNet3D, mesh: Mesh,
                 placements: Dict[str, Placement]):
        self.model = model
        self.mesh = mesh
        self.placements = placements
        names = mesh.axis_names
        if set(names) != {"data", "space", "model"}:
            raise ValueError(f"mesh axes {names}: need data, space, model")
        shape = mesh.devices.shape
        pos = np.arange(mesh.size).reshape(shape)

        def rings(axis):
            k = names.index(axis)
            return [list(r) for r in
                    np.moveaxis(pos, k, -1).reshape(-1, shape[k])]

        self.space_rings = rings("space")
        self.model_rings = rings("model")
        self.coords = mesh_lib._coords(mesh)
        self.model_index = [c[names.index("model")] for c in self.coords]
        self.model_size = mesh.shape["model"]
        self.devices = mesh.device_list

    def split(self, name: str) -> bool:
        return "model" in self.placements[name].spec

    # -- exchanges (differentiable) -------------------------------------

    def ring_sum(self, values: List[Any], ring: List[int]) -> List[Any]:
        """The sum of ``values`` over a ring, on every member's device."""
        dev0 = self.devices[ring[0]]
        if not isinstance(values[ring[0]], torch.Tensor):
            total = sum(values[i] for i in ring)
            return [total] * len(ring)
        total = values[ring[0]]
        for i in ring[1:]:
            total = total + send(values[i], dev0)
        return [total if i == ring[0] else send(total, self.devices[i])
                for i in ring]

    def space_sum(self, values: List[Any]) -> List[Any]:
        """Every shard's value summed over its ``space`` ring."""
        out: List[Any] = [None] * len(values)
        for ring in self.space_rings:
            for i, t in zip(ring, self.ring_sum(values, ring)):
                out[i] = t
        return out

    def gather_model(self, acts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's channel pieces joined over ``model``."""
        out: List[torch.Tensor] = [None] * len(acts)  # type: ignore
        for ring in self.model_rings:
            for i in ring:
                out[i] = torch.cat([acts[j] if j == i else
                                    send(acts[j], acts[i].device)
                                    for j in ring], dim=1)
        return out

    # -- layers -----------------------------------------------------------

    def conv3(self, acts, prefix: str, P, dt):
        """A 3x3x3 convolution with zero SAME padding: z from a one-plane
        halo of the neighbouring slabs, y and x padded locally."""
        out: List[torch.Tensor] = [None] * len(acts)  # type: ignore
        for ring in self.space_rings:
            grown = halo_exchange([acts[i] for i in ring], 1, axis=2,
                                  fill=0)
            for i, g in zip(ring, grown):
                w = P[prefix + ".weight"][i]
                b = P[prefix + ".bias"][i]
                out[i] = F.conv3d(g.to(dt), w.to(dt), None,
                                  padding=(0, 1, 1)) \
                    + b.to(dt).view(1, -1, 1, 1, 1)
        return out

    def group_norm(self, acts, prefix: str, P, num_groups: int,
                   channels: int):
        """GroupNorm in float32 with each (sample, group)'s mean and
        variance (two passes) summed over the z-slabs."""
        per_group = channels // num_groups
        xs = [a.to(torch.float32) for a in acts]
        grouped = [x.reshape(x.shape[0], x.shape[1] // per_group, -1)
                   for x in xs]
        counts = self.space_sum([g.shape[-1] for g in grouped])
        sums = self.space_sum([g.sum(-1) for g in grouped])
        dev = [g - (s / c)[..., None]
               for g, s, c in zip(grouped, sums, counts)]
        sq = self.space_sum([(d * d).sum(-1) for d in dev])
        out = []
        for i, (x, d) in enumerate(zip(xs, dev)):
            rstd = torch.rsqrt(sq[i] / counts[i] + GN_EPS)
            y = (d * rstd[..., None]).reshape(x.shape)
            w = P[prefix + ".weight"][i].view(1, -1, 1, 1, 1)
            b = P[prefix + ".bias"][i].view(1, -1, 1, 1, 1)
            out.append(y * w + b)
        return out

    def block(self, acts, prefix: str, channels: int, P, dt):
        for j in range(2):
            acts = self.conv3(acts, f"{prefix}.convs.{j}", P, dt)
            acts = self.group_norm(acts, f"{prefix}.norms.{j}", P,
                                   min(8, channels), channels)
            acts = [F.gelu(a, approximate="tanh").to(dt) for a in acts]
            if self.split(f"{prefix}.convs.{j}.weight"):
                acts = self.gather_model(acts)
        return acts

    def forward(self, xs: List[torch.Tensor], P) -> List[torch.Tensor]:
        """The prediction's pieces: per shard its batch piece and z-slab,
        and its channel piece where the head is split over ``model``."""
        m = self.model
        dt = m.dtype
        feats = m.features
        with no_tf32():
            acts = [x.to(dt) for x in xs]
            skips = []
            for lv, s in enumerate(m.scale_factors):
                acts = self.block(acts, f"encoders.{lv}", feats[lv], P, dt)
                skips.append(acts)
                acts = [F.max_pool3d(a, kernel_size=s, stride=s)
                        for a in acts]
            acts = self.block(acts, "bottleneck", feats[-1], P, dt)
            for j, lv in enumerate(reversed(range(len(feats) - 1))):
                s = m.scale_factors[lv]
                name = f"upsamplers.{j}"
                acts = [F.conv_transpose3d(
                    a.to(dt), P[name + ".weight"][i].to(dt), None,
                    stride=s) + P[name + ".bias"][i].to(dt).view(
                        1, -1, 1, 1, 1) for i, a in enumerate(acts)]
                if self.split(name + ".weight"):
                    acts = self.gather_model(acts)
                acts = self.block([torch.cat([a, sk], dim=1) for a, sk in
                                   zip(acts, skips.pop())],
                                  f"decoders.{j}", feats[lv], P, dt)
            out = []
            for i, a in enumerate(acts):
                y = F.conv3d(a.to(torch.float32),
                             P["head.weight"][i].to(torch.float32), None) \
                    + P["head.bias"][i].view(1, -1, 1, 1, 1)
                out.append(torch.sigmoid(y) if m.final_activation ==
                           "sigmoid" else y)
        return out

    def loss(self, preds, ys) -> torch.Tensor:
        """The global :func:`affinity_loss`: every shard's sums (each
        element counted once: the model pieces of a split head, else
        model position 0) summed on the first shard's device."""
        head_split = self.split("head.weight")
        n_out = self.model.head.out_channels
        parts = []
        for i, (p, y) in enumerate(zip(preds, ys)):
            mi = self.model_index[i]
            if head_split:
                y = y[:, mesh_lib._piece(n_out, mi, self.model_size)]
            elif mi != 0:
                continue
            parts.append(_loss_sums(p, y))
        dev0 = self.devices[0]
        totals = []
        for k in range(5):
            vals = [part[k] for part in parts]
            if isinstance(vals[0], torch.Tensor):
                t = vals[0].to(dev0)
                for v in vals[1:]:
                    t = t + send(v, dev0)
            else:
                t = sum(vals)
            totals.append(t)
        return _loss_from_sums(*totals, masked=False)


def _as_shards(t, mesh: Mesh, placement: Placement) -> List[torch.Tensor]:
    if isinstance(t, torch.Tensor):
        return mesh_lib.shard(t, mesh, placement)
    shards = list(t)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    return shards


def _check_batch(model: UNet3D, mesh: Mesh, xs: List[torch.Tensor]):
    """Every shard's z-slab a multiple of the U-Net's z divisor, every
    shard's batch piece non-empty."""
    div = model.min_divisor()
    for x in xs:
        if x.shape[0] == 0 or x.shape[2] % div[0] or x.shape[3] % div[1] \
                or x.shape[4] % div[2]:
            raise ValueError(
                f"shard of shape {tuple(x.shape)}: the batch must split "
                f"over data ({mesh.shape['data']}) and each z-slab, H and "
                f"W be multiples of {div}")


def sharded_loss_and_grads(model: UNet3D, state: TrainState, xs, ys
                           ) -> Tuple[torch.Tensor, Dict[Any, torch.Tensor]]:
    """The global loss of a sharded state's parameters on the batch
    shards, and its gradient with respect to every master tensor, keyed
    ``(name, position)``."""
    mesh, placements = state.mesh, state.placements
    net = _ShardedUNet(model, mesh, placements)
    P: Dict[str, List[torch.Tensor]] = {}
    masters: Dict[Any, torch.Tensor] = {}
    for name, shards in state.params.items():
        owner = _masters(mesh, placements[name], shards[0].ndim)
        row = []
        for p, (t, o) in enumerate(zip(shards, owner)):
            if o == p:
                leaf = t.detach().requires_grad_(True)
                masters[(name, p)] = leaf
                row.append(leaf)
            else:
                row.append(send(masters[(name, o)], t.device))
        P[name] = row
    _check_batch(model, mesh, xs)
    with no_tf32():
        loss = net.loss(net.forward(xs, P), ys)
        keys = list(masters)
        grads = torch.autograd.grad(loss, [masters[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


def make_sharded_step(model: UNet3D, lr: Optional[float] = None):
    """The train step of a sharded state: ``(state, x, y) -> (state,
    loss)``; ``x`` and ``y`` are global tensors (sharded by
    ``BATCH_PLACEMENT``) or lists of shards."""

    def step(state: TrainState, x, y):
        mesh = state.mesh
        xs = _as_shards(x, mesh, BATCH_PLACEMENT)
        ys = _as_shards(y, mesh, BATCH_PLACEMENT)
        loss, grads = sharded_loss_and_grads(model, state, xs, ys)
        params = {k: state.params[k[0]][k[1]] for k in grads}
        mu = {k: state.opt_state.mu[k[0]][k[1]] for k in grads}
        nu = {k: state.opt_state.nu[k[0]][k[1]] for k in grads}
        opt = _optimizer_of(state, lr)
        updates, adam = opt.update(grads, AdamState(
            state.opt_state.count, mu, nu), params)
        new = apply_updates(params, updates)

        def spread(values, tree):
            out = {}
            for name, shards in tree.items():
                owner = _masters(mesh, state.placements[name],
                                 shards[0].ndim)
                out[name] = [values[(name, p)] if o == p else
                             send(values[(name, o)], t.device)
                             for p, (t, o) in enumerate(zip(shards, owner))]
            return out

        opt_state = AdamState(adam.count, spread(adam.mu, state.params),
                              spread(adam.nu, state.params))
        return state.replace(params=spread(new, state.params),
                             opt_state=opt_state,
                             step=state.step + 1), loss

    return step


def place_state(state: TrainState, mesh: Mesh,
                placements: Dict[str, Placement]) -> TrainState:
    """An unsharded state cut onto the mesh (params and both moments by
    ``placements``)."""
    if state.sharded:
        raise ValueError("the state is already sharded")

    def cut(tree):
        return {k: mesh_lib.shard(v.detach(), mesh, placements[k])
                for k, v in tree.items()}

    return state.replace(
        params=cut(state.params),
        opt_state=AdamState(state.opt_state.count, cut(state.opt_state.mu),
                            cut(state.opt_state.nu)),
        mesh=mesh, placements=dict(placements))


def unplace_state(state: TrainState,
                  device: Optional[torch.device] = None) -> TrainState:
    """A sharded state joined back into whole tensors on ``device``
    (default: the first shard's)."""
    if not state.sharded:
        return state

    def join(tree):
        return {k: mesh_lib.unshard(v, state.mesh, state.placements[k],
                                    device=device)
                for k, v in tree.items()}

    return state.replace(
        params=join(state.params),
        opt_state=AdamState(state.opt_state.count, join(state.opt_state.mu),
                            join(state.opt_state.nu)),
        mesh=None, placements=None)


def shard_train_step(model: UNet3D, state: TrainState, mesh: Mesh,
                     lr: float = 1e-3):
    """The train step over a (data, space, model) mesh.

    Returns ``(step, sharded_state, BATCH_PLACEMENT)``: the parameters
    and both moments placed by :func:`~..parallel.mesh.
    torch_param_sharding`, and the placement of ``x`` and ``y`` (batch
    over ``data``, z over ``space``).  ``step(state, x, y)`` takes global
    tensors or their shards; the sharded step's loss and gradients are
    the unsharded step's up to the order of float sums."""
    placements = mesh_lib.torch_param_sharding(mesh, model)
    placed = place_state(state, mesh, placements)
    return make_sharded_step(model, lr), placed, BATCH_PLACEMENT


def train_step_for_mesh(n_devices: int = 8, features=(8, 16, 32),
                        shape=(2, 8, 32, 32), device: str = "cuda"):
    """``(step, state, (x_shards, y_shards))`` for an ``n_devices``-shard
    mesh (shards placed round-robin over ``device``'s devices): the
    isotropic 3-output U-Net of ``features``, every dim of ``shape``
    (B, D, H, W) rounded up so that the mesh axes and the U-Net's scales
    divide it, the JAX package's example batch (channels first)."""
    devices = mesh_lib.shard_devices(device, n_devices)
    mesh = mesh_lib.make_mesh(devices=devices)
    dp, sp = mesh.shape["data"], mesh.shape["space"]
    model = create_unet(out_channels=3, features=features,
                        anisotropic=False)
    div = model.min_divisor()

    def _round_up(v, m):
        return int(-(-v // m) * m)

    b = _round_up(max(shape[0], dp), dp)
    d = _round_up(max(shape[1], sp * div[0]), sp * div[0])
    h = _round_up(max(shape[2], div[1]), div[1])
    w = _round_up(max(shape[3], div[2]), div[2])
    x = np.random.RandomState(0).rand(b, d, h, w, 1).astype(np.float32)
    y = (np.random.RandomState(1).rand(b, d, h, w, 3) > 0.5).astype(
        np.float32)
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    y = torch.from_numpy(np.ascontiguousarray(np.moveaxis(y, -1, 1)))
    state = init_state(model, (1, 1, d, h, w), device=str(devices[0]))
    step, state, pl = shard_train_step(model, state, mesh)
    return step, state, (mesh_lib.shard(x, mesh, pl),
                         mesh_lib.shard(y, mesh, pl))


__all__ = ["AdamState", "AdamW", "BATCH_PLACEMENT", "TrainState",
           "affinity_loss", "apply_updates", "init_params", "init_state",
           "loss_and_grads", "make_optimizer", "make_sharded_step",
           "make_train_step", "model_config", "place_state",
           "shard_train_step", "sharded_loss_and_grads",
           "train_step_for_mesh", "unplace_state"]
