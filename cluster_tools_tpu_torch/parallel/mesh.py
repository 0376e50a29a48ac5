"""Device meshes: the port of cluster_tools_tpu/parallel/mesh.py.

One driver process owns every device, as in the JAX package: a mesh is a
numpy object array of ``torch.device``s reshaped to its axis sizes, with
the axis names (``data``, ``space``, ``model`` for :func:`make_mesh`;
``blocks`` for the ``mesh`` execution target's rounds; one named axis for
the mesh-resident chain's z-slabs).  A sharded tensor is a Python list of
per-shard tensors, one per mesh position in C order, each on its shard's
device; :func:`shard` and :func:`unshard` split a tensor onto the shards
and join it back, following a :class:`Placement` (which tensor dim is
split over which mesh axes — the counterpart of a ``PartitionSpec``).

Which devices the shards use: the visible cards (``cuda:0`` ...), or the
CPU when the global config's ``"device"`` is ``"cpu"``; the global config
key ``"mesh_devices"`` (n > 0) places n shards round-robin over them —
the counterpart of XLA's forced host device count, so 8 shards run on
the CPU and 4 on one card.  :attr:`Mesh.physical_devices` counts the
distinct devices, so 4 shards on one card never read as 4 cards.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXES = ("data", "space", "model")

def visible_devices(device: str = "cuda") -> List[torch.device]:
    """The devices shards go to: every visible card for ``"cuda"``, the
    named card for ``"cuda:<i>"``, the CPU for ``"cpu"``.  Asking for the
    card on a host without one raises (core/device.py)."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_devices(device: str = "cuda",
                  mesh_devices: int = 0) -> List[torch.device]:
    """One device per shard: the visible devices, or ``mesh_devices``
    shards placed round-robin over them."""
    vis = visible_devices(device)
    n = int(mesh_devices or 0) or len(vis)
    return [vis[i % len(vis)] for i in range(n)]


def config_devices(global_config) -> List[torch.device]:
    """:func:`shard_devices` of a global config (``device`` and
    ``mesh_devices``)."""
    return shard_devices(global_config.get("device", "cuda"),
                         int(global_config.get("mesh_devices") or 0))


class Mesh:
    """A named grid of devices (``jax.sharding.Mesh``'s surface: ``shape``
    maps axis names to sizes, ``devices`` is the object array)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        """The shards' devices in C order over the axes."""
        return list(self.devices.reshape(-1))

    @property
    def physical_devices(self) -> int:
        return len({str(d) for d in self.device_list})

    def describe(self) -> Dict[str, object]:
        return {"axes": self.shape, "mesh_devices": self.size,
                "physical_devices": self.physical_devices}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {self.size} shards on "
                f"{self.physical_devices} devices)")


def _factorize(n: int) -> Tuple[int, int, int]:
    """Split n devices onto (data, space, model), preferring data, then
    space: 8 -> (2, 2, 2), 4 -> (2, 2, 1), 2 -> (2, 1, 1); the odd
    residue rides the data axis."""
    if n <= 1:
        return (1, 1, 1)
    axes = [1, 1, 1]
    i = 0
    m = n
    while m % 2 == 0:
        axes[i % 3] *= 2
        m //= 2
        i += 1
    axes[0] *= m
    return tuple(axes)


def _devices(devices, n: Optional[int]) -> List[torch.device]:
    devs = list(devices) if devices is not None else shard_devices()
    n = n or len(devs)
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return devs[:n]


def make_mesh(n_devices: Optional[int] = None,
              axis_sizes: Optional[Tuple[int, int, int]] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The framework mesh (``data``, ``space``, ``model``) over the first
    ``n_devices`` shard devices (default :func:`shard_devices`)."""
    devs = _devices(devices, n_devices)
    sizes = axis_sizes or _factorize(len(devs))
    if int(np.prod(sizes)) != len(devs):
        raise ValueError(f"axis sizes {sizes} do not multiply to "
                         f"{len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), AXES)


def blocks_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """1-d mesh with the ``blocks`` axis: the ``mesh`` execution target's
    rounds put one outer block on each shard."""
    return single_axis_mesh("blocks", n_devices or len(
        _devices(devices, None)), devices=devices)


def single_axis_mesh(axis: str, n_shards: int,
                     n_devices: Optional[int] = None,
                     devices: Optional[Sequence[torch.device]] = None
                     ) -> Mesh:
    """Mesh with one named axis over the first ``n_shards`` shard devices
    (the mesh-resident chain's ``shard`` axis: one z-slab per shard).
    More shards than shard devices (counted by ``mesh_devices``) raise."""
    devs = list(devices) if devices is not None else shard_devices()
    n = n_devices or len(devs)
    if n_shards > n:
        raise ValueError(f"need {n_shards} devices, have {n}")
    arr = np.empty(n_shards, dtype=object)
    arr[:] = devs[:n_shards]
    return Mesh(arr, (axis,))


def axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along ``axis`` at position 0 of every other axis (one
    ring of the axis)."""
    k = mesh.axis_names.index(axis)
    return list(np.moveaxis(mesh.devices, k, 0).reshape(
        mesh.devices.shape[k], -1)[:, 0])


# ---------------------------------------------------------------------------
# placements: which tensor dim is split over which mesh axes
# ---------------------------------------------------------------------------

AxisSpec = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class Placement:
    """Per tensor dim, ``None`` (whole on every shard) or the mesh axis
    (or tuple of axes) it is split over; dims past ``spec`` are whole.
    An empty spec replicates the tensor."""
    spec: Tuple[AxisSpec, ...] = ()

    def axes_of(self, dim: int) -> Tuple[str, ...]:
        a = self.spec[dim] if dim < len(self.spec) else None
        if a is None:
            return ()
        return (a,) if isinstance(a, str) else tuple(a)


def volume_sharding(mesh: Mesh, ndim: int = 3, batch: bool = False,
                    channels_last: bool = True) -> Placement:
    """A (B,) D, H, W (, C) volume: batch over ``data``, z over
    ``space``."""
    spec: list = []
    if batch:
        spec.append("data")
    spec.append("space")
    spec.extend([None] * (ndim - 1))
    if channels_last:
        spec.append(None)
    return Placement(tuple(spec))


def replicated(mesh: Mesh) -> Placement:
    return Placement(())


def param_sharding(mesh: Mesh, params: Dict[str, torch.Tensor]
                   ) -> Dict[str, Placement]:
    """Tensor-parallel layout of a state dict: the LAST dim of every
    tensor of rank >= 2 split over ``model`` when it divides the axis,
    everything else replicated (the JAX package's channel split)."""
    model_size = mesh.shape.get("model", 1)

    def leaf(x):
        if (model_size > 1 and x.ndim >= 2
                and x.shape[-1] % model_size == 0):
            return Placement(tuple([None] * (x.ndim - 1) + ["model"]))
        return Placement(())

    return {k: leaf(v) for k, v in params.items()}


def torch_param_sharding(mesh: Mesh, module: torch.nn.Module
                         ) -> Dict[str, Placement]:
    """Tensor-parallel layout of a torch module's parameters, by output
    channel: a ``Conv3d`` weight ``(out, in, kd, kh, kw)`` splits dim 0
    over ``model``, a ``ConvTranspose3d`` weight ``(in, out, kd, kh, kw)``
    dim 1, each with its bias, where the axis divides the output
    channels.  A ``GroupNorm``'s scale and bias split with the channels
    when every piece holds whole groups; in a block of ``convs`` and
    ``norms`` (the U-Net's ``ConvBlock``) convolution j splits only if
    norm j does, so no group straddles a split.  Everything else is
    replicated.  (:func:`param_sharding` is the flax-layout rule.)"""
    mp = mesh.shape.get("model", 1)
    split0, split1 = Placement(("model",)), Placement((None, "model"))
    out = {name: Placement(()) for name, _ in module.named_parameters()}

    def divides(c: int) -> bool:
        return mp > 1 and c % mp == 0

    def norm_splits(norm: torch.nn.GroupNorm) -> bool:
        per_group = norm.num_channels // norm.num_groups
        return divides(norm.num_channels) and \
            (norm.num_channels // mp) % per_group == 0

    paired = {}
    for name, mod in module.named_modules():
        if hasattr(mod, "convs") and hasattr(mod, "norms"):
            for j, (conv, norm) in enumerate(zip(mod.convs, mod.norms)):
                ok = divides(conv.out_channels) and norm_splits(norm)
                pre = f"{name}." if name else ""
                paired[f"{pre}convs.{j}"] = ok
                paired[f"{pre}norms.{j}"] = ok
    for name, mod in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, torch.nn.Conv3d):
            ok = paired.get(name, divides(mod.out_channels))
            weight = split0
        elif isinstance(mod, torch.nn.ConvTranspose3d):
            ok, weight = divides(mod.out_channels), split1
        elif isinstance(mod, torch.nn.GroupNorm):
            ok = paired.get(name, norm_splits(mod))
            weight = split0
        else:
            continue
        if ok:
            out[pre + "weight"] = weight
            if mod.bias is not None:
                out[pre + "bias"] = split0
    return out


def _coords(mesh: Mesh):
    return list(itertools.product(*[range(s) for s in
                                    mesh.devices.shape]))


def _split_index(mesh: Mesh, coord, axes: Tuple[str, ...]):
    """(index, count) of a mesh position along a product of axes (C order
    over the listed axes)."""
    idx, cnt = 0, 1
    for a in axes:
        k = mesh.axis_names.index(a)
        idx = idx * mesh.devices.shape[k] + coord[k]
        cnt *= mesh.devices.shape[k]
    return idx, cnt


def _piece(n: int, idx: int, cnt: int) -> slice:
    step = -(-n // cnt)
    return slice(min(idx * step, n), min((idx + 1) * step, n))


def send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A REAL copy of ``t`` on ``device``: ``t.to(d)`` on a tensor that
    already lives on ``d`` would return the same storage, and shards that
    share a device must never alias each other's halos or planes."""
    return t.to(device, copy=True)


def shard(x: torch.Tensor, mesh: Mesh, placement: Placement
          ) -> List[torch.Tensor]:
    """Split ``x`` onto the mesh: one tensor per mesh position (C order),
    each a copy on its shard's device.  A dim split over ``k`` shards is
    cut in pieces of ``ceil(n / k)`` (the last ones shorter)."""
    out = []
    for coord, dev in zip(_coords(mesh), mesh.device_list):
        sl = []
        for d in range(x.ndim):
            axes = placement.axes_of(d)
            if not axes:
                sl.append(slice(None))
                continue
            idx, cnt = _split_index(mesh, coord, axes)
            sl.append(_piece(x.shape[d], idx, cnt))
        out.append(send(x[tuple(sl)], dev).contiguous())
    return out


def unshard(shards: Sequence[torch.Tensor], mesh: Mesh,
            placement: Placement,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """Join a sharded tensor back on ``device`` (default the first
    shard's); replicated positions must agree and are written once."""
    coords = _coords(mesh)
    ref = shards[0]
    ndim = ref.ndim
    shape = []
    for d in range(ndim):
        axes = placement.axes_of(d)
        if not axes:
            shape.append(ref.shape[d])
            continue
        sizes: Dict[int, int] = {}
        for coord, s in zip(coords, shards):
            idx, _ = _split_index(mesh, coord, axes)
            sizes[idx] = s.shape[d]
        shape.append(sum(sizes.values()))
    dev = device if device is not None else ref.device
    out = torch.empty(shape, dtype=ref.dtype, device=dev)
    for coord, s in zip(coords, shards):
        sl = []
        for d in range(ndim):
            axes = placement.axes_of(d)
            if not axes:
                sl.append(slice(None))
                continue
            idx, cnt = _split_index(mesh, coord, axes)
            sl.append(_piece(shape[d], idx, cnt))
        out[tuple(sl)] = s.to(dev)
    return out
