"""Ring attention: exact attention over sequences sharded across shards.

Port of cluster_tools_tpu/parallel/ring_attention.py.  Queries stay on
their shard; key/value chunks rotate backwards around the ring as real
copies (:func:`~.mesh.send`, the counterpart of ``ppermute``), and each hop
folds its partial attention into the online softmax in float32 (running
max, running normalizer, running weighted sum).  After ``n_shards`` hops
every query has seen every key exactly once; the last hop attends without
rotating.  Causal masking compares global positions: at hop ``step`` shard
``my`` holds the chunk of shard ``(my + step) % n_shards``.  The two
products run on float32 copies of the operands (bfloat16 products are
exact in float32: JAX's ``preferred_element_type=float32``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .mesh import Mesh, axis_devices, send, single_axis_mesh


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = "seq",
                   causal: bool = False) -> torch.Tensor:
    """Exact (optionally causal) attention with the sequence axis split
    over ``axis``.

    ``q, k, v``: ``(T, H, D)``, split over the leading (sequence) axis; T
    must divide by the axis size.  Returns ``(T, H, D)`` in ``q``'s dtype
    on its device: ``softmax(q k^T / sqrt(D)) v`` computed without any
    shard ever holding more than its ``T / n_shards`` slice of k/v.
    """
    devs = axis_devices(mesh, axis)
    n = len(devs)
    t_local = q.shape[0] // n
    if t_local * n != q.shape[0]:
        raise ValueError(f"{q.shape[0]} positions do not split over {n} "
                         f"shards")
    scale = 1.0 / math.sqrt(q.shape[-1])
    h, d = q.shape[1], q.shape[2]
    f32 = torch.float32

    def chunk(t, i):
        return send(t[i * t_local:(i + 1) * t_local], devs[i])

    ql = [chunk(q, i) for i in range(n)]
    kc = [chunk(k, i) for i in range(n)]
    vc = [chunk(v, i) for i in range(n)]
    m = [torch.full((h, t_local), -math.inf, dtype=f32, device=dev)
         for dev in devs]
    l = [torch.zeros((h, t_local), dtype=f32, device=dev) for dev in devs]
    o = [torch.zeros((h, t_local, d), dtype=f32, device=dev)
         for dev in devs]

    def attend(step, my):
        s = torch.einsum("thd,shd->hts", ql[my].to(f32),
                         kc[my].to(f32)) * scale
        if causal:
            dev = devs[my]
            src = (my + step) % n
            q_pos = my * t_local + torch.arange(t_local, device=dev)
            k_pos = src * t_local + torch.arange(t_local, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None], s, -math.inf)
        m_new = torch.maximum(m[my], s.amax(dim=2))
        # rows with no visible key yet (causal, all -inf) must not poison
        # exp(): a finite max; exp(m - m_safe) is then 0 for the -inf prior
        m_safe = torch.where(torch.isneginf(m_new),
                             torch.zeros_like(m_new), m_new)
        corr = torch.exp(m[my] - m_safe)
        p = torch.exp(s - m_safe[:, :, None])
        l[my] = l[my] * corr + p.sum(dim=2)
        o[my] = o[my] * corr[..., None] + torch.einsum(
            "hts,shd->htd", p, vc[my].to(f32))
        m[my] = m_new

    for step in range(n - 1):
        for my in range(n):
            attend(step, my)
        # rotate backwards: shard j receives the chunk of shard j + 1
        kc = [send(kc[(j + 1) % n], devs[j]) for j in range(n)]
        vc = [send(vc[(j + 1) % n], devs[j]) for j in range(n)]
    for my in range(n):
        attend(n - 1, my)
    out = [send((o[i] / torch.clamp(l[i][..., None], min=1e-30)).transpose(
        0, 1).to(q.dtype), q.device) for i in range(n)]
    return torch.cat(out)


def make_seq_mesh(n_shards: int, n_devices: Optional[int] = None,
                  devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Mesh with a single ``seq`` axis for sequence/context parallelism."""
    return single_axis_mesh("seq", n_shards, n_devices, devices)
