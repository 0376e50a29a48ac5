"""Expert parallelism: top-1 token routing with all-to-all dispatch.

Port of cluster_tools_tpu/parallel/experts.py.  Experts live one per shard
along an ``expert`` mesh axis; each shard routes its local tokens to the
experts its gate picks, into a capacity buffer per expert, and the two
``all_to_all`` exchanges of the JAX program are per-shard slices sent
between the shards (:func:`~.mesh.send`): piece e of source j's buffer to
expert e, and back.  Each expert takes at most ``capacity`` tokens per
source shard; overflow tokens pass through unchanged (residual), never
silently dropped.  The integer routing (choice, position, keep) is the JAX
program's.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .mesh import Mesh, axis_devices, send, single_axis_mesh
from .pipeline import tree_map


def route(logits: torch.Tensor, capacity: int):
    """Top-1 routing of one shard's tokens: ``(choice, pos, keep,
    gate)`` — the chosen expert (the first of equal maxima), the token's
    place in that expert's buffer (its rank among the shard's tokens that
    chose it), whether the place is under ``capacity``, and the gate's
    softmax weight of the choice."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    choice = torch.argmax(logits, dim=1)
    gate = torch.softmax(logits, dim=1)[rows, choice]
    onehot = torch.nn.functional.one_hot(
        choice, logits.shape[1]).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) - 1)[rows, choice]
    return choice, pos, pos < capacity, gate


def moe_apply(fn: Callable[[Any, torch.Tensor], torch.Tensor],
              expert_params: Any, gate_logits: torch.Tensor,
              tokens: torch.Tensor, mesh: Mesh, axis: str = "expert",
              capacity: int = 0) -> torch.Tensor:
    """Route tokens to experts along a mesh axis and combine.

    ``fn(params_e, x[C, d]) -> y[C, d]`` is one expert applied to its
    capacity buffer; ``expert_params`` has a leading ``n_experts`` axis;
    ``gate_logits``: ``(T, n_experts)`` per-token scores; ``tokens``:
    ``(T, d)``, both split over ``axis`` in T (T must divide by the axis
    size).  Returns ``(T, d)`` on ``tokens``' device: ``g * expert(token)
    + (1 - g) * token`` for routed tokens (g = the gate's softmax weight
    of the chosen expert), identity for overflow.
    """
    devs = axis_devices(mesh, axis)
    n = len(devs)
    t_local = tokens.shape[0] // n
    if t_local * n != tokens.shape[0]:
        raise ValueError(f"{tokens.shape[0]} tokens do not split over "
                         f"{n} shards")
    cap = capacity or -(-t_local // n)  # default: even split
    d = tokens.shape[1]
    params = [tree_map(lambda p, i=i: send(p[i], devs[i]), expert_params)
              for i in range(n)]
    local = []
    for j, dev in enumerate(devs):
        sl = slice(j * t_local, (j + 1) * t_local)
        x = send(tokens[sl], dev)
        logits = send(gate_logits[sl], dev)
        choice, pos, keep, gate = route(logits, cap)
        slot = torch.where(keep, pos, torch.full_like(pos, cap))
        # dispatch buffer (n_experts, cap + 1, d); overflow goes to the
        # scratch row, which is dropped
        disp = torch.zeros((n, cap + 1, d), dtype=x.dtype, device=dev)
        disp[choice, slot] = x
        local.append((x, choice, pos, keep, gate, disp[:, :cap]))
    # exchange: expert e gathers piece e of every source's buffer
    ys = []
    for e, dev in enumerate(devs):
        buf = torch.cat([send(loc[5][e:e + 1], dev) for loc in local])
        y = fn(params[e], buf.reshape(n * cap, d))
        ys.append(y.reshape(n, cap, d))
    out = []
    for j, dev in enumerate(devs):
        x, choice, pos, keep, gate, _ = local[j]
        # and back: source j gathers piece j of every expert's output
        y = torch.cat([send(ye[j:j + 1], dev) for ye in ys])
        routed = y[choice, torch.where(keep, pos, torch.zeros_like(pos))]
        g = (gate * keep)[:, None]
        out.append(send(g * routed + (1.0 - g) * x, tokens.device))
    return torch.cat(out)


def make_expert_mesh(n_experts: int, n_devices: Optional[int] = None,
                     devices: Optional[Sequence[torch.device]] = None
                     ) -> Mesh:
    """Mesh with a single ``expert`` axis (one expert per shard)."""
    return single_axis_mesh("expert", n_experts, n_devices, devices)
