"""Multi-process runs: ``torch.distributed`` plumbing, per-process block
ownership, filesystem barriers, trace shards.

Port of cluster_tools_tpu/parallel/multihost.py.  The shared store stays
the data plane (chunk-aligned writes are race-free) and SPMD processes
replace the reference's batch scheduler:

* every process runs the SAME driver script; :func:`init_distributed`
  (``torch.distributed`` over TCP) or the ``CTT_PROCESS_COUNT`` /
  ``CTT_PROCESS_ID`` env pair tells each process who it is;
* blockwise tasks shard their block list per process — process p runs job
  p of an n-process layout, so the job protocol and the log-line success
  detection apply unchanged (core/runtime.py ``_run_jobs_multiprocess``);
  block-granular retry runs in-run: after the jobs barrier every process
  parses the same shared logs and re-enters its shard of the same
  failed-block list;
* global (reduce-style) and single-job tasks run on the LEAD process only;
  the others wait at a filesystem barrier and read the lead's results;
* :func:`make_multihost_mesh` pairs the process group with this process's
  local device mesh (one process per card or group of cards).

Within one process a device mesh needs no process group (parallel/mesh.py):
``torch.distributed`` is used here only, for process-level runs (gloo on
the CPU, gloo or NCCL on the card's machine).  Remaining limit: retry of a
FAILED process's blocks needs an external restart of that process.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Initialize the ``torch.distributed`` process group from the args or
    the standard env variables (``COORDINATOR_ADDRESS`` as ``host:port``,
    ``NUM_PROCESSES``, ``PROCESS_ID``) through a TCP store.  No-op for one
    process or when already initialized.  ``backend`` defaults to gloo
    (the process-level runs move small host tensors; the data plane is
    the shared store)."""
    import torch.distributed as dist

    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    num_processes = num_processes or int(
        os.environ.get("NUM_PROCESSES", "0")) or None
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PROCESS_ID", "-1")))
    if coordinator_address is None or num_processes in (None, 1):
        return
    if dist.is_initialized():
        return
    if process_id < 0:
        raise ValueError("PROCESS_ID (or process_id) is required with "
                         "more than one process")
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend=backend or "gloo", init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))


def process_count() -> int:
    """Number of cooperating processes: the ``CTT_PROCESS_COUNT`` env
    first, then the initialized process group, else 1."""
    env = os.environ.get("CTT_PROCESS_COUNT")
    if env:
        return int(env)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    env = os.environ.get("CTT_PROCESS_ID")
    if env:
        return int(env)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_lead() -> bool:
    return process_index() == 0


def owned_blocks(block_list: Sequence[int]) -> List[int]:
    """This process's round-robin share of a block list (the reference's
    ``block_list[job_id::n_jobs]`` layout, cluster_tasks.py:322-332)."""
    return list(block_list)[process_index()::process_count()]


#: this process instance's epoch id (fresh per process start) and the
#: in-memory round counters, keyed by (run token, barrier name)
_EPOCH_ID: Optional[str] = None
_ROUNDS: dict = {}


def _my_epoch(bdir: str) -> str:
    """Publish (once) this process instance's epoch: a fresh uuid written
    at the first barrier use.  The run token is derived from ALL
    processes' epochs, so any process restart changes the token and
    renamespaces every barrier — no clocks involved."""
    global _EPOCH_ID
    if _EPOCH_ID is None:
        import uuid

        _EPOCH_ID = uuid.uuid4().hex[:16]
    path = os.path.join(bdir, f"epoch_p{process_index()}")
    tmp = path + f".tmp{os.getpid()}"
    if not os.path.exists(path) or open(path).read().strip() != _EPOCH_ID:
        with open(tmp, "w") as f:
            f.write(_EPOCH_ID)
        os.replace(tmp, path)
    return _EPOCH_ID


def _current_token(bdir: str, pc: int) -> Optional[str]:
    """Run token = digest of every process's current epoch (None until
    all are published)."""
    import hashlib

    epochs = []
    for p in range(pc):
        try:
            with open(os.path.join(bdir, f"epoch_p{p}")) as f:
                e = f.read().strip()
        except FileNotFoundError:
            return None
        if not e:
            return None
        epochs.append(e)
    return hashlib.sha1("|".join(epochs).encode()).hexdigest()[:12]


def fs_barrier(tmp_folder: str, name: str,
               timeout: Optional[float] = 600.0,
               poll: float = 0.05) -> None:
    """Filesystem barrier over the shared tmp folder (the reference's
    control plane is files + polling; cluster_tasks.py:466-490).

    Counters are IN-MEMORY, namespaced by a run token derived from every
    participant's per-instance epoch uuid: a crashed run's on-disk state
    can never satisfy (or stall) a fresh run.  If a peer restarts while
    others wait, the token change makes the waiters re-enter the new
    namespace and converge with it.  ``timeout=None`` waits forever (the
    jobs barrier of a lead-only task waits for the lead's whole job)."""
    pc = process_count()
    if pc <= 1:
        return
    bdir = os.path.join(tmp_folder, "barriers")
    os.makedirs(bdir, exist_ok=True)
    _my_epoch(bdir)
    entered_round: dict = {}

    def _enter(token: str) -> int:
        if token in entered_round:
            return entered_round[token]
        my_round = _ROUNDS.get((token, name), 0) + 1
        _ROUNDS[(token, name)] = my_round
        entered_round[token] = my_round
        ndir = os.path.join(bdir, token, name)
        os.makedirs(ndir, exist_ok=True)
        mine = os.path.join(ndir, f"p{process_index()}.count")
        tmp = mine + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(my_round))
        os.replace(tmp, mine)
        return my_round

    deadline = None if timeout is None else time.time() + timeout
    while True:
        token = _current_token(bdir, pc)
        if token is not None:
            my_round = _enter(token)
            ndir = os.path.join(bdir, token, name)
            counts = []
            for p in range(pc):
                try:
                    with open(os.path.join(ndir, f"p{p}.count")) as f:
                        counts.append(int(f.read().strip() or 0))
                except (FileNotFoundError, ValueError):
                    counts.append(0)
            if all(c >= my_round for c in counts):
                return
        if deadline is not None and time.time() > deadline:
            raise TimeoutError(
                f"barrier {name}: not all {pc} processes arrived within "
                f"{timeout}s (token {token})")
        time.sleep(poll)


def clock_anchor(tmp_folder: str, name: str = "trace-anchor",
                 timeout: Optional[float] = 600.0):
    """Barrier-aligned ``(wall, perf)`` clock sample for trace-shard
    merging: every process leaves the same :func:`fs_barrier` round
    within one poll interval, so the wall clocks taken right after the
    release estimate the cross-process offset to about the poll
    granularity."""
    from ..core import telemetry

    fs_barrier(tmp_folder, name, timeout=timeout)
    return (time.time(), telemetry.now())


def trace_shard_path(tmp_folder: str, pid: Optional[int] = None) -> str:
    """Canonical per-process trace-shard path under ``tmp_folder``."""
    p = process_index() if pid is None else int(pid)
    return os.path.join(tmp_folder, f"trace_shard_p{p}.json")


def export_trace_shard(tmp_folder: str, anchor=None) -> str:
    """Export this process's span ring as ``trace_shard_p{i}.json`` in the
    shared tmp folder (``anchor``: an optional :func:`clock_anchor`
    pair; without one the shard anchors to its own clocks)."""
    from ..core import telemetry

    path = trace_shard_path(tmp_folder)
    wall, perf = anchor if anchor is not None else (None, None)
    telemetry.export_trace_shard(
        path, process_index=process_index(),
        process_count=process_count(),
        wall_anchor=wall, perf_anchor=perf)
    return path


def merge_trace_shards(tmp_folder: str, out_path: str, wall=None):
    """Lead-side merge of every process's shard (call after a barrier so
    all shards exist); returns :func:`core.telemetry.merge_chrome_traces`'
    summary."""
    from ..core import telemetry

    shards = [trace_shard_path(tmp_folder, p)
              for p in range(process_count())]
    return telemetry.merge_chrome_traces(shards, out_path, wall=wall)


def make_multihost_mesh(axis_names: Sequence[str] = ("data", "model"),
                        dcn_axis: int = 0, device: str = "cuda",
                        mesh_devices: int = 0):
    """The process group plus this process's local mesh: returns
    ``(group, mesh)`` — ``group`` the default ``torch.distributed`` group
    (None for one process), across which the ``dcn_axis`` runs (one
    process per position), and ``mesh`` this process's shard devices laid
    on the first other axis (parallel/mesh.py).  Collectives across
    processes go through the group (``dist.all_reduce``); within a
    process the shards are plain device copies."""
    import numpy as np
    import torch.distributed as dist

    from .mesh import Mesh, shard_devices

    devs = shard_devices(device, mesh_devices)
    sizes = [1] * len(axis_names)
    other = (dcn_axis + 1) % len(axis_names) if len(axis_names) > 1 \
        else dcn_axis
    sizes[other] = len(devs)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    mesh = Mesh(arr.reshape(sizes), tuple(axis_names))
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    return group, mesh
