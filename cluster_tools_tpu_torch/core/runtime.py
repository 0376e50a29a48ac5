"""Block-task runtime (L2): executors, job protocol, block-granular retry.

Re-specification of the reference's cluster runtime
(cluster_tools/cluster_tasks.py — BaseClusterTask and the five-call job
protocol at cluster_tasks.py:34-57, backends at :375-620).  Differences by
design:

* Scheduler backends (sbatch/bsub) are replaced by **executors**:
  - ``local``   — one subprocess per job (process isolation like the
                  reference's LocalTask, cluster_tasks.py:493-533);
  - ``threads`` — in-process thread pool (IO-bound tasks);
  - ``inline``  — jobs run sequentially in the driver process;
  - ``gpu``     — the inline executor for **device tasks**: one process
                  owns the card, so device work runs inline with each
                  block's work enqueued on the card instead of per-block
                  subprocesses.
* The job protocol is kept: per-job JSON configs embedding the job's block
  list (round-robin ``block_list[job_id::n_jobs]`` or consecutive), log-line
  based success detection ("processed block %i" / "processed job %i",
  reference utils/function_utils.py:11-16), block-granular retry of failed
  blocks with the ≥50%-failed abort heuristic (cluster_tasks.py:127-142).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence, Set

from . import config as config_mod
from . import telemetry
from .workflow import FileTarget, Task

# ---------------------------------------------------------------------------
# logging helpers (reference: utils/function_utils.py)
# ---------------------------------------------------------------------------

_BLOCK_SUCCESS = "processed block"
_JOB_SUCCESS = "processed job"
_STAGE_LINE = "stage times"

# ---------------------------------------------------------------------------
# per-stage accounting: tasks attribute wall time to named stages
# (device waits, host compute, store IO, ...) via the ``stage`` context
# manager / ``stage_add``; ``run_jobs`` snapshots the accumulator around the
# executor and writes the delta into the status JSON.  Subprocess workers
# print their stages as a log line that the driver parses (same channel as
# the block-success protocol).
# ---------------------------------------------------------------------------

_STAGE_ACC: Dict[str, float] = {}
_BYTES_ACC: Dict[str, float] = {}
_COUNT_ACC: Dict[str, int] = {}
_STAGE_LOCK = threading.Lock()

#: stage-name prefixes attributed to the device path when computing the
#: per-task device_busy_frac in the status JSON (canonical definition in
#: core.telemetry).
_DEVICE_STAGE_PREFIXES = telemetry.DEVICE_STAGE_PREFIXES


def stage_add(name: str, seconds: float, count: int = 1) -> None:
    with _STAGE_LOCK:
        _STAGE_ACC[name] = _STAGE_ACC.get(name, 0.0) + float(seconds)
        _COUNT_ACC[name] = _COUNT_ACC.get(name, 0) + int(count)
    # span emission AFTER (and outside) the accumulator update: the
    # accumulators — and thus stage_counts in status JSONs — are
    # bit-for-bit identical whether telemetry is on or off.
    if telemetry.enabled():
        telemetry.record_stage(name, seconds, count)


def stage_bytes(name: str, nbytes: int) -> None:
    """Attribute moved bytes (host<->device or host<->store) to a stage."""
    with _STAGE_LOCK:
        _BYTES_ACC[name] = _BYTES_ACC.get(name, 0.0) + float(nbytes)


def bytes_snapshot() -> Dict[str, float]:
    with _STAGE_LOCK:
        return dict(_BYTES_ACC)


def bytes_delta(before: Dict[str, float]) -> Dict[str, float]:
    now = bytes_snapshot()
    return {k: v - before.get(k, 0.0) for k, v in now.items()
            if v - before.get(k, 0.0) > 0}


class stage:
    """Context manager attributing elapsed wall time to a named stage."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # ctt-lint: disable=stage-registry (framework forwarder: the literal was already registry-checked at the stage(...) call site)
        stage_add(self.name, time.perf_counter() - self._t0)
        return False


def stages_snapshot() -> Dict[str, float]:
    with _STAGE_LOCK:
        return dict(_STAGE_ACC)


def stages_delta(before: Dict[str, float]) -> Dict[str, float]:
    now = stages_snapshot()
    out = {k: v - before.get(k, 0.0) for k, v in now.items()
           if v - before.get(k, 0.0) > 1e-4}
    return out


def counts_snapshot() -> Dict[str, int]:
    with _STAGE_LOCK:
        return dict(_COUNT_ACC)


def counts_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = counts_snapshot()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0) > 0}


_BYTES_LINE = "stage bytes"
_COUNT_LINE = "stage counts"


def log_stage_times() -> None:
    """Emit the worker-side stage accumulators as parseable log lines."""
    st = stages_snapshot()
    if st:
        log(f"{_STAGE_LINE} {json.dumps({k: round(v, 3) for k, v in st.items()})}")
    by = bytes_snapshot()
    if by:
        log(f"{_BYTES_LINE} {json.dumps({k: int(v) for k, v in by.items()})}")
    cn = counts_snapshot()
    if cn:
        log(f"{_COUNT_LINE} {json.dumps({k: int(v) for k, v in cn.items()})}")


_STATUS_LINE = "status fields"


def status_fields(log_fn, **fields) -> None:
    """Record ``fields`` for the task's status JSON from inside a job, under
    any executor: a job-log line the driver parses, like the stage lines.
    A mesh-aware task records its shards and the distinct devices under
    them, so 4 shards on one card never read as 4 cards."""
    log_fn(f"{_STATUS_LINE} {json.dumps(fields)}")


def parse_status_fields(log_path: str) -> Dict[str, Any]:
    """The fields :func:`status_fields` wrote into one job log (the last
    value of a key wins)."""
    out: Dict[str, Any] = {}
    if not os.path.exists(log_path):
        return out
    with open(log_path) as f:
        for line in f:
            pos = line.find(_STATUS_LINE + " {")
            if pos >= 0:
                out.update(json.loads(line[pos + len(_STATUS_LINE):]))
    return out


def parse_stage_times(log_path: str, line_tag: str = _STAGE_LINE
                      ) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if not os.path.exists(log_path):
        return out
    with open(log_path) as f:
        for line in f:
            pos = line.find(line_tag + " {")
            if pos < 0:
                continue
            try:
                d = json.loads(line[pos + len(line_tag):].strip())
            except json.JSONDecodeError:
                continue
            for k, v in d.items():
                out[k] = out.get(k, 0.0) + float(v)
    return out


# ---------------------------------------------------------------------------
# live-buffer ledger: bytes pinned by long-lived caches (the fused chain's
# fragment and raw-volume caches), written into task status JSONs.
# ---------------------------------------------------------------------------

_LEDGER_LOCK = threading.Lock()
_LEDGER: Dict[str, Dict[str, int]] = {}


def ledger_add(account: str, nbytes: int, entries: int = 1) -> None:
    """Charge ``nbytes``/``entries`` (may be negative) to an account."""
    with _LEDGER_LOCK:
        acc = _LEDGER.setdefault(account, {"bytes": 0, "entries": 0})
        acc["bytes"] = max(acc["bytes"] + int(nbytes), 0)
        acc["entries"] = max(acc["entries"] + int(entries), 0)


def ledger_clear(account: Optional[str] = None) -> None:
    """Drop one account (its cache was cleared) or, with None, all."""
    with _LEDGER_LOCK:
        if account is None:
            _LEDGER.clear()
        else:
            _LEDGER.pop(account, None)


def ledger_snapshot() -> Dict[str, Dict[str, int]]:
    with _LEDGER_LOCK:
        return {k: dict(v) for k, v in sorted(_LEDGER.items())}


# ---------------------------------------------------------------------------
# the native-library cache (core/build.py) under the JAX package's
# executable-cache names, and the runtime's Prometheus families
# ---------------------------------------------------------------------------

def exec_cache_snapshot() -> Dict[str, Any]:
    from .build import EXEC_CACHE_STATS

    return dict(EXEC_CACHE_STATS)


def exec_cache_delta(before: Dict[str, Any]) -> Dict[str, Any]:
    """Library-cache activity since ``before`` (only non-zero entries)."""
    return {k: v - before.get(k, 0)
            for k, v in exec_cache_snapshot().items()
            if v - before.get(k, 0) > 0}


def metrics_families():
    """Runtime-level Prometheus families (process-lifetime counters) for
    ``telemetry.write_prometheus``: per-stage seconds/entries/bytes from
    the flat accumulators plus library-cache activity and hit ratio."""
    st, cn, by = stages_snapshot(), counts_snapshot(), bytes_snapshot()
    ec = exec_cache_snapshot()
    led = ledger_snapshot()
    hits = int(ec.get("hits", 0))
    compiles = int(ec.get("compiles", 0))
    ratio = hits / (hits + compiles) if (hits + compiles) else 0.0
    return [
        ("ctt_stage_seconds_total", "counter",
         "Accumulated wall seconds per runtime stage",
         [({"stage": k}, round(v, 6)) for k, v in sorted(st.items())]),
        ("ctt_stage_entries_total", "counter",
         "Accumulated entry count per runtime stage",
         [({"stage": k}, int(v)) for k, v in sorted(cn.items())]),
        ("ctt_stage_bytes_total", "counter",
         "Accumulated bytes moved per runtime stage",
         [({"stage": k}, int(v)) for k, v in sorted(by.items())]),
        ("ctt_exec_cache_events_total", "counter",
         "Native-library cache activity by event kind",
         [({"kind": k}, v) for k, v in sorted(ec.items())]),
        ("ctt_exec_cache_hit_ratio", "gauge",
         "Native-library cache memory-tier hit ratio "
         "(hits/(hits+compiles))",
         [(None, round(ratio, 6))]),
        ("ctt_ledger_bytes", "gauge",
         "Live bytes pinned per buffer-ledger account (native libraries, "
         "fragment/raw caches)",
         [({"account": k}, int(v["bytes"]))
          for k, v in sorted(led.items())] or [(None, 0)]),
        ("ctt_ledger_entries", "gauge",
         "Live entries per buffer-ledger account",
         [({"account": k}, int(v["entries"]))
          for k, v in sorted(led.items())] or [(None, 0)]),
    ]


# ---------------------------------------------------------------------------
# lock-order witness.  Opt-in instrumented Lock/RLock wrappers record
# the per-thread acquisition graph at runtime: an edge A->B means "B was
# acquired while A was held".  A cycle in that graph is a potential
# deadlock (two threads interleaving the inverted orders wedge forever),
# and a ``witness_blocking`` region entered while ANY lock is held breaks
# the blocking-under-lock rule.  Disabled (the default), ``named_lock``
# returns plain ``threading`` locks and ``witness_blocking`` is one
# module-global read returning a shared no-op context manager.  Enable
# with ``lock_witness_configure(enabled=True)`` BEFORE constructing the
# locks to instrument (the server tests do).
# ---------------------------------------------------------------------------

_WITNESS_ENABLED = False


class _WitnessState:
    """Acquisition graph + flight recorder, guarded by its own plain
    (never witnessed) leaf lock."""

    def __init__(self, ring: int = 256):
        from collections import deque

        self.lock = threading.Lock()
        self.edges: Dict[str, Set[str]] = {}
        self.violations: List[Dict[str, Any]] = []
        self.events = deque(maxlen=int(ring))
        self.tls = threading.local()
        self.locks_seen: Set[str] = set()

    def held(self) -> List[str]:
        return getattr(self.tls, "stack", [])

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> ... -> dst over recorded edges, or None."""
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self.edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def on_acquired(self, name: str) -> None:
        stack = getattr(self.tls, "stack", None)
        if stack is None:
            stack = self.tls.stack = []
        thread = threading.current_thread().name
        with self.lock:
            self.locks_seen.add(name)
            self.events.append(("acquire", name, thread, list(stack)))
            for h in stack:
                if h == name:        # re-entrant RLock hold
                    continue
                fresh = name not in self.edges.get(h, ())
                self.edges.setdefault(h, set()).add(name)
                if fresh:
                    # adding h->name: a pre-existing name->...->h path
                    # closes a cycle = lock-order inversion
                    path = self._find_path(name, h)
                    if path is not None:
                        self.violations.append({
                            "kind": "lock-order-inversion",
                            "thread": thread,
                            "edge": [h, name],
                            "cycle": path + [name],
                        })
        stack.append(name)

    def on_released(self, name: str) -> None:
        stack = getattr(self.tls, "stack", None)
        if stack and name in stack:
            # remove the LAST occurrence (re-entrant holds release LIFO)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break
        with self.lock:
            self.events.append(
                ("release", name, threading.current_thread().name,
                 list(stack or [])))

    def on_blocking(self, desc: str) -> None:
        stack = list(getattr(self.tls, "stack", []))
        if not stack:
            return
        with self.lock:
            self.violations.append({
                "kind": "blocking-under-lock",
                "thread": threading.current_thread().name,
                "blocking": desc,
                "held": stack,
            })


_WITNESS_STATE = _WitnessState()


class _WitnessLock:
    """Instrumented Lock/RLock: records acquisition order into the
    witness graph.  API-compatible with ``threading.Condition(lock)``
    (acquire/release/locked + context manager)."""

    def __init__(self, name: str, rlock: bool = False):
        self.name = name
        self._inner = threading.RLock() if rlock else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _WITNESS_STATE.on_acquired(self.name)
        return got

    def release(self) -> None:
        _WITNESS_STATE.on_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<_WitnessLock {self.name!r} {self._inner!r}>"


class _NullBlocking:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_BLOCKING = _NullBlocking()


class _WitnessBlocking:
    __slots__ = ("desc",)

    def __init__(self, desc: str):
        self.desc = desc

    def __enter__(self):
        _WITNESS_STATE.on_blocking(self.desc)
        return self

    def __exit__(self, *exc):
        return False


def witness_enabled() -> bool:
    return _WITNESS_ENABLED


def named_lock(name: str, rlock: bool = False):
    """A lock for the witness to observe.  Disabled (default): a plain
    ``threading.Lock``/``RLock`` — zero added cost.  Enabled: a
    ``_WitnessLock`` recording the acquisition graph under ``name``."""
    if not _WITNESS_ENABLED:
        return threading.RLock() if rlock else threading.Lock()
    return _WitnessLock(name, rlock=rlock)


def witness_blocking(desc: str):
    """Context manager marking a potentially-blocking region (file IO,
    cross-thread waits).  Under the witness, entering one while any
    witnessed lock is held records a blocking-under-lock violation.
    Off path: one module-global read + a shared no-op object."""
    if not _WITNESS_ENABLED:
        return _NULL_BLOCKING
    return _WitnessBlocking(desc)


def lock_witness_configure(enabled: bool = True, ring: int = 256) -> None:
    """Turn the witness on/off.  Enabling resets state; locks created
    BEFORE enabling stay uninstrumented (create them after)."""
    global _WITNESS_ENABLED, _WITNESS_STATE
    _WITNESS_STATE = _WitnessState(ring=ring)
    _WITNESS_ENABLED = bool(enabled)


def lock_witness_reset() -> None:
    """Clear the graph/violations, keeping the enabled flag."""
    global _WITNESS_STATE
    _WITNESS_STATE = _WitnessState(
        ring=_WITNESS_STATE.events.maxlen or 256)


def lock_witness_report() -> Dict[str, Any]:
    """Flight-recorder-style snapshot: locks seen, acquisition edges,
    violations, and the recent acquire/release event ring."""
    st = _WITNESS_STATE
    with st.lock:
        return {
            "enabled": _WITNESS_ENABLED,
            "locks": sorted(st.locks_seen),
            "edges": sorted((a, b) for a, bs in st.edges.items()
                            for b in bs),
            "violations": [dict(v) for v in st.violations],
            "events": [
                {"op": op, "lock": name, "thread": thread, "held": held}
                for op, name, thread, held in st.events],
        }


def lock_witness_dump(path: str) -> str:
    """Atomic JSON dump of the report (crash-analysis artifact)."""
    config_mod.write_config(path, lock_witness_report())
    return path






def log(msg: str, stream=None) -> None:
    stream = stream or sys.stdout
    print(f"{datetime.now().isoformat()}: {msg}", file=stream, flush=True)


def log_block_success(block_id: int) -> None:
    log(f"{_BLOCK_SUCCESS} {block_id}")


def log_job_success(job_id: int) -> None:
    log(f"{_JOB_SUCCESS} {job_id}")


def parse_job_success(log_path: str, job_id: int) -> bool:
    """Job succeeded iff its last log line is `processed job <id>`
    (reference: utils/parse_utils.py:76-93)."""
    if not os.path.exists(log_path):
        return False
    last = ""
    with open(log_path) as f:
        for line in f:
            if line.strip():
                last = line.strip()
    return last.endswith(f"{_JOB_SUCCESS} {job_id}")


def parse_processed_blocks(log_path: str) -> Set[int]:
    """Blocks completed by a (possibly failed) job (reference:
    utils/parse_utils.py:123-154)."""
    blocks: Set[int] = set()
    if not os.path.exists(log_path):
        return blocks
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if _BLOCK_SUCCESS in line:
                try:
                    blocks.add(int(line.split(_BLOCK_SUCCESS)[1].split()[0]))
                except (IndexError, ValueError):
                    pass
    return blocks


def parse_job_runtime(log_path: str) -> Optional[float]:
    """Seconds between first and last timestamped log line (reference:
    utils/parse_utils.py:14-63 runtime accounting)."""
    first = last = None
    if not os.path.exists(log_path):
        return None
    with open(log_path) as f:
        for line in f:
            ts = line.split(":", 1)[0]
            try:
                t = datetime.fromisoformat(line[: len(ts) + 13].split(": ")[0])
            except ValueError:
                continue
            if first is None:
                first = t
            last = t
    if first is None or last is None:
        return None
    return (last - first).total_seconds()


def prefetch_iter(items, load, window: int = 2):
    """Iterate ``load(item)`` results with a bounded thread-pool look-ahead
    (chunk decompression releases the GIL, so upcoming blocks load while
    the caller computes).  Yields in input order — the same bounded window
    as :func:`stream_window`, with futures as the in-flight handles."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=window) as pool:
        yield from stream_window(items, lambda it: pool.submit(load, it),
                                 lambda fut: fut.result(), window=window)


class BoundedPool:
    """Thread pool with BOUNDED in-flight futures — the async-drain hook
    for blockwise device tasks.  Drains hand per-block host tails (RLE
    decode, table gather, store write — zlib and file IO release the GIL)
    to the pool and immediately return to waiting on the next device
    program; ``submit`` blocks once ``max_inflight`` results are pending,
    so queued blocks (each holding a ~100 MB uint64 write buffer) cannot
    grow RSS unboundedly.  ``max_workers=0`` degrades to synchronous
    inline calls — the sequential-drain reference mode the pipelined path
    must match bit-identically (tests/test_write_pipelined.py).

    Worker exceptions surface on the next ``submit`` or at ``close()``
    (context-manager exit), never silently."""

    def __init__(self, max_workers: int, max_inflight: Optional[int] = None):
        from collections import deque

        self.max_workers = int(max_workers)
        self.max_inflight = (max(int(max_inflight), 1) if max_inflight
                             else max(2 * self.max_workers, 1))
        self._pool = (ThreadPoolExecutor(self.max_workers)
                      if self.max_workers > 0 else None)
        self._pending = deque()

    def submit(self, fn, *args, **kwargs) -> None:
        if self._pool is None:
            fn(*args, **kwargs)
            return
        while len(self._pending) >= self.max_inflight:
            self._pending.popleft().result()
        if telemetry.enabled():
            fn = self._traced(fn)
        self._pending.append(self._pool.submit(fn, *args, **kwargs))

    @staticmethod
    def _traced(fn):
        """Wrap a pool task so the trace shows submit->start queue wait
        (cat='queue-wait', feeding the queue-wait histogram rollup) and
        the worker-side execution span (cat='pool')."""
        submitted = telemetry.now()
        name = getattr(fn, "__name__", "task")

        def run(*args, **kwargs):
            started = telemetry.now()
            telemetry.record("pool-queue-wait", submitted, started,
                             cat="queue-wait", fn=name)
            with telemetry.span(f"pool:{name}", cat="pool"):
                return fn(*args, **kwargs)

        return run

    def drain(self) -> None:
        """Wait for every pending task, surfacing the first failure."""
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            # already failing: don't mask the original error with a
            # secondary worker failure during cleanup
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            return False
        self.close()
        return False


def writer_pool(cfg: Dict[str, Any], ds_out,
                default_threads: int = 4,
                sequential: bool = False) -> "BoundedPool":
    """The configured store-writer BoundedPool for a blockwise task: sized
    by the ``writer_threads`` task config (0 = strictly sequential inline
    mode; N5/zarr chunks write in parallel), and forced fully sequential
    when the caller requires ordered
    read-then-write semantics (e.g. in-place writes, where an overlapped
    write can tear a chunk spanning two blocks).  In-flight work is
    bounded at workers + 1 so queued blocks cannot grow RSS unboundedly."""
    n = int(cfg.get("writer_threads", default_threads))
    if sequential:
        n = 0
    return BoundedPool(n, max_inflight=n + 1)


def stream_window(items, submit, drain, window: int = 3):
    """Bounded submit/drain pipeline over ``items``: keep up to ``window``
    submitted entries in flight before draining the oldest, yielding each
    drained result in input order.  The standard shape for blockwise device
    tasks — ``submit`` enqueues a block's device work without
    synchronizing (CUDA launches are asynchronous), ``drain`` waits,
    materializes and writes, so consecutive blocks overlap transfer,
    compute, and host IO.  A generator:
    consume it fully (side-effect-only drains just iterate it)."""
    from collections import deque

    pending = deque()
    for item in items:
        pending.append(submit(item))
        if len(pending) >= window:
            yield drain(pending.popleft())
    while pending:
        yield drain(pending.popleft())



class FailedJobsError(RuntimeError):
    pass


#: set in worker subprocesses; guards against fork bombs when a driver script
#: without an ``if __name__ == "__main__"`` guard is re-executed by the worker
#: to load its task class
WORKER_ENV_FLAG = "CLUSTER_TOOLS_TPU_TORCH_WORKER"


def in_worker() -> bool:
    return os.environ.get(WORKER_ENV_FLAG) == "1"


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

class _LocalExecutor:
    """One subprocess per job, capped at cpu_count concurrent — the analog of
    the reference's LocalTask ProcessPool (cluster_tasks.py:493-533), but
    invoking the generic worker entrypoint instead of a copied script."""

    def __init__(self, max_workers: Optional[int] = None):
        self.max_workers = max_workers or os.cpu_count() or 1

    def run(self, task: "BlockTask", job_ids: Sequence[int]) -> None:
        def _launch(job_id: int) -> int:
            log_path = task.log_path(job_id)
            env = dict(os.environ)
            # workers must see the same packages as the driver, regardless of
            # the driver's cwd (the package may not be pip-installed)
            pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            extra_path = [pkg_parent] + [p for p in sys.path if p]
            prev = env.get("PYTHONPATH")
            if prev:
                extra_path.append(prev)
            env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(extra_path))
            env[WORKER_ENV_FLAG] = "1"
            # keep many-process workers from oversubscribing BLAS threads
            # (reference: utils/numpy_utils.py set_numpy_threads)
            threads = str(task.task_config.get("threads_per_job", 1))
            for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                        "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
                env[var] = threads
            with open(log_path, "w") as lf:
                return subprocess.call(
                    [sys.executable, "-m", "cluster_tools_tpu_torch.core.worker",
                     type(task).__module__, type(task).__name__,
                     task.job_config_path(job_id)],
                    stdout=lf, stderr=subprocess.STDOUT, env=env,
                )

        with ThreadPoolExecutor(min(self.max_workers, len(job_ids))) as pool:
            list(pool.map(_launch, job_ids))


class _InlineExecutor:
    """Run jobs sequentially in the driver process.  Device tasks use this:
    the driver owns the card, and per-job work is enqueued on it block by
    block."""

    def run(self, task: "BlockTask", job_ids: Sequence[int]) -> None:
        for job_id in job_ids:
            log_path = task.log_path(job_id)
            with open(log_path, "w") as lf:
                lock = threading.Lock()

                def _log(msg, _lf=lf, _lock=lock):
                    with _lock:  # ctt-lint: disable=blocking-under-lock (per-job log print is the critical section: the lock serializes interleaved worker lines)
                        print(f"{datetime.now().isoformat()}: {msg}", file=_lf, flush=True)

                try:
                    _run_job_inline(type(task), task.job_config_path(job_id), _log)
                except Exception:
                    import traceback

                    _log("job failed with:\n" + traceback.format_exc())


class _ThreadExecutor:
    """In-process thread pool over jobs (IO-bound tasks)."""

    def __init__(self, max_workers: Optional[int] = None):
        self.max_workers = max_workers or os.cpu_count() or 1

    def run(self, task: "BlockTask", job_ids: Sequence[int]) -> None:
        def _one(job_id: int) -> None:
            with open(task.log_path(job_id), "w") as lf:
                lock = threading.Lock()

                def _log(msg, _lf=lf, _lock=lock):
                    with _lock:  # ctt-lint: disable=blocking-under-lock (per-job log print is the critical section: the lock serializes interleaved worker lines)
                        print(f"{datetime.now().isoformat()}: {msg}", file=_lf, flush=True)

                try:
                    _run_job_inline(type(task), task.job_config_path(job_id), _log)
                except Exception:
                    import traceback

                    _log("job failed with:\n" + traceback.format_exc())

        with ThreadPoolExecutor(min(self.max_workers, len(job_ids))) as pool:
            list(pool.map(_one, job_ids))


def _run_job_inline(task_cls, config_path: str, log_fn) -> None:
    with open(config_path) as f:
        job_config = json.load(f)
    job_id = job_config["job_id"]
    blocks = job_config.get("block_list")
    with telemetry.span(f"{job_config.get('task_name', 'job')}:job{job_id}",
                        cat="job", job_id=job_id,
                        n_blocks=(None if blocks is None else len(blocks))):
        task_cls.process_job(job_id, job_config, log_fn)
    log_fn(f"{_JOB_SUCCESS} {job_id}")


EXECUTORS = {
    "local": _LocalExecutor,
    "inline": _InlineExecutor,
    # the counterpart of the JAX package's ``tpu`` target: device tasks run
    # inline in the driver process, which owns the card
    "gpu": _InlineExecutor,
    # the ``mesh`` target runs mesh-aware tasks in rounds of one block per
    # shard device (the fused chain, the watershed, mesh CC in
    # workflows/mesh_blockwise.py); tasks without a mesh formulation run
    # inline in the driver process, which owns every device
    "mesh": _InlineExecutor,
    "threads": _ThreadExecutor,
}


# ---------------------------------------------------------------------------
# BlockTask
# ---------------------------------------------------------------------------

class BlockTask(Task):
    """Base for all blockwise tasks (reference: BaseClusterTask,
    cluster_tasks.py:25-372).

    Universal constructor parameters (reference: WorkflowBase params,
    cluster_tasks.py:623-654): ``tmp_folder``, ``config_dir``, ``max_jobs``,
    ``target`` ('local' | 'threads' | 'inline' | 'gpu' | 'mesh'),
    ``dependency``.

    Subclasses implement:
      * ``run_impl()`` — create outputs, compute the block list, call
        :meth:`run_jobs`;
      * classmethod ``process_job(job_id, job_config, log_fn)`` — the worker:
        loop the job's ``block_list`` calling per-block compute and
        ``log_fn('processed block %i')`` after each block.
    """

    task_name: str = ""
    #: appended to file names so the same task class can run multiple times
    #: per workflow (e.g. per-scale solves)
    identifier: str = ""
    allow_retry: bool = True
    #: tasks that run as a single global job (reference: cluster_tasks.py:335-341)
    global_task: bool = False
    #: retry attempt counter (class default so run_jobs() works when called
    #: directly, without going through run())
    _retry_count: int = 0
    #: correlation id linking every attempt span (and the status JSON) of
    #: one run_jobs invocation across block-granular retries
    _corr_id: str = ""

    def __init__(self, tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 target: str = "local", dependency: Optional[Task] = None,
                 block_shape: Optional[Sequence[int]] = None, **kwargs):
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = int(max_jobs)
        self.target = target
        self.dependency = dependency
        #: per-task blocking override: workflows whose problem decomposition
        #: differs from the global block grid (e.g. the mesh-resident fused
        #: chain, one SHARD-SLAB per device) pass their own block shape here
        self.block_shape_override = (list(block_shape) if block_shape
                                     else None)
        super().__init__(**kwargs)
        if target not in EXECUTORS:
            raise ValueError(f"unknown target {target!r}; choose from "
                             f"{sorted(EXECUTORS)}")
        self._cfg = config_mod.ConfigDir(config_dir)
        self.global_config = self._cfg.global_config()
        self.task_config = self._cfg.task_config(
            self.task_name, self.default_task_config())
        # telemetry is deployment opt-in the same way: the global config
        # arms the span recorder for every task in the workflow
        if self.global_config.get("telemetry_enabled"):
            telemetry.configure(
                enabled=True,
                ring_size=self.global_config.get("telemetry_ring_size"))
        os.makedirs(self.tmp_folder, exist_ok=True)
        os.makedirs(os.path.join(self.tmp_folder, "logs"), exist_ok=True)

    # -- config --------------------------------------------------------
    @staticmethod
    def default_task_config() -> Dict[str, Any]:
        return config_mod.default_task_resources()

    @property
    def name_with_id(self) -> str:
        return self.task_name + (f"_{self.identifier}" if self.identifier else "")

    # -- workflow plumbing ---------------------------------------------
    def requires(self):
        return self.dependency

    def output(self) -> FileTarget:
        return FileTarget(os.path.join(self.tmp_folder, f"{self.name_with_id}.status"))

    def run(self) -> None:
        self._retry_count = 0
        self.run_impl()

    def run_impl(self) -> None:
        raise NotImplementedError

    # -- file layout ---------------------------------------------------
    def job_config_path(self, job_id: int) -> str:
        return os.path.join(self.tmp_folder,
                            f"{self.name_with_id}_job_{job_id}.config")

    def log_path(self, job_id: int) -> str:
        return os.path.join(self.tmp_folder, "logs",
                            f"{self.name_with_id}_{job_id}.log")

    # -- geometry helpers ----------------------------------------------
    def global_block_shape(self) -> List[int]:
        if self.block_shape_override is not None:
            return list(self.block_shape_override)
        return list(self.global_config["block_shape"])

    def resolve_n_labels(self, labels_path: str = "",
                         labels_key: str = "") -> int:
        """``self.n_labels``, resolved from the labels dataset's maxId at
        RUN time when unset (requires() runs at DAG-construction time,
        before upstream tasks have produced the volume)."""
        if getattr(self, "n_labels", None) is None:
            from .storage import read_max_id

            self.n_labels = read_max_id(
                labels_path or getattr(self, "labels_path", ""),
                labels_key or getattr(self, "labels_key", "")) + 1
        return self.n_labels

    @staticmethod
    def id_chunks(n_items: int, chunk: int) -> List[int]:
        """Shard a 1-D id space into chunk indices (label-space sharding,
        SURVEY §2.4.5); always at least one chunk."""
        return list(range((n_items + chunk - 1) // chunk or 1))

    def blocks_in_volume(self, shape, block_shape=None) -> List[int]:
        from .blocking import blocks_in_volume

        gc = self.global_config
        return blocks_in_volume(
            shape, block_shape or self.global_block_shape(),
            roi_begin=gc.get("roi_begin"), roi_end=gc.get("roi_end"),
            block_list_path=gc.get("block_list_path"),
        )

    # -- the job protocol ----------------------------------------------
    def run_jobs(self, block_list: Optional[Sequence[int]],
                 task_specific_config: Dict[str, Any],
                 n_jobs: Optional[int] = None,
                 consecutive_blocks: bool = False) -> None:
        """Prepare per-job configs, dispatch, check, retry failed blocks.

        ``block_list=None`` runs a single global "reduce-style" job
        (reference: cluster_tasks.py:335-341).
        """
        if in_worker():
            raise RuntimeError(
                "run_jobs() called inside a worker process. If your driver "
                "script defines tasks at module level, guard the driver code "
                "with `if __name__ == '__main__':` (as with multiprocessing) "
                "so workers can import the task class without re-running it.")
        from ..parallel import multihost as mh

        if mh.process_count() > 1:
            return self._run_jobs_multiprocess(
                block_list, task_specific_config, n_jobs,
                consecutive_blocks=consecutive_blocks)
        if block_list is None or self.global_task:
            n_jobs = 1
            job_blocks: List[Optional[List[int]]] = [
                None if block_list is None else list(block_list)]
        else:
            block_list = list(block_list)
            n_jobs = min(n_jobs or self.max_jobs, max(len(block_list), 1))
            if consecutive_blocks:
                per = (len(block_list) + n_jobs - 1) // n_jobs
                job_blocks = [block_list[i * per:(i + 1) * per] for i in range(n_jobs)]
            else:
                job_blocks = [block_list[j::n_jobs] for j in range(n_jobs)]

        import inspect

        try:
            src_file = inspect.getfile(type(self))
        except TypeError:
            src_file = None
        for job_id in range(n_jobs):
            job_config = {
                "job_id": job_id,
                "block_list": job_blocks[job_id],
                "tmp_folder": self.tmp_folder,
                "config_dir": self.config_dir,
                "task_name": self.name_with_id,
                "target": self.target,
                "src_file": src_file,
                "global_config": self.global_config,
                "config": {**self.task_config, **task_specific_config},
            }
            config_mod.write_config(self.job_config_path(job_id), job_config)

        executor = EXECUTORS[self.target]()
        # first attempt pins the clock/stage baseline; block-granular
        # retries recurse back in here, so measuring per attempt would
        # report only the LAST attempt's cost in the status JSON
        if self._retry_count == 0:
            self._attempt_t0 = time.time()
            self._attempt_stages = stages_snapshot()
            self._attempt_bytes = bytes_snapshot()
            self._attempt_counts = counts_snapshot()
            # one correlation id per run_jobs invocation: every retry
            # attempt's span (and the status JSON) carries it, so a
            # trace viewer can group attempts of the same logical task
            self._corr_id = uuid.uuid4().hex[:12]
        stages_before = self._attempt_stages
        # correlation scope: every span recorded inside the attempt
        # (worker-thread pool spans included — the stack is deliberately
        # process-global, see telemetry._Recorder) inherits this
        # attempt's 12-hex id in its Chrome-trace args, so a histogram
        # outlier joins back to its Perfetto spans
        with telemetry.correlation(self._corr_id), \
                telemetry.span(self.name_with_id, cat="attempt",
                               correlation_id=self._corr_id,
                               attempt=self._retry_count, n_jobs=n_jobs,
                               n_blocks=(None if block_list is None
                                         else len(block_list))):
            executor.run(self, list(range(n_jobs)))
        elapsed = time.time() - self._attempt_t0

        # -- success detection + block-granular retry ------------------
        failed_jobs = [j for j in range(n_jobs)
                       if not parse_job_success(self.log_path(j), j)]
        if not failed_jobs:
            self._write_status(n_jobs, block_list, elapsed,
                               stages_delta(stages_before),
                               bytes_delta(self._attempt_bytes),
                               counts_delta(self._attempt_counts))
            return

        if (not self.allow_retry
                or self._retry_count >= int(self.global_config.get("max_num_retries", 0))
                or block_list is None):
            self._fail(failed_jobs)

        # majority-of-jobs-failed heuristic: fundamentally broken, don't retry
        # (reference: cluster_tasks.py:127-134)
        if len(failed_jobs) > n_jobs / 2:
            self._fail(failed_jobs)

        processed: Set[int] = set()
        for j in range(n_jobs):
            if j in failed_jobs:
                processed |= parse_processed_blocks(self.log_path(j))
            else:
                processed |= set(job_blocks[j] or [])
        failed_blocks = [b for b in block_list if b not in processed]
        self._retry_count += 1
        log(f"{self.name_with_id}: retry {self._retry_count} with "
            f"{len(failed_blocks)} failed blocks")
        self.run_jobs(failed_blocks, task_specific_config, n_jobs=n_jobs,
                      consecutive_blocks=consecutive_blocks)

    def _run_jobs_multiprocess(self, block_list, task_specific_config,
                               n_jobs: Optional[int] = None,
                               consecutive_blocks: bool = False) -> None:
        """Cooperative execution across SPMD processes (multi-host mode,
        parallel/multihost.py): blockwise tasks shard one job per process
        (round-robin or consecutive); global tasks AND single-job tasks
        (n_jobs=1 callers own cross-block state, e.g. the fused chain's
        running offsets) run on the lead only.  Everyone meets at a
        filesystem barrier, then every process verifies ALL job logs over
        the shared store — the reference's many-nodes path
        (cluster_tasks.py:375-490) with processes instead of sbatch.

        Block-granular retry works IN-RUN like the single-process path
        (reference semantics, cluster_tasks.py:136-170): the shared logs
        are the consensus channel — after the barrier every process
        parses the SAME files, derives the SAME failed-block list, and
        re-enters its shard of it; no extra coordination needed."""
        from ..parallel import multihost as mh

        pc, pid = mh.process_count(), mh.process_index()
        global_job = (block_list is None or self.global_task
                      or n_jobs == 1)
        if global_job:
            n_jobs = 1
            job_blocks: List[Optional[List[int]]] = [
                None if block_list is None else list(block_list)]
            my_jobs = [0] if mh.is_lead() else []
        else:
            block_list = list(block_list)
            n_jobs = pc
            if consecutive_blocks:
                per = (len(block_list) + pc - 1) // pc
                job_blocks = [block_list[j * per:(j + 1) * per]
                              for j in range(pc)]
            else:
                job_blocks = [block_list[j::pc] for j in range(pc)]
            my_jobs = [pid] if job_blocks[pid] else []

        import inspect

        try:
            src_file = inspect.getfile(type(self))
        except TypeError:
            src_file = None
        for job_id in range(n_jobs):
            if not global_job and not job_blocks[job_id]:
                continue
            job_config = {
                "job_id": job_id, "block_list": job_blocks[job_id],
                "tmp_folder": self.tmp_folder, "config_dir": self.config_dir,
                "task_name": self.name_with_id, "target": self.target,
                "src_file": src_file,
                "global_config": self.global_config,
                "config": {**self.task_config, **task_specific_config},
            }
            if job_id == pid or (global_job and mh.is_lead()):
                config_mod.write_config(self.job_config_path(job_id),
                                        job_config)

        executor = EXECUTORS[self.target]()
        # same cross-attempt baseline as the single-process path: the
        # status must reflect the WHOLE task, not the final retry
        if self._retry_count == 0:
            self._attempt_t0 = time.time()
            self._attempt_stages = stages_snapshot()
            self._attempt_bytes = bytes_snapshot()
            self._attempt_counts = counts_snapshot()
            self._corr_id = uuid.uuid4().hex[:12]
        stages_before = self._attempt_stages
        if my_jobs:
            # process identity on the span: single-shard traces stay
            # self-describing before any merge
            with telemetry.correlation(self._corr_id), \
                    telemetry.span(self.name_with_id, cat="attempt",
                                   correlation_id=self._corr_id,
                                   attempt=self._retry_count,
                                   n_jobs=len(my_jobs),
                                   process_index=pid,
                                   process_count=pc):
                executor.run(self, my_jobs)
        # the jobs barrier waits for REAL work (on global tasks, peers sit
        # here for the lead's entire job) — default unbounded, overridable
        # via global config; the verdict/status barriers below are pure
        # bookkeeping and keep the short default
        mh.fs_barrier(self.tmp_folder, f"{self.name_with_id}_jobs",
                      timeout=self.global_config.get("barrier_timeout"))
        elapsed = time.time() - self._attempt_t0

        check_jobs = ([0] if global_job else
                      [j for j in range(n_jobs) if job_blocks[j]])
        # consensus WITHOUT messages: every process parses the same shared
        # logs (complete — everyone passed the jobs barrier) and derives
        # the identical verdict and failed-block list.  ALL parsing must
        # happen BEFORE the verdict barrier: a fast peer's retry
        # OVERWRITES its job log with a success log, and a slow peer
        # parsing it late would derive a different (smaller) failed-block
        # list — its shard assignment would then silently drop blocks
        failed = [j for j in check_jobs
                  if not parse_job_success(self.log_path(j), j)]
        processed: Set[int] = set()
        if failed and not global_job:
            for j in check_jobs:
                if j in failed:
                    processed |= parse_processed_blocks(self.log_path(j))
                else:
                    processed |= set(job_blocks[j] or [])
        mh.fs_barrier(self.tmp_folder, f"{self.name_with_id}_verdict")
        if failed:
            retryable = (self.allow_retry and not global_job
                         and self._retry_count < int(
                             self.global_config.get("max_num_retries", 0))
                         and len(failed) <= len(check_jobs) / 2)
            if not retryable:
                self._fail([j for j in failed if j == pid] or failed)
            failed_blocks = [b for b in block_list if b not in processed]
            self._retry_count += 1
            log(f"{self.name_with_id}: multiprocess retry "
                f"{self._retry_count} with {len(failed_blocks)} failed "
                "blocks")
            return self._run_jobs_multiprocess(
                failed_blocks, task_specific_config, n_jobs,
                consecutive_blocks=consecutive_blocks)
        if mh.is_lead():
            # single writer for the shared status file; its stages cover
            # the lead's own jobs (peers' inline stages stay local)
            self._write_status(n_jobs, block_list, elapsed,
                               stages_delta(stages_before),
                               bytes_delta(self._attempt_bytes),
                               counts_delta(self._attempt_counts))
        # peers must not observe the task incomplete (build() verifies
        # the target right after run) — wait for the lead's write
        mh.fs_barrier(self.tmp_folder, f"{self.name_with_id}_status")

    def _fail(self, failed_jobs: List[int]) -> None:
        # rename logs to *_failed.log so the target stays invalid and a driver
        # rerun redoes this task (reference: cluster_tasks.py:143-151)
        for j in failed_jobs:
            lp = self.log_path(j)
            try:
                os.replace(lp, lp.replace(".log", "_failed.log"))
            except FileNotFoundError:
                pass  # another process renamed it first (multiprocess)
        raise FailedJobsError(
            f"{self.name_with_id}: jobs {failed_jobs} failed; "
            f"see {os.path.join(self.tmp_folder, 'logs')}")

    def _write_status(self, n_jobs: int, block_list, elapsed: float,
                      stages: Optional[Dict[str, float]] = None,
                      moved_bytes: Optional[Dict[str, float]] = None,
                      stage_counts: Optional[Dict[str, int]] = None) -> None:
        runtimes = [parse_job_runtime(self.log_path(j)) for j in range(n_jobs)]
        runtimes = [r for r in runtimes if r is not None]
        # subprocess workers report their stages through the job log (the
        # driver-process accumulator only sees in-process executors)
        stages = dict(stages or {})
        moved_bytes = dict(moved_bytes or {})
        stage_counts = dict(stage_counts or {})
        for j in range(n_jobs):
            for k, v in parse_stage_times(self.log_path(j)).items():
                stages[k] = stages.get(k, 0.0) + v
            for k, v in parse_stage_times(self.log_path(j),
                                          _BYTES_LINE).items():
                moved_bytes[k] = moved_bytes.get(k, 0.0) + v
            for k, v in parse_stage_times(self.log_path(j),
                                          _COUNT_LINE).items():
                stage_counts[k] = int(stage_counts.get(k, 0) + v)
        # device-path share of the task wall: waits on device work plus
        # host<->device transfers.  The complement is host compute + store
        # IO + scheduling — where the card idles.
        # Stages timed in overlapped pool workers use non-device names
        # (fetch-*, host-*); the clamp below keeps the ratio meaningful
        # even if overlapping device-prefixed stages ever double-count
        device_time = sum(v for k, v in stages.items()
                          if k.startswith(_DEVICE_STAGE_PREFIXES))
        device_time = min(device_time, elapsed)
        status = {
            "task": self.name_with_id,
            "n_jobs": n_jobs,
            "n_blocks": None if block_list is None else len(block_list),
            "wall_time": elapsed,
            "job_runtime_mean": float(sum(runtimes) / len(runtimes)) if runtimes else None,
            "retries": self._retry_count,
            "stages": {k: round(v, 3) for k, v in sorted(
                stages.items(), key=lambda kv: -kv[1])},
            "device_busy_frac": (round(device_time / elapsed, 4)
                                 if elapsed > 0 else None),
            "bytes_moved": {k: int(v) for k, v in sorted(
                moved_bytes.items(), key=lambda kv: -kv[1])},
            # how many times each stage was entered: the dispatch-model
            # observability (the per-block path shows one sync-execute
            # wait per block)
            "stage_counts": {k: int(v) for k, v in sorted(
                stage_counts.items(), key=lambda kv: -kv[1])},
            # live-buffer ledger at task completion: bytes pinned by the
            # long-lived caches (fragment/raw) — the part of
            # RSS the per-stage accounting can't see
            "ledger": ledger_snapshot(),
            "correlation_id": self._corr_id,
        }
        # fields a job recorded for the status itself (status_fields: a
        # mesh-aware task's shards and distinct devices)
        for j in range(n_jobs):
            status.update(parse_status_fields(self.log_path(j)))
        # multi-process runs are self-describing per process: which
        # process wrote this status, out of how many
        from ..parallel import multihost as mh

        if mh.process_count() > 1:
            status["process_index"] = mh.process_index()
            status["process_count"] = mh.process_count()
        config_mod.write_config(self.output().path, status)

    # -- worker side ----------------------------------------------------
    @classmethod
    def process_job(cls, job_id: int, job_config: Dict[str, Any], log_fn) -> None:
        raise NotImplementedError

