"""Structured span tracing (L0 observability).

The runtime's ``stage_counts`` accumulators (core/runtime.py) say *how
much* time each stage took; this module adds *when* it ran and on which
thread:

* a thread-safe, **off-by-default** span recorder — every
  ``runtime.stage(...)`` / ``stage_add(...)`` accumulation also emits a
  span when enabled (task -> job -> block -> stage hierarchy via a
  per-thread span stack; monotonic start/end timestamps; bounded ring
  buffer);
* a Chrome trace-event JSON exporter (:func:`export_chrome_trace`) that
  loads in Perfetto / chrome://tracing;
* host RSS and device-memory probes (the device side reads
  ``torch.cuda.memory_stats``) stamped on block spans at drain points.

Telemetry off is free: every instrumentation site guards on
:func:`enabled` (one attribute read), and spans are emitted AFTER the
accumulator update in ``runtime.stage_add``, so status JSONs are
identical with telemetry on or off.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

#: stage-name prefixes attributed to the DEVICE PATH (device compute and
#: host<->device transfers).  Shared with core/runtime.py's
#: ``device_busy_frac`` accounting — one definition, so span-derived
#: numbers and the accumulator never disagree about what counts as
#: device time.
DEVICE_STAGE_PREFIXES = ("sync-", "d2h-", "h2d-", "dispatch", "cap-retry",
                         "device-")


# ---------------------------------------------------------------------------

class Span(NamedTuple):
    sid: int                    # recorder-unique span id
    parent: Optional[int]       # enclosing span's sid (per-thread stack)
    name: str
    cat: str                    # task | job | block | stage | request | ...
    t0: float                   # recorder-clock seconds (monotonic)
    t1: float
    tid: int                    # OS thread ident (remapped at export)
    tname: str
    attrs: Dict[str, Any]


_DEFAULT_RING = 65536


class _Recorder:
    """Module-global span sink.  ``enabled`` is a plain attribute so the
    off-path cost at every instrumentation site is one attribute read."""

    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.clock: Callable[[], float] = time.perf_counter
        self.spans: deque = deque(maxlen=_DEFAULT_RING)
        self._next_sid = itertools.count(1)
        self._tls = threading.local()
        # correlation-id stack (module-global, NOT thread-local, on
        # purpose: run_jobs attempts serialize, and executor WORKER
        # threads spawned inside an attempt must inherit its id — that
        # is exactly the join key the exemplar-style linking needs)
        self.corr: List[str] = []

    def stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st


_REC = _Recorder()


def enabled() -> bool:
    return _REC.enabled


def now() -> float:
    """The recorder's clock (injectable via :func:`configure`)."""
    return _REC.clock()


def configure(enabled: Optional[bool] = None,
              ring_size: Optional[int] = None,
              clock: Optional[Callable[[], float]] = None) -> None:
    """Reconfigure the recorder.  ``None`` leaves a setting unchanged.
    ``ring_size`` rebuilds the ring preserving the newest spans;
    ``clock`` injects a timestamp source (fixed clocks make export
    output deterministic for tests)."""
    with _REC.lock:
        if ring_size is not None:
            ring_size = max(int(ring_size), 1)
            if ring_size != _REC.spans.maxlen:
                _REC.spans = deque(_REC.spans, maxlen=ring_size)
        if clock is not None:
            _REC.clock = clock
        if enabled is not None:
            _REC.enabled = bool(enabled)


class _CorrCtx:
    __slots__ = ("cid",)

    def __init__(self, cid: str):
        self.cid = cid

    def __enter__(self):
        _REC.corr.append(self.cid)
        return self

    def __exit__(self, *exc):
        if _REC.corr and _REC.corr[-1] == self.cid:
            _REC.corr.pop()
        return False


def correlation(corr_id: str) -> _CorrCtx:
    """Scope a correlation id: every span recorded inside (on ANY
    thread — attempts serialize, so the global stack is safe) carries it
    as a ``corr`` attr, which the Chrome-trace exporter emits into the
    event ``args``.  That is the join key that links histogram outliers
    (status JSONs carry the same 12-hex retry correlation id) back to
    their Perfetto spans."""
    return _CorrCtx(str(corr_id))


def _attach_corr(attrs: Dict[str, Any]) -> Dict[str, Any]:
    if _REC.corr and "corr" not in attrs:
        attrs["corr"] = _REC.corr[-1]
    return attrs


def record(name: str, t0: float, t1: float, cat: str = "stage",
           parent: Optional[int] = None, **attrs) -> Optional[int]:
    """Record a completed span post-hoc (the hook ``runtime.stage_add``
    uses — the duration was already measured, so the span costs one ring
    append).  ``parent`` defaults to the calling thread's innermost open
    :func:`span`.  No-op (returns None) when disabled."""
    if not _REC.enabled:
        return None
    th = threading.current_thread()
    if parent is None:
        stack = _REC.stack()
        parent = stack[-1] if stack else None
    with _REC.lock:
        sid = next(_REC._next_sid)
        _REC.spans.append(Span(sid, parent, name, cat, float(t0),
                               float(t1), th.ident or 0, th.name,
                               _attach_corr(dict(attrs))))
    return sid


def record_stage(name: str, seconds: float, count: int = 1
                 ) -> Optional[int]:
    """The ``stage_add`` hook: a stage accumulation of ``seconds`` that
    ended now.  Emits nothing when disabled."""
    if not _REC.enabled:
        return None
    end = _REC.clock()
    attrs = {"count": int(count)} if count != 1 else {}
    return record(name, end - float(seconds), end, cat="stage", **attrs)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        """No-op twin of :meth:`_SpanCtx.annotate`."""


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("name", "cat", "attrs", "sid", "parent", "_t0")

    def __init__(self, name: str, cat: str, attrs: Dict[str, Any]):
        self.name, self.cat, self.attrs = name, cat, attrs

    def __enter__(self):
        stack = _REC.stack()
        self.parent = stack[-1] if stack else None
        with _REC.lock:
            self.sid = next(_REC._next_sid)
        stack.append(self.sid)
        self._t0 = _REC.clock()
        return self

    def __exit__(self, *exc):
        t1 = _REC.clock()
        stack = _REC.stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        th = threading.current_thread()
        with _REC.lock:
            _REC.spans.append(Span(self.sid, self.parent, self.name,
                                   self.cat, self._t0, t1, th.ident or 0,
                                   th.name, _attach_corr(self.attrs)))
        return False

    def annotate(self, **attrs):
        """Attach attrs to the still-open span (recorded at __exit__) —
        how drain points stamp memory high-water marks on block/slab
        spans after the block's work ran."""
        self.attrs.update(attrs)


def span(name: str, cat: str = "stage", **attrs):
    """Context manager opening a span; children recorded on the same
    thread (nested ``span``s, ``runtime.stage`` blocks, ``record`` calls)
    link to it as their parent.  When disabled, returns a shared no-op
    context — the instrumentation site pays one attribute read."""
    if not _REC.enabled:
        return _NULL_SPAN
    return _SpanCtx(name, cat, attrs)


def spans_snapshot() -> List[Span]:
    with _REC.lock:
        return list(_REC.spans)



# ---------------------------------------------------------------------------
# memory probe (host RSS + device HBM) and counter-track sampling
# ---------------------------------------------------------------------------

_GIB = 1024.0 ** 3


def host_memory_bytes() -> Dict[str, int]:
    """Current host memory: ``{"rss": bytes, "hwm": peak bytes}``.

    Primary source is ``/proc/self/status`` (VmRSS/VmHWM, kB lines);
    fallback is ``resource.getrusage`` whose ``ru_maxrss`` is KiB on
    Linux — both are converted with 1024-based factors (the ad-hoc
    ``/1e6`` reads this helper replaces under-stated GiB by ~5%)."""
    out = {"rss": 0, "hwm": 0}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["hwm"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    if not out["hwm"]:
        try:
            import resource

            kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            out["hwm"] = int(kib) * 1024
            out["rss"] = out["rss"] or out["hwm"]
        except Exception:
            pass
    return out


def device_memory_bytes() -> Optional[Dict[str, int]]:
    """Device memory from ``torch.cuda.memory_stats()``:
    ``{"in_use": bytes, "peak": bytes}``, or None when torch was not
    imported or has no initialised card (never an import or device-init
    side effect)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    in_use = stats.get("allocated_bytes.all.current")
    if in_use is None:
        return None
    peak = stats.get("allocated_bytes.all.peak", in_use)
    return {"in_use": int(in_use), "peak": int(peak)}


def memory_watermarks() -> Dict[str, float]:
    """Current memory readings as span attrs (GiB, ``mem_`` prefix):
    host rss/hwm always, device in-use/peak where the allocator exposes
    stats.  Drain points stamp these on ``block:``/``slab:`` spans via
    :meth:`_SpanCtx.annotate`."""
    host = host_memory_bytes()
    out = {"mem_host_rss_gb": round(host["rss"] / _GIB, 4),
           "mem_host_hwm_gb": round(host["hwm"] / _GIB, 4)}
    dev = device_memory_bytes()
    if dev is not None:
        out["mem_dev_in_use_gb"] = round(dev["in_use"] / _GIB, 4)
        out["mem_dev_peak_gb"] = round(dev["peak"] / _GIB, 4)
    return out


def sample_memory(**attrs) -> Optional[int]:
    """Record one memory counter sample (a zero-duration span with
    ``cat='counter'``): the exporter turns each numeric attr into a
    Chrome 'C' event, so the samples render as Perfetto counter tracks
    (host_rss_gb / host_hwm_gb / dev_in_use_gb / dev_peak_gb).  No-op
    when disabled."""
    if not _REC.enabled:
        return None
    vals: Dict[str, Any] = {}
    host = host_memory_bytes()
    vals["host_rss_gb"] = round(host["rss"] / _GIB, 4)
    vals["host_hwm_gb"] = round(host["hwm"] / _GIB, 4)
    dev = device_memory_bytes()
    if dev is not None:
        vals["dev_in_use_gb"] = round(dev["in_use"] / _GIB, 4)
        vals["dev_peak_gb"] = round(dev["peak"] / _GIB, 4)
    vals.update(attrs)
    t = _REC.clock()
    return record("mem", t, t, cat="counter", **vals)


def annotate_memory(sp) -> None:
    """Drain-point hook: stamp memory watermarks on the open span AND
    drop a counter sample at the same instant.  One ``enabled`` check —
    telemetry off pays a single attribute read."""
    if not _REC.enabled:
        return
    sp.annotate(**memory_watermarks())
    sample_memory()


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def _process_events(spans: Sequence[Span], pid: int, base: float,
                    process_name: str) -> List[Dict[str, Any]]:
    """One process's Chrome events: process/thread 'M' metadata, 'X'
    complete events for regular spans, and 'C' counter events (their
    own Perfetto tracks) for ``cat='counter'`` samples — each numeric
    attr of a counter span becomes one named counter series."""
    tid_map: Dict[int, int] = {}
    tnames: Dict[int, str] = {}
    for s in sorted(spans, key=lambda s: s.sid):
        if s.cat == "counter":
            continue
        if s.tid not in tid_map:
            tid_map[s.tid] = len(tid_map) + 1
            tnames[tid_map[s.tid]] = s.tname
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for tid in sorted(tnames):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tnames[tid]}})
    for s in sorted(spans, key=lambda s: (s.t0, s.sid)):
        if s.cat == "counter":
            for key in sorted(s.attrs):
                val = s.attrs[key]
                if isinstance(val, bool) or \
                        not isinstance(val, (int, float)):
                    continue
                events.append({
                    "ph": "C", "name": key, "pid": pid, "tid": 0,
                    "ts": round((s.t0 - base) * 1e6, 3),
                    "args": {"value": val},
                })
            continue
        args = dict(s.attrs)
        args["sid"] = s.sid
        if s.parent is not None:
            args["parent"] = s.parent
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat, "pid": pid,
            "tid": tid_map[s.tid],
            "ts": round((s.t0 - base) * 1e6, 3),
            "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
            "args": args,
        })
    return events


def _write_trace_events(path: str, events: List[Dict[str, Any]]) -> int:
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True, separators=(",", ":"),
                  default=str)
    os.replace(tmp, path)
    return len(events)


def export_chrome_trace(path: str,
                        spans: Optional[Sequence[Span]] = None) -> int:
    """Write the recorded spans as Chrome trace-event JSON (the
    ``traceEvents`` object format, complete 'X' events with
    microsecond ``ts``/``dur``, 'C' counter events for memory samples)
    and return the event count.

    Determinism: timestamps are rebased to the earliest span, thread
    ids are remapped to dense integers in first-recorded order, and
    ``pid`` is pinned — identical recordings (fixed clock, one thread)
    export byte-identical files.  Written atomically."""
    if spans is None:
        spans = spans_snapshot()
    base = min((s.t0 for s in spans), default=0.0)
    events = _process_events(spans, 1, base, "cluster_tools_tpu_torch")
    return _write_trace_events(path, events)

