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
  ``torch.cuda.memory_stats``) stamped on block spans at drain points;
* the resident server's metrics surface: cumulative-bucket latency
  histograms, a Prometheus text-format writer with a promtool-style lint,
  the registries of canonical stage and metric-family names, and the
  crash flight recorder;
* span-derived rollups (device busy seconds and fraction, the merged
  busy timeline and pipeline bubbles, the queue-wait histogram, the
  memory view; :func:`summary`), per-process trace shards merged onto one
  timeline (:func:`merge_chrome_traces`), and the rollup-vs-rollup
  regression gate (:func:`diff_rollups`).

Telemetry off is free: every instrumentation site guards on
:func:`enabled` (one attribute read), and spans are emitted AFTER the
accumulator update in ``runtime.stage_add``, so status JSONs are
identical with telemetry on or off.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import re
import threading
import time
from collections import Counter, deque
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, \
    Optional, Sequence, Tuple, Union

#: stage-name prefixes attributed to the DEVICE PATH (device compute and
#: host<->device transfers) by the span rollups below
#: (:func:`device_busy_seconds`, :func:`busy_timeline`).
DEVICE_STAGE_PREFIXES = ("sync-", "d2h-", "h2d-", "dispatch", "cap-retry",
                         "device-")

#: every stage name the package passes to ``runtime.stage`` /
#: ``stage_add`` / ``stage_bytes``.  A typo'd literal would silently open
#: a new bucket in ``stage_counts``; tests/test_torch_serve_telemetry.py
#: walks the package for stage literals and fails on any name missing
#: here.
STAGE_REGISTRY = {
    # device path (see DEVICE_STAGE_PREFIXES)
    "sync-compile",     # the server's warm-up: library builds + first block
    "sync-execute",     # waits on a block's device work
    "sync-stats",       # hybrid stage B waits
    "dispatch",         # device work enqueue
    "cap-retry",        # pair-capacity overflow redo
    "h2d-upload",       # host -> device volume uploads
    # device -> host
    "d2h-compact", "d2h-dense", "d2h-edges", "d2h-labels", "d2h-rle",
    "device-cc", "device-rle", "device-ws-redo",
    # host path (never device time)
    "host-build", "host-compact", "host-decode", "host-densify",
    "host-fallback", "host-flood", "host-map", "host-reduce", "host-scan",
    "host-solve", "predict",
    "host-pad",         # the fused pass's reflect-padded input volume
    # the fused chain's host graph tasks, one stage per block or job
    "host-assemble", "host-merge", "host-map-ids", "host-features",
    "host-costs",
    # downloads overlapped with the next block's device work
    "fetch-dense", "fetch-rle",
    # loop-body counter of the hooking connected components
    "cc-bodies",
    # store IO at the call sites; inside them, per chunk (core/storage.py)
    "store-read", "store-write",
    "store-encode", "store-io", "store-lock-wait", "store-decode",
    "store-io-read",
    # the .npz tables handed from task to task
    "tmp-read", "tmp-write",
    # a thread blocked on an unfinished BoundedPool task
    "pool-wait",
    # interactive proofreading lane (edits/)
    "edit:resolve", "edit:solve", "edit:patch", "edit:write",
}


def register_stage(name: str) -> str:
    """Register an extension stage name (returns it, for inline use)."""
    STAGE_REGISTRY.add(name)
    return name


def is_registered(name: str) -> bool:
    return name in STAGE_REGISTRY


#: every Prometheus metric FAMILY name the package emits through
#: :func:`write_prometheus` (the same discipline as STAGE_REGISTRY).
METRIC_REGISTRY = {
    # runtime counters (core/runtime.py metrics_families)
    "ctt_stage_seconds_total", "ctt_stage_entries_total",
    "ctt_stage_bytes_total", "ctt_exec_cache_events_total",
    "ctt_exec_cache_hit_ratio",
    # server gauges/counters/histograms (core/server.py write_metrics)
    "ctt_server_queue_depth", "ctt_server_in_flight",
    "ctt_server_requests_served_total",
    "ctt_server_request_latency_seconds",
    "ctt_server_queue_wait_seconds",
    "ctt_server_tenant_latency_seconds",
    "ctt_server_overload", "ctt_server_admission_rejected_total",
    # SLO engine (core/slo.py via server metrics)
    "ctt_slo_burn_rate", "ctt_slo_compliance",
    # telemetry self-metrics (metrics_families below)
    "ctt_telemetry_dropped_spans_total", "ctt_telemetry_ring_spans",
    "ctt_memory_host_gb", "ctt_memory_device_gb",
    "ctt_telemetry_flight_records_total",
    # live-buffer ledger gauges (core/runtime.py metrics_families)
    "ctt_ledger_bytes", "ctt_ledger_entries",
    # interactive proofreading (edits/service.py metrics_families)
    "ctt_edit_applied_total", "ctt_edit_subproblems_total",
    "ctt_edit_warm_reused_total", "ctt_edit_fallback_total",
    "ctt_edit_blocks_rewritten_total", "ctt_edit_round_trip_seconds",
}


def register_metric(name: str) -> str:
    """Register an extension metric family name (returns it)."""
    METRIC_REGISTRY.add(name)
    return name


def is_registered_metric(name: str) -> bool:
    return name in METRIC_REGISTRY


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
        self.dropped = 0
        self._next_sid = itertools.count(1)
        self._tls = threading.local()
        # correlation-id stack (module-global, NOT thread-local, on
        # purpose: run_jobs attempts serialize, and executor WORKER
        # threads spawned inside an attempt must inherit its id — that
        # is exactly the join key the exemplar-style linking needs)
        self.corr: List[str] = []
        # (perf_counter s, Unix epoch ns) read back to back when the
        # recorder is enabled: places spans on other tools' timelines
        self.anchor: Optional[Tuple[float, int]] = None

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
        if _REC.enabled and _REC.anchor is None:
            _REC.anchor = _take_anchor()


def _take_anchor(tries: int = 5) -> Tuple[float, int]:
    """``time.perf_counter()`` (the recorder's own clock) and
    ``time.time_ns()`` read back to back: of ``tries`` reads, the one
    whose two ``perf_counter`` reads lie closest, at their middle."""
    best = None
    for _ in range(tries):
        a = time.perf_counter()
        unix_ns = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2, unix_ns)
    return best[1], best[2]


def clock_anchor() -> Tuple[float, int]:
    """(``perf_counter`` seconds, Unix epoch nanoseconds) of one instant,
    taken when the recorder was enabled (now, if it has not been)."""
    with _REC.lock:
        if _REC.anchor is None:
            _REC.anchor = _take_anchor()
        return _REC.anchor


def reset() -> None:
    """Restore defaults: disabled, empty default-size ring, real clock,
    span ids from 1, flight-recorder counter zeroed (tests call this so
    telemetry state never leaks between tests)."""
    global _FLIGHT_COUNT
    with _REC.lock:
        _REC.enabled = False
        _REC.clock = time.perf_counter
        _REC.spans = deque(maxlen=_DEFAULT_RING)
        _REC.dropped = 0
        _REC._next_sid = itertools.count(1)
        _REC._tls = threading.local()
        _REC.corr = []
        _REC.anchor = None
    with _FLIGHT_LOCK:
        _FLIGHT_COUNT = 0


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


def current_correlation() -> Optional[str]:
    return _REC.corr[-1] if _REC.corr else None


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
        if len(_REC.spans) == _REC.spans.maxlen:
            _REC.dropped += 1
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
            if len(_REC.spans) == _REC.spans.maxlen:
                _REC.dropped += 1
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


def dropped_count() -> int:
    return _REC.dropped


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


def host_peak_rss_gb() -> float:
    """Peak host RSS in GiB (1024-based): the one helper every
    ``peak_rss_gb`` field records."""
    return host_memory_bytes()["hwm"] / _GIB


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


class MemorySampler:
    """Optional background sampling probe: one daemon thread calling
    :func:`sample_memory` every ``interval_s`` while telemetry is
    enabled.  ``stop()`` joins it; usable as a context manager."""

    def __init__(self, interval_s: float = 0.25):
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MemorySampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="mem-sampler", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            sample_memory()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


#: counter-series / watermark-attr names whose max is the HOST memory
#: peak, resp. the DEVICE memory peak
_HOST_PEAK_SERIES = ("host_hwm_gb", "host_rss_gb",
                     "mem_host_hwm_gb", "mem_host_rss_gb")
_DEVICE_PEAK_SERIES = ("dev_peak_gb", "dev_in_use_gb",
                      "mem_dev_peak_gb", "mem_dev_in_use_gb")


def memory_rollup(spans: Optional[Sequence[Span]] = None
                  ) -> Dict[str, Any]:
    """Memory view of a trace: per-series counter stats (from
    ``cat='counter'`` samples), per-span-name watermarks (from ``mem_*``
    attrs the drain points stamp on block/slab/stage spans), and the host
    and device peaks.  Peaks are None when the trace carries no memory
    samples.  The flight recorder writes it into every dump."""
    if spans is None:
        spans = spans_snapshot()
    counters: Dict[str, Dict[str, Any]] = {}
    watermarks: Dict[str, Dict[str, float]] = {}
    for s in spans:
        if s.cat == "counter":
            for k, v in s.attrs.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                c = counters.setdefault(k, {"n": 0, "max": None,
                                            "last": None})
                c["n"] += 1
                c["max"] = float(v) if c["max"] is None \
                    else max(c["max"], float(v))
                c["last"] = float(v)
        else:
            mem = {k: float(v) for k, v in s.attrs.items()
                   if k.startswith("mem_")
                   and not isinstance(v, bool)
                   and isinstance(v, (int, float))}
            if mem:
                d = watermarks.setdefault(s.name, {})
                for k, v in mem.items():
                    d[k] = max(d.get(k, v), v)
    peaks = {"host": None, "device": None}
    for which, series in (("host", _HOST_PEAK_SERIES),
                          ("device", _DEVICE_PEAK_SERIES)):
        cands = [counters[k]["max"] for k in series if k in counters]
        cands += [wm[k] for wm in watermarks.values()
                  for k in series if k in wm]
        if cands:
            peaks[which] = round(max(cands), 4)
    return {
        "peak_host_rss_gb": peaks["host"],
        "peak_device_gb": peaks["device"],
        "counters": {k: {"n": c["n"],
                         "max": round(c["max"], 4),
                         "last": round(c["last"], 4)}
                     for k, c in sorted(counters.items())},
        "span_watermarks": {name: {k: round(v, 4)
                                   for k, v in sorted(wm.items())}
                            for name, wm in sorted(watermarks.items())},
    }



# ---------------------------------------------------------------------------
# span-derived rollups
# ---------------------------------------------------------------------------

def _merge_intervals(iv: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    """Union-merge of (start, end) intervals (sorted output)."""
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(iv):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _device_stage_spans(spans: Sequence[Span]) -> List[Span]:
    return [s for s in spans if s.cat == "stage"
            and s.name.startswith(DEVICE_STAGE_PREFIXES)]


def device_busy_seconds(spans: Optional[Sequence[Span]] = None) -> float:
    """SUM of device-path stage span durations (host-clock waits on and
    transfers to and from the device, not the device's own time)."""
    if spans is None:
        spans = spans_snapshot()
    return float(sum(s.t1 - s.t0 for s in _device_stage_spans(spans)))


def busy_timeline(spans: Optional[Sequence[Span]] = None,
                  prefixes: Tuple[str, ...] = DEVICE_STAGE_PREFIXES
                  ) -> List[Tuple[float, float]]:
    """Union-merged (start, end) intervals where at least one stage with
    a matching prefix was active — the device-busy timeline.  (One card,
    one merged timeline; callers with multi-device traces can filter
    spans by a ``device`` attr before merging.)"""
    if spans is None:
        spans = spans_snapshot()
    return _merge_intervals(
        [(s.t0, s.t1) for s in spans if s.cat == "stage"
         and s.name.startswith(prefixes)])


def device_busy_fraction(wall: Optional[float] = None,
                         spans: Optional[Sequence[Span]] = None
                         ) -> Optional[float]:
    """Device-busy seconds / wall (clamped to 1.0).
    ``wall`` defaults to the trace window (earliest t0 to latest t1)."""
    if spans is None:
        spans = spans_snapshot()
    if wall is None:
        wall = trace_window(spans)
    if not wall:
        return None
    return min(device_busy_seconds(spans) / wall, 1.0)


def pipeline_bubble_fraction(spans: Optional[Sequence[Span]] = None,
                             wall: Optional[float] = None
                             ) -> Optional[float]:
    """Fraction of the trace window where NO device-path stage was
    active — the pipeline-bubble metric.  Uses the union-merged
    timeline (overlapping stages don't double-count)."""
    if spans is None:
        spans = spans_snapshot()
    if wall is None:
        wall = trace_window(spans)
    if not wall:
        return None
    covered = sum(t1 - t0 for t0, t1 in busy_timeline(spans))
    return max(1.0 - covered / wall, 0.0)


def trace_window(spans: Optional[Sequence[Span]] = None) -> float:
    if spans is None:
        spans = spans_snapshot()
    if not spans:
        return 0.0
    return max(s.t1 for s in spans) - min(s.t0 for s in spans)


_DEFAULT_WAIT_BINS = (0.001, 0.01, 0.1, 1.0, 10.0)


def queue_wait_histogram(bins: Sequence[float] = _DEFAULT_WAIT_BINS,
                         spans: Optional[Sequence[Span]] = None
                         ) -> Dict[str, Any]:
    """Prometheus-style cumulative histogram over ``cat='queue-wait'``
    span durations (BoundedPool submit->start waits, server request
    queue waits): ``{"buckets": {"0.01": n, ..., "+Inf": n}, "count",
    "sum"}``."""
    if spans is None:
        spans = spans_snapshot()
    waits = [s.t1 - s.t0 for s in spans if s.cat == "queue-wait"]
    buckets = {}
    for b in bins:
        buckets[repr(float(b))] = sum(1 for w in waits if w <= b)
    buckets["+Inf"] = len(waits)
    return {"buckets": buckets, "count": len(waits),
            "sum": round(float(sum(waits)), 6)}


def rollup_spans(spans: Sequence[Span], wall: Optional[float] = None,
                 dropped: int = 0) -> Dict[str, Any]:
    """The rollup computation over an EXPLICIT span list — what
    :func:`summary` applies to the live ring and
    :func:`merge_chrome_traces` applies to a merged multi-process
    trace."""
    window = trace_window(spans)
    if wall is None:
        wall = window
    stage_seconds: Dict[str, float] = {}
    stage_entries: Dict[str, int] = {}
    for s in spans:
        if s.cat != "stage":
            continue
        stage_seconds[s.name] = stage_seconds.get(s.name, 0.0) \
            + (s.t1 - s.t0)
        stage_entries[s.name] = stage_entries.get(s.name, 0) \
            + int(s.attrs.get("count", 1))
    busy = device_busy_seconds(spans)
    merged = sum(t1 - t0 for t0, t1 in busy_timeline(spans))
    return {
        "n_spans": len(spans),
        "dropped": dropped,
        "by_cat": dict(Counter(s.cat for s in spans)),
        "window_s": round(window, 4),
        "wall_s": round(wall, 4) if wall else None,
        "stage_seconds": {k: round(v, 4) for k, v in sorted(
            stage_seconds.items(), key=lambda kv: -kv[1])},
        "stage_entries": dict(sorted(stage_entries.items(),
                                     key=lambda kv: -kv[1])),
        "device_busy_s": round(busy, 4),
        "device_busy_timeline_s": round(merged, 4),
        "device_busy_frac": (round(min(busy / wall, 1.0), 4)
                             if wall else None),
        "pipeline_bubble_frac": (round(max(1.0 - merged / wall, 0.0), 4)
                                 if wall else None),
        "queue_wait": queue_wait_histogram(spans=spans),
        "memory": memory_rollup(spans),
    }


def summary(wall: Optional[float] = None) -> Dict[str, Any]:
    """One-call rollup of the recorded trace: span counts by category,
    per-stage second sums, device-busy (sum AND merged-timeline views),
    bubble fraction, queue-wait histogram, memory rollup, ring drops.
    ``wall`` (e.g. the measured workflow wall) scopes the busy fraction;
    defaults to the trace window."""
    return rollup_spans(spans_snapshot(), wall=wall,
                        dropped=dropped_count())


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


def _write_trace_events(path: str, events: List[Dict[str, Any]],
                        payload: Optional[Dict[str, Any]] = None) -> int:
    """Write ``events`` atomically as the ``traceEvents`` of ``payload``
    (a file's other top-level keys; by default only the display unit)."""
    payload = dict(payload or {"displayTimeUnit": "ms"},
                   traceEvents=events)
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True, separators=(",", ":"),
                  default=str)
    os.replace(tmp, path)
    return len(events)


def export_chrome_trace(path: str,
                        spans: Optional[Sequence[Span]] = None,
                        profiler_trace: Optional[str] = None) -> int:
    """Write the recorded spans as Chrome trace-event JSON (the
    ``traceEvents`` object format, complete 'X' events with
    microsecond ``ts``/``dur``, 'C' counter events for memory samples)
    and return the event count.

    Determinism: timestamps are rebased to the earliest span, thread
    ids are remapped to dense integers in first-recorded order, and
    ``pid`` is pinned — identical recordings (fixed clock, one thread)
    export byte-identical files.  Written atomically.

    ``profiler_trace`` is the path of a ``torch.profiler`` trace
    (``prof.export_chrome_trace``): the file written then holds that
    trace's events and keys, and the spans as a process of their own on
    its timeline, so each device gap lies under the host stage open
    then.  A profiler event's ``ts`` is Unix-epoch microseconds less the
    file's ``baseTimeNanoseconds``; the spans get there through
    :func:`clock_anchor`."""
    if spans is None:
        spans = spans_snapshot()
    if profiler_trace is None:
        base = min((s.t0 for s in spans), default=0.0)
        events = _process_events(spans, 1, base, "cluster_tools_tpu_torch")
        return _write_trace_events(path, events)
    with open(profiler_trace) as f:
        doc = json.load(f)
    prof_events = list(doc.pop("traceEvents", None) or [])
    perf0, unix_ns = clock_anchor()
    # the recorder clock's reading at the profiler file's ts 0
    base = perf0 - (unix_ns - int(doc.get("baseTimeNanoseconds", 0))) / 1e9
    pids = [e["pid"] for e in prof_events
            if isinstance(e.get("pid"), int) and
            not isinstance(e.get("pid"), bool)]
    pid = max(pids, default=0) + 1
    events = prof_events + _process_events(spans, pid, base,
                                           "cluster_tools_tpu_torch")
    return _write_trace_events(path, events, doc)


def _span_to_dict(s: Span) -> Dict[str, Any]:
    return {"sid": s.sid, "parent": s.parent, "name": s.name,
            "cat": s.cat, "t0": s.t0, "t1": s.t1, "tid": s.tid,
            "tname": s.tname, "attrs": s.attrs}


def _span_from_dict(d: Dict[str, Any]) -> Span:
    return Span(int(d["sid"]), d.get("parent"), d["name"], d["cat"],
                float(d["t0"]), float(d["t1"]), int(d.get("tid", 0)),
                d.get("tname", ""), dict(d.get("attrs") or {}))


def export_trace_shard(path: str, process_index: int = 0,
                       process_count: int = 1,
                       wall_anchor: Optional[float] = None,
                       perf_anchor: Optional[float] = None,
                       spans: Optional[Sequence[Span]] = None) -> int:
    """Write one process's RAW spans plus its clock anchors as a trace
    SHARD (JSON).  The recorder clock (``perf_counter``) is not
    comparable across processes; the (wall, perf) anchor pair — taken
    at one barrier by every process — lets
    :func:`merge_chrome_traces` rebase every shard onto one shared
    timeline.  Returns the span count; written atomically."""
    if spans is None:
        spans = spans_snapshot()
    if wall_anchor is None:
        wall_anchor = time.time()
    if perf_anchor is None:
        perf_anchor = _REC.clock()
    payload = {
        "process_index": int(process_index),
        "process_count": int(process_count),
        "wall_anchor": float(wall_anchor),
        "perf_anchor": float(perf_anchor),
        "dropped": dropped_count(),
        "spans": [_span_to_dict(s) for s in spans],
    }
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True, separators=(",", ":"),
                  default=str)
    os.replace(tmp, path)
    return len(payload["spans"])


def load_trace_shard(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def merge_chrome_traces(shard_paths: Sequence[str], out_path: str,
                        wall: Optional[float] = None) -> Dict[str, Any]:
    """Merge per-process trace shards into ONE Perfetto-loadable Chrome
    trace and one cross-mesh rollup.

    Each shard's spans are rebased onto a shared timeline:
    ``t' = (t - perf_anchor_i) + (wall_anchor_i - min_j wall_anchor_j)``
    — the file-handshake wall anchors estimate per-process clock offset,
    the perf anchors remove each process's arbitrary monotonic origin.
    Process ``i`` becomes Perfetto pid ``process_index + 1`` (the
    single-process exporter's pinned ``pid=1`` collides across shards).
    The merged span list feeds the SAME rollups as a single-process
    trace, so ``device_busy_s``/bubble fraction aggregate across the
    mesh; per-process ``device_busy_s`` is returned for cross-checks."""
    shards = [load_trace_shard(p) for p in shard_paths]
    if not shards:
        raise ValueError("merge_chrome_traces: no shards")
    shards.sort(key=lambda sh: int(sh.get("process_index", 0)))
    wall0 = min(float(sh.get("wall_anchor", 0.0)) for sh in shards)
    rebased: List[Tuple[int, List[Span]]] = []
    for sh in shards:
        pidx = int(sh.get("process_index", 0))
        off = (float(sh.get("wall_anchor", 0.0)) - wall0) \
            - float(sh.get("perf_anchor", 0.0))
        spans = [
            Span(s.sid, s.parent, s.name, s.cat, s.t0 + off, s.t1 + off,
                 s.tid, s.tname, s.attrs)
            for s in (_span_from_dict(d) for d in sh.get("spans") or [])
        ]
        rebased.append((pidx, spans))
    all_spans = [s for _, spans in rebased for s in spans]
    base = min((s.t0 for s in all_spans), default=0.0)
    events: List[Dict[str, Any]] = []
    processes: List[Dict[str, Any]] = []
    for (pidx, spans), sh in zip(rebased, shards):
        pid = pidx + 1
        events.extend(_process_events(spans, pid, base,
                                      f"cluster_tools_tpu_torch p{pidx}"))
        processes.append({
            "process_index": pidx,
            "pid": pid,
            "n_spans": len(spans),
            "dropped": int(sh.get("dropped", 0)),
            "device_busy_s": round(device_busy_seconds(spans), 4),
            "clock_offset_s": round(
                float(sh.get("wall_anchor", 0.0)) - wall0, 6),
        })
    n_events = _write_trace_events(out_path, events)
    rollups = rollup_spans(all_spans, wall=wall,
                           dropped=sum(p["dropped"] for p in processes))
    return {
        "n_events": n_events,
        "n_processes": len(processes),
        "processes": processes,
        "rollups": rollups,
    }



# ---------------------------------------------------------------------------
# cumulative-bucket histogram (Prometheus semantics)
# ---------------------------------------------------------------------------

#: default request-latency bucket bounds (seconds) — the classic
#: Prometheus latency ladder, wide enough to cover a 2 ms stub quantum
#: and a 30 s cold compile in the same histogram.
DEFAULT_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                           1.0, 2.5, 5.0, 10.0, 30.0)


def _le_str(bound: float) -> str:
    return "+Inf" if bound == float("inf") else repr(float(bound))


class Histogram:
    """Prometheus-correct cumulative-bucket histogram.

    An observation ``v`` lands in the FIRST bucket with ``v <= le``;
    exported ``_bucket`` samples are cumulative, the mandatory
    ``le="+Inf"`` bucket equals ``_count``, and ``_sum`` carries the
    exact sum — the invariants :func:`lint_prometheus` enforces on
    every emitted snapshot.  Not internally locked:
    owners (the server) serialize observations under their own lock."""

    __slots__ = ("bounds", "bucket_counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        bs = tuple(sorted(float(b) for b in bounds))
        if not bs or len(set(bs)) != len(bs):
            raise ValueError(f"bad histogram bounds {bounds}")
        self.bounds = bs
        self.bucket_counts = [0] * (len(bs) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> Dict[str, int]:
        """``{le_str: cumulative_count, ..., "+Inf": count}`` — the
        deterministic assertion target of the load harness's virtual
        mode."""
        out: Dict[str, int] = {}
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += self.bucket_counts[i]
            out[_le_str(b)] = cum
        out["+Inf"] = self.count
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile (the ``histogram_quantile``
        estimate): linear within the bucket, clamped to the highest
        finite bound when the rank falls in the +Inf bucket."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for i, b in enumerate(self.bounds):
            prev = cum
            cum += self.bucket_counts[i]
            if cum >= target:
                lo = self.bounds[i - 1] if i else 0.0
                inside = self.bucket_counts[i]
                frac = (target - prev) / inside if inside else 1.0
                return lo + (b - lo) * frac
        return self.bounds[-1]

    def merge(self, other: "Histogram") -> "Histogram":
        if other.bounds != self.bounds:
            raise ValueError("histogram bounds mismatch")
        for i, c in enumerate(other.bucket_counts):
            self.bucket_counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self

    def copy(self) -> "Histogram":
        h = Histogram(self.bounds)
        h.bucket_counts = list(self.bucket_counts)
        h.sum, h.count = self.sum, self.count
        return h

    def to_samples(self, labels: Optional[Dict[str, Any]] = None
                   ) -> List[Tuple[str, Dict[str, Any], Any]]:
        """Suffixed samples for :func:`write_prometheus`:
        ``name_bucket{le=...}`` (cumulative, ``+Inf`` last), ``name_sum``,
        ``name_count``."""
        base = dict(labels or {})
        out: List[Tuple[str, Dict[str, Any], Any]] = []
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += self.bucket_counts[i]
            out.append(("_bucket", {**base, "le": _le_str(b)}, cum))
        out.append(("_bucket", {**base, "le": "+Inf"}, self.count))
        out.append(("_sum", dict(base), round(self.sum, 9)))
        out.append(("_count", dict(base), self.count))
        return out


def histogram_family(name: str, help_text: str,
                     items: Iterable[Tuple[Optional[Dict[str, Any]],
                                           "Histogram"]]):
    """A ``(name, "histogram", help, samples)`` family for
    :func:`write_prometheus` from labelled :class:`Histogram`\\ s."""
    samples: List[Tuple[str, Dict[str, Any], Any]] = []
    for labels, hist in items:
        samples.extend(hist.to_samples(labels))
    return (name, "histogram", help_text, samples)


# ---------------------------------------------------------------------------
# trace-diff regression gate (rollup-vs-rollup comparison)
# ---------------------------------------------------------------------------

def diff_rollups(a: Dict[str, Any], b: Dict[str, Any], *,
                 rel_threshold: float = 0.2, abs_floor_s: float = 0.05,
                 bubble_abs: float = 0.05,
                 mem_abs_floor_gb: float = 0.25) -> Dict[str, Any]:
    """Compare two span rollups (``summary()`` dicts, or the ``rollups``
    section of a TRACE artifact): per-stage seconds, total device-busy
    seconds, the pipeline-bubble fraction, and the memory peaks.

    A quantity REGRESSES when the candidate ``b`` exceeds the baseline
    ``a`` by more than ``max(abs_floor_s, rel_threshold * a)`` (the abs
    floor keeps microsecond stages from tripping the relative gate on
    noise).  Device-path stages, the device-busy total, and the memory
    peaks (``peak_host_rss_gb``/``peak_device_gb``, against
    ``max(mem_abs_floor_gb, rel_threshold * a)``) GATE; host/store stage
    regressions are reported as warnings only, because host time is the
    thing device optimizations deliberately trade against.  A baseline
    or candidate WITHOUT a memory section (pre-memory artifacts,
    malformed rollups) degrades to skipping that memory check — never a
    crash, never a false regression.  A gate exits nonzero iff
    ``regressed``."""
    sa = a.get("stage_seconds") or {}
    sb = b.get("stage_seconds") or {}
    if not isinstance(sa, dict):
        sa = {}
    if not isinstance(sb, dict):
        sb = {}
    stages: Dict[str, Dict[str, Any]] = {}
    regressions: List[str] = []
    warnings: List[str] = []
    def _stage_val(stages_doc, name):
        try:
            return float(stages_doc.get(name, 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    for name in sorted(set(sa) | set(sb)):
        av, bv = _stage_val(sa, name), _stage_val(sb, name)
        delta = bv - av
        worse = delta > max(abs_floor_s, rel_threshold * av)
        device = name.startswith(DEVICE_STAGE_PREFIXES)
        stages[name] = {
            "a_s": round(av, 4), "b_s": round(bv, 4),
            "delta_s": round(delta, 4),
            "rel": (round(delta / av, 4) if av > 0 else None),
            "device": device, "regressed": worse,
        }
        if worse:
            (regressions if device else warnings).append(f"stage:{name}")
    def _num(doc, key, default=None):
        try:
            v = doc.get(key, default)
            return default if v is None else float(v)
        except (TypeError, ValueError):
            return default

    busy_a = _num(a, "device_busy_s", 0.0)
    busy_b = _num(b, "device_busy_s", 0.0)
    busy_delta = busy_b - busy_a
    busy_worse = busy_delta > max(abs_floor_s, rel_threshold * busy_a)
    if busy_worse:
        regressions.append("device_busy_s")
    bub_a = _num(a, "pipeline_bubble_frac")
    bub_b = _num(b, "pipeline_bubble_frac")
    bub_delta = (None if bub_a is None or bub_b is None
                 else bub_b - bub_a)
    bub_worse = bub_delta is not None and bub_delta > bubble_abs
    if bub_worse:
        regressions.append("pipeline_bubble_frac")
    ma = a.get("memory")
    mb = b.get("memory")
    if not isinstance(ma, dict):
        ma = {}
    if not isinstance(mb, dict):
        mb = {}
    memory: Dict[str, Dict[str, Any]] = {}
    for key in ("peak_host_rss_gb", "peak_device_gb"):
        av, bv = ma.get(key), mb.get(key)
        try:
            av = None if av is None else float(av)
            bv = None if bv is None else float(bv)
        except (TypeError, ValueError):
            av = bv = None
        if av is None or bv is None:
            # pre-memory baseline (or candidate without samples):
            # degrade to "skip this check", never crash the gate
            memory[key] = {"skipped": True, "a_gb": av, "b_gb": bv,
                           "regressed": False}
            continue
        delta = bv - av
        worse = delta > max(mem_abs_floor_gb, rel_threshold * av)
        memory[key] = {"a_gb": round(av, 4), "b_gb": round(bv, 4),
                       "delta_gb": round(delta, 4), "regressed": worse}
        if worse:
            regressions.append(f"memory:{key}")
    return {
        "thresholds": {"rel": rel_threshold, "abs_floor_s": abs_floor_s,
                       "bubble_abs": bubble_abs,
                       "mem_abs_floor_gb": mem_abs_floor_gb},
        "stages": stages,
        "device_busy": {"a_s": round(busy_a, 4), "b_s": round(busy_b, 4),
                        "delta_s": round(busy_delta, 4),
                        "regressed": busy_worse},
        "bubble": {"a": bub_a, "b": bub_b,
                   "delta": (round(bub_delta, 4)
                             if bub_delta is not None else None),
                   "regressed": bub_worse},
        "memory": memory,
        "regressions": regressions,
        "warnings": warnings,
        "regressed": bool(regressions),
    }


# ---------------------------------------------------------------------------
# crash flight recorder
# ---------------------------------------------------------------------------

_FLIGHT_LOCK = threading.Lock()
_FLIGHT_COUNT = 0
_FLIGHT_SEQ = itertools.count(1)
_FLIGHT_SLUG_RE = re.compile(r"[^A-Za-z0-9_-]+")


def flight_record(directory: str, reason: str,
                  extra: Optional[Dict[str, Any]] = None,
                  max_spans: int = 4096) -> str:
    """Dump a postmortem snapshot — the span ring buffer, the memory
    timeline/rollup plus a live probe reading, and caller-supplied state
    (the server passes queue depth, SLO report and in-flight request
    correlation ids) — to an atomic ``flightrec_*.json`` in
    ``directory``.  Called on unhandled exceptions, tenant faults and
    SIGTERM (see :func:`install_flight_recorder`); works with telemetry
    disabled (the span list is just empty).  Returns the file path."""
    global _FLIGHT_COUNT
    os.makedirs(directory, exist_ok=True)
    spans = spans_snapshot()[-int(max_spans):]
    # which process of a multi-process run dumped it (multihost.py)
    try:
        from ..parallel import multihost
        pidx, pcnt = multihost.process_index(), multihost.process_count()
    except Exception:
        pidx, pcnt = 0, 1
    payload = {
        "reason": str(reason),
        "unix_time": time.time(),
        "host_pid": os.getpid(),
        "process_index": pidx,
        "process_count": pcnt,
        "dropped_spans": dropped_count(),
        "n_spans": len(spans),
        "memory": {
            "probe": {"host": host_memory_bytes(),
                      "device": device_memory_bytes()},
            "rollup": memory_rollup(spans),
        },
        "spans": [_span_to_dict(s) for s in spans],
        "extra": dict(extra or {}),
    }
    slug = _FLIGHT_SLUG_RE.sub("-", str(reason)).strip("-")[:48] \
        or "unknown"
    with _FLIGHT_LOCK:
        seq = next(_FLIGHT_SEQ)
        _FLIGHT_COUNT += 1
    path = os.path.join(directory,
                        f"flightrec_{slug}_{os.getpid()}_{seq}.json")
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True, separators=(",", ":"),
                  default=str)
    os.replace(tmp, path)
    return path


def flight_record_count() -> int:
    return _FLIGHT_COUNT


def install_flight_recorder(directory: str,
                            extra_fn: Optional[Callable[[], Dict]] = None,
                            sigterm: bool = False) -> Callable[[], None]:
    """OPT-IN process-level crash hooks: wrap ``sys.excepthook`` (and,
    when ``sigterm=True``, the SIGTERM handler) so an unhandled crash or
    a kill leaves a flight-recorder dump before the process dies.  The
    previous hooks are chained, not replaced; returns an ``uninstall``
    callable restoring them (tests stay hermetic)."""
    import signal
    import sys

    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            flight_record(directory, "exception", extra={
                "exc_type": getattr(exc_type, "__name__", str(exc_type)),
                "exc": str(exc),
                **((extra_fn() or {}) if extra_fn else {}),
            })
        except Exception:
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook
    prev_sig = None
    if sigterm:
        def _on_term(signum, frame):
            try:
                flight_record(directory, "sigterm",
                              extra=(extra_fn() or {}) if extra_fn
                              else {})
            except Exception:
                pass
            signal.signal(signal.SIGTERM, prev_sig or signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        prev_sig = signal.signal(signal.SIGTERM, _on_term)

    def uninstall():
        sys.excepthook = prev_hook
        if sigterm:
            signal.signal(signal.SIGTERM, prev_sig or signal.SIG_DFL)

    return uninstall


# ---------------------------------------------------------------------------
# Prometheus text-format snapshot writer
# ---------------------------------------------------------------------------

def _prom_escape(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def write_prometheus(path: str,
                     families: Iterable[Tuple[str, str, str,
                                              Iterable[Union[
                                                  Tuple[Optional[
                                                      Dict[str, Any]], Any],
                                                  Tuple[str, Dict[str, Any],
                                                        Any]]]]]) -> str:
    """Write a Prometheus text-format (exposition format 0.0.4) snapshot
    atomically.  ``families`` is an iterable of
    ``(name, type, help_text, samples)`` with ``samples`` an iterable of
    ``(labels_dict_or_None, value)`` or, for histogram/summary families,
    ``(name_suffix, labels_dict, value)`` (see
    :meth:`Histogram.to_samples`).  Returns ``path``."""
    lines: List[str] = []
    for name, mtype, help_text, samples in families:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for sample in samples:
            if len(sample) == 3:
                suffix, labels, value = sample
            else:
                (labels, value), suffix = sample, ""
            lab = ""
            if labels:
                lab = "{" + ",".join(
                    f'{k}="{_prom_escape(v)}"'
                    for k, v in sorted(labels.items())) + "}"
            lines.append(f"{name}{suffix}{lab} {value}")
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return path


def metrics_families():
    """Telemetry self-metrics for :func:`write_prometheus` — most
    importantly the ring's dropped-span count, which was invisible
    before (a saturated ring silently truncates every rollup derived
    from it)."""
    with _REC.lock:
        n_spans = len(_REC.spans)
        dropped = _REC.dropped
    fams = [
        ("ctt_telemetry_dropped_spans_total", "counter",
         "Spans evicted from the bounded telemetry ring",
         [(None, dropped)]),
        ("ctt_telemetry_ring_spans", "gauge",
         "Spans currently held in the telemetry ring",
         [(None, n_spans)]),
        ("ctt_telemetry_flight_records_total", "counter",
         "Flight-recorder postmortem dumps written by this process",
         [(None, _FLIGHT_COUNT)]),
    ]
    host = host_memory_bytes()
    fams.append(
        ("ctt_memory_host_gb", "gauge",
         "Host memory (GiB, 1024-based): resident set and high-water",
         [({"kind": "rss"}, round(host["rss"] / _GIB, 4)),
          ({"kind": "hwm"}, round(host["hwm"] / _GIB, 4))]))
    dev = device_memory_bytes()
    if dev is not None:
        fams.append(
            ("ctt_memory_device_gb", "gauge",
             "Device memory (GiB) from torch.cuda.memory_stats()",
             [({"kind": "in_use"}, round(dev["in_use"] / _GIB, 4)),
              ({"kind": "peak"}, round(dev["peak"] / _GIB, 4))]))
    return fams


# ---------------------------------------------------------------------------
# Prometheus text-format lint (pure-python promtool subset)
# ---------------------------------------------------------------------------

_PROM_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_PROM_LABEL_KEY_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_PROM_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(?:\s+(-?\d+))?$")
_PROM_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_prom_labels(blob: str, lineno: int, errors: List[str]
                       ) -> Optional[Dict[str, str]]:
    """Parse a ``{k="v",...}`` label blob honoring the three legal
    escapes (``\\\\``, ``\\"``, ``\\n``); reports malformed syntax."""
    inner = blob[1:-1]
    labels: Dict[str, str] = {}
    i, n = 0, len(inner)
    while i < n:
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', inner[i:])
        if not m:
            errors.append(f"line {lineno}: malformed label pair at "
                          f"{inner[i:i + 20]!r}")
            return None
        key = m.group(1)
        i += m.end()
        chars: List[str] = []
        closed = False
        while i < n:
            c = inner[i]
            if c == "\\":
                nxt = inner[i + 1] if i + 1 < n else ""
                if nxt in ("\\", '"', "n"):
                    chars.append({"\\": "\\", '"': '"', "n": "\n"}[nxt])
                    i += 2
                else:
                    errors.append(
                        f"line {lineno}: bad escape \\{nxt} in label "
                        f"{key}")
                    i += 2
            elif c == '"':
                closed = True
                i += 1
                break
            else:
                chars.append(c)
                i += 1
        if not closed:
            errors.append(f"line {lineno}: unterminated label value for "
                          f"{key}")
            return None
        if key in labels:
            errors.append(f"line {lineno}: duplicate label {key}")
        labels[key] = "".join(chars)
        if i < n and inner[i] == ",":
            i += 1
    return labels


def lint_prometheus(text: str) -> List[str]:
    """Promtool-style lint of an exposition-format snapshot.  Returns a
    list of error strings (empty = clean).  Checks: metric/label name
    syntax, label-value escaping, HELP/TYPE present before samples,
    duplicate series, float-parseable values, and the histogram
    invariants — cumulative bucket monotonicity, the mandatory
    ``le="+Inf"`` bucket equal to ``_count``, and ``_sum``/``_count``
    presence."""
    errors: List[str] = []
    typed: Dict[str, str] = {}
    seen_series: set = set()
    # (family, frozen_labels_minus_le) -> [(le_float, count, lineno)]
    hist_buckets: Dict[Tuple[str, frozenset], List[Tuple[float, float]]] = {}
    hist_counts: Dict[Tuple[str, frozenset], float] = {}
    hist_sums: Dict[Tuple[str, frozenset], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 4 and parts[1] == "TYPE":
                errors.append(f"line {lineno}: malformed TYPE line")
                continue
            name = parts[2]
            if not _PROM_NAME_RE.match(name):
                errors.append(f"line {lineno}: bad metric name {name!r}")
            if parts[1] == "TYPE":
                mtype = parts[3].strip() if len(parts) > 3 else ""
                if mtype not in _PROM_TYPES:
                    errors.append(
                        f"line {lineno}: unknown TYPE {mtype!r} for "
                        f"{name}")
                if name in typed:
                    errors.append(f"line {lineno}: duplicate TYPE for "
                                  f"{name}")
                typed[name] = mtype
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {lineno}: unparseable sample "
                          f"{line[:60]!r}")
            continue
        name, blob, value = m.group(1), m.group(2), m.group(3)
        labels = (_parse_prom_labels(blob, lineno, errors)
                  if blob else {})
        if labels is None:
            continue
        for k in labels:
            if not _PROM_LABEL_KEY_RE.match(k):
                errors.append(f"line {lineno}: bad label name {k!r}")
        try:
            val = float(value)
        except ValueError:
            errors.append(f"line {lineno}: non-numeric value {value!r}")
            continue
        # resolve the family: histogram samples carry suffixed names
        family, suffix = name, ""
        if name not in typed:
            for suf in _HIST_SUFFIXES:
                base = name[:-len(suf)] if name.endswith(suf) else None
                if base and typed.get(base) in ("histogram", "summary"):
                    family, suffix = base, suf
                    break
        if family not in typed:
            errors.append(f"line {lineno}: sample {name} has no "
                          f"preceding # TYPE")
            continue
        key = (name, frozenset(labels.items()))
        if key in seen_series:
            errors.append(f"line {lineno}: duplicate series {name}"
                          f"{sorted(labels.items())}")
        seen_series.add(key)
        if typed.get(family) == "histogram":
            hkey = (family, frozenset((k, v) for k, v in labels.items()
                                      if k != "le"))
            if suffix == "_bucket":
                if "le" not in labels:
                    errors.append(f"line {lineno}: histogram bucket "
                                  f"without le label")
                    continue
                le_raw = labels["le"]
                try:
                    le = (float("inf") if le_raw == "+Inf"
                          else float(le_raw))
                except ValueError:
                    errors.append(f"line {lineno}: bad le value "
                                  f"{le_raw!r}")
                    continue
                hist_buckets.setdefault(hkey, []).append((le, val))
            elif suffix == "_count":
                hist_counts[hkey] = val
            elif suffix == "_sum":
                hist_sums[hkey] = val
            elif family == name:
                errors.append(f"line {lineno}: bare sample {name} in "
                              f"histogram family")
    for hkey, buckets in hist_buckets.items():
        family, labels = hkey[0], dict(hkey[1])
        where = f"{family}{sorted(labels.items())}"
        in_order = sorted(buckets)
        counts = [c for _, c in in_order]
        if counts != sorted(counts):
            errors.append(f"{where}: bucket counts not monotone "
                          f"non-decreasing in le order: {counts}")
        if not in_order or in_order[-1][0] != float("inf"):
            errors.append(f"{where}: missing le=\"+Inf\" bucket")
        else:
            inf_count = in_order[-1][1]
            if hkey not in hist_counts:
                errors.append(f"{where}: missing _count sample")
            elif hist_counts[hkey] != inf_count:
                errors.append(
                    f"{where}: _count {hist_counts[hkey]} != +Inf "
                    f"bucket {inf_count}")
        if hkey not in hist_sums:
            errors.append(f"{where}: missing _sum sample")
    for hkey in set(hist_counts) | set(hist_sums):
        if hkey not in hist_buckets:
            family, labels = hkey[0], dict(hkey[1])
            errors.append(f"{family}{sorted(labels.items())}: _sum/"
                          f"_count without any _bucket samples")
    return errors
