"""The traced run's reduction: device intervals from a ``torch.profiler``
trace, the busy share, the breakdown, and the per-layer metric readers.

A reader is ``portbench/metrics/<metric name>.py`` with a function
``read(trace) -> float | None``; ``trace`` is a :class:`Trace`.  A reader
that finds nothing to read returns None, and the metric is left out of
the result's line.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))

#: characters kept of a device operation's name in the breakdown
NAME_CHARS = 160


@dataclass
class Trace:
    """What the readers may read.  Times are seconds from the profiler's
    start; ``spans`` are the program's telemetry spans on that clock."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    window_s: float
    device_ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, str, float, float]] = field(default_factory=list)
    status: List[Dict[str, Any]] = field(default_factory=list)
    info: Dict[str, Any] = field(default_factory=dict)

    def busy_s(self, t0: float = 0.0, t1: float = float("inf")) -> float:
        """Seconds in [t0, t1] in which some device operation ran."""
        return sum(b - a for a, b in _union(self.device_ops, t0, t1))

    def kernel_s(self, needle: str) -> Optional[float]:
        """Summed seconds of the device operations whose name contains
        ``needle``, or None where none ran."""
        ts = [b - a for n, a, b in self.device_ops if needle in n]
        return sum(ts) if ts else None

    def task(self, prefix: str) -> List[Dict[str, Any]]:
        return [s for s in self.status
                if str(s.get("task", "")).startswith(prefix)]

    def task_span(self, name: str) -> Optional[Tuple[float, float]]:
        hits = [(a, b) for n, c, a, b in self.spans
                if c == "attempt" and n.startswith(name)]
        return (min(a for a, _ in hits), max(b for _, b in hits)) \
            if hits else None


def _union(ops, t0=0.0, t1=float("inf")):
    iv = sorted((max(a, t0), min(b, t1)) for _, a, b in ops
                if b > t0 and a < t1)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_ops(prof) -> List[Tuple[str, float, float]]:
    """The device operations of a finished ``torch.profiler.profile`` as
    (name, start s, end s) on the profiler's clock."""
    from torch.autograd import DeviceType

    ops = []
    for e in prof.events():
        # a CPU range (record_function) is mirrored on the device's
        # timeline as a user annotation: no operation
        if getattr(e, "is_user_annotation", False) or \
                e.name.startswith("portbench."):
            continue
        if e.device_type == DeviceType.CUDA and e.time_range.end > \
                e.time_range.start:
            ops.append((e.name, e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6))
    return ops


def marker_offset(prof, name: str) -> Optional[float]:
    """Start (s, profiler clock) of the CPU range ``name``."""
    for e in prof.events():
        if e.name == name:
            return e.time_range.start * 1e-6
    return None


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the
    longest idle gaps, each named by the innermost host stage span
    active in its middle."""
    by_name: Dict[str, float] = {}
    for n, a, b in trace.device_ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(n[:NAME_CHARS], t) for n, t in ops]
    busy = _union(trace.device_ops, 0.0, trace.window_s)
    gaps = []
    prev = 0.0
    for a, b in busy + [[trace.window_s, trace.window_s]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        inside = [(s1 - s0, n) for n, c, s0, s1 in trace.spans
                  if c == "stage" and s0 <= mid <= s1]
        name = min(inside)[1] if inside else "no-stage"
        named.append([name, b - a])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def written_bytes() -> Dict[str, int]:
    """This process's bytes written so far: ``write_bytes`` (sent to
    storage) and ``wchar`` (every write call) of ``/proc/self/io``."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in ("write_bytes", "wchar"):
                    out[k] = int(v)
    except OSError:
        pass
    return out


def metric_reader(name: str, base: str = HERE):
    path = os.path.join(base, "metrics", f"{name}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: Dict[str, Any], cell_name: str,
              end_to_end: List[str], trace: Trace) -> Dict[str, dict]:
    """Each per-layer metric of ``bench`` that this cell reports, read."""
    out = {}
    for m in bench.get("per_layer", []):
        cells = m.get("workloads")
        if cells is not None and cell_name not in cells:
            continue
        if cells is None and m["moves"] not in end_to_end:
            continue
        read = metric_reader(m["name"])
        value = read(trace) if read is not None else None
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
