"""Latency-SLO engine: declarative objectives, multi-window burn rates,
and the ``overload`` signal of the resident server.

The server's metrics say what happened; this module gives it a
*definition of good*.  An :class:`Objective` says what the serve path
promises per request lane ("99% of edit requests under 250 ms"); the
:class:`SLOEngine` consumes request completions and answers two
questions a scheduler needs answered continuously:

* **How fast is the error budget burning?**  For each objective and
  each configured window, ``burn_rate = error_rate / (1 - target)`` —
  burn 1.0 spends the budget exactly at the sustainable rate, burn 14
  exhausts a 30-day budget in ~2 days (the classic SRE fast-burn
  threshold).
* **Is the service overloaded right now?**  The multi-window AND rule:
  an objective breaches only when EVERY window's burn rate exceeds its
  threshold — the short window gives fast detection, the long window
  rejects blips.  ``overload`` is true when any objective breaches; the
  server exports it as the ``ctt_server_overload`` gauge and consults
  it in the admission-control hook point (``admission_hook``), which is
  the gate future request-batching / priority-lane scheduling aims at.

Design constraints: pure host python, no deps; the clock is injectable
(the load harness's deterministic virtual-time mode shares one clock
between generator, server and engine); event storage is a bounded deque
so an always-on service cannot grow SLO state forever.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, \
    Optional, Sequence, Tuple


class Objective(NamedTuple):
    """One service-level objective over a request lane.

    ``latency_s=None`` makes it a pure availability objective (a request
    is bad iff it failed); with a threshold, a request is bad when it
    failed OR took longer than ``latency_s`` — the Prometheus
    "good events / total events" formulation, so compliance and burn
    rate come straight from event counts.
    """

    name: str
    lane: str = "*"                  # "*" matches every lane
    latency_s: Optional[float] = None
    target: float = 0.99             # compliance target in (0, 1)


#: (window_seconds, max_burn_rate) pairs, short window first.  The
#: thresholds follow the SRE multiwindow ladder shape (fast window
#: tolerates a high burn, slow window a low one); the absolute window
#: lengths are tuned for a load-test session, not a 30-day budget —
#: pass explicit windows for production-length accounting.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((60.0, 14.0),
                                                    (600.0, 6.0))


def default_objectives() -> List[Objective]:
    """The serve-path defaults: interactive
    edits get a tight tail bound, bulk re-runs a loose one, and every
    lane shares an availability floor."""
    return [
        Objective("edit-latency", lane="edit", latency_s=0.25,
                  target=0.95),
        Objective("bulk-latency", lane="bulk", latency_s=2.0,
                  target=0.90),
        Objective("availability", lane="*", latency_s=None,
                  target=0.999),
    ]


def objectives_from_config(cfg: Any) -> Optional[List[Objective]]:
    """Parse the ``slo_objectives`` global-config value: a list of
    ``{"name", "lane", "latency_s", "target"}`` dicts.  ``None``/empty
    returns None (caller falls back to :func:`default_objectives`)."""
    if not cfg:
        return None
    out = []
    for row in cfg:
        out.append(Objective(
            name=str(row["name"]),
            lane=str(row.get("lane", "*")),
            latency_s=(None if row.get("latency_s") is None
                       else float(row["latency_s"])),
            target=float(row.get("target", 0.99))))
    return out


class SLOEngine:
    """Sliding-window burn-rate computation over request completions.

    ``record(lane, latency_s, ok)`` is called by the server on every
    terminal request; ``report()`` evaluates every objective over every
    window; ``overload()`` is the boolean the admission hook consults.
    Thread-safe (one lock around the event deque); the load harness
    embeds ``report()`` verbatim in its summary row.
    """

    def __init__(self, objectives: Optional[Sequence[Objective]] = None,
                 windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS,
                 clock: Callable[[], float] = time.monotonic,
                 max_events: int = 1 << 16):
        self.objectives = (list(objectives) if objectives is not None
                           else default_objectives())
        for obj in self.objectives:
            if not 0.0 < obj.target < 1.0:
                raise ValueError(f"objective {obj.name}: target must be "
                                 f"in (0, 1), got {obj.target}")
        self.windows = tuple(sorted((float(w), float(mb))
                                    for w, mb in windows))
        if not self.windows:
            raise ValueError("need at least one burn-rate window")
        self.clock = clock
        self._events: deque = deque(maxlen=int(max_events))
        self._lock = threading.Lock()
        self.total_events = 0

    # -- ingestion -----------------------------------------------------
    def record(self, lane: str, latency_s: float, ok: bool = True
               ) -> None:
        with self._lock:
            self._events.append((float(self.clock()), str(lane),
                                 float(latency_s), bool(ok)))
            self.total_events += 1

    # -- evaluation ----------------------------------------------------
    @staticmethod
    def _is_bad(obj: Objective, latency_s: float, ok: bool) -> bool:
        if not ok:
            return True
        return obj.latency_s is not None and latency_s > obj.latency_s

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Every objective x every window: event counts, error rate,
        burn rate, per-window breach, and the multi-window-AND breach
        verdict; plus the engine-level ``overload`` bit."""
        if now is None:
            now = self.clock()
        with self._lock:
            events = list(self._events)
        out: Dict[str, Any] = {"now_s": round(float(now), 6),
                               "windows": [list(w) for w in self.windows],
                               "overload": False, "objectives": []}
        for obj in self.objectives:
            lane_events = [e for e in events
                           if obj.lane == "*" or e[1] == obj.lane]
            budget = 1.0 - obj.target
            row: Dict[str, Any] = {
                "name": obj.name, "lane": obj.lane,
                "latency_s": obj.latency_s, "target": obj.target,
                "windows": [],
            }
            breach_all = True
            for window_s, max_burn in self.windows:
                evs = [e for e in lane_events if e[0] >= now - window_s]
                n = len(evs)
                bad = sum(1 for _, _, lat, ok in evs
                          if self._is_bad(obj, lat, ok))
                err = bad / n if n else 0.0
                burn = err / budget
                breach = burn > max_burn
                row["windows"].append({
                    "window_s": window_s, "events": n, "bad": bad,
                    "error_rate": round(err, 6),
                    "burn_rate": round(burn, 4),
                    "max_burn": max_burn, "breach": breach,
                })
                breach_all = breach_all and breach
            # compliance over the LONGEST window is the headline number
            long_win = row["windows"][-1]
            row["compliance"] = round(1.0 - long_win["error_rate"], 6)
            row["breach"] = breach_all
            out["objectives"].append(row)
            out["overload"] = out["overload"] or breach_all
        return out

    def overload(self, now: Optional[float] = None) -> bool:
        """True when any objective breaches on EVERY window (the
        multi-window AND — fast to trip under sustained overload,
        immune to single-request blips)."""
        return bool(self.report(now)["overload"])

    # -- metrics export ------------------------------------------------
    def metrics_families(self, report: Optional[Dict[str, Any]] = None):
        """``ctt_slo_burn_rate`` / ``ctt_slo_compliance`` gauge families
        for ``telemetry.write_prometheus`` (an already-computed report
        can be passed to avoid evaluating twice)."""
        rep = report if report is not None else self.report()
        burn = [({"objective": o["name"],
                  "window_s": str(int(w["window_s"]))}, w["burn_rate"])
                for o in rep["objectives"] for w in o["windows"]]
        comp = [({"objective": o["name"]}, o["compliance"])
                for o in rep["objectives"]]
        return [
            ("ctt_slo_burn_rate", "gauge",
             "Error-budget burn rate per objective and window",
             burn or [(None, 0.0)]),
            ("ctt_slo_compliance", "gauge",
             "Longest-window compliance ratio per objective",
             comp or [(None, 1.0)]),
        ]
