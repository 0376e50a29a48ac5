"""Open-loop load harness for the resident server.

It is an OPEN-loop generator: arrivals follow a Poisson schedule fixed
ahead of time and do NOT wait for completions — the defining property that makes
overload visible (a closed-loop generator self-throttles and hides the
queueing collapse this harness exists to measure).  Every request's
latency is charged from its SCHEDULED arrival instant (``arrival_t`` on
``submit``), so queue buildup under overload compounds into the tail
exactly as it would for real proofreaders.

Two execution modes share one schedule generator:

* **virtual** (:func:`run_virtual`): single-threaded.  The
  server takes a :class:`VirtualClock`, the :class:`SyntheticPipeline`
  advances that same clock instead of sleeping, and the loop alternates
  "admit due arrivals" with ``server.step_once()``.  No threads, no
  wall clock — the same seed yields the same schedule, the same
  interleaving, the same latencies, and therefore byte-identical
  histogram bucket counts (asserted by the tests).
* **threaded** (:func:`run_threaded`): the real server worker thread
  plus a submitter that sleeps until each scheduled arrival
  (``chip_smoke.py`` serves its card requests this way).

The request mix is declarative (:class:`LoadSpec`): hundreds of
synthetic tenants, weighted priority lanes, and weighted ROI-size
classes that map to per-request block counts via the pipeline's
``request_n_blocks`` hook.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np

from .server import AdmissionRejected, ResidentSegmentationServer


class LoadSpec(NamedTuple):
    """Declarative request mix for one load level.

    ``lanes`` and ``roi_classes`` are weighted choices;
    ``roi_classes`` rows are ``(name, n_blocks, weight)`` — the block
    count is what the synthetic pipeline's service time scales with, so
    the mix directly shapes the latency distribution.
    """

    seed: int = 0
    rate_hz: float = 50.0            # aggregate Poisson arrival rate
    n_requests: int = 200
    n_tenants: int = 100
    lanes: Tuple[Tuple[str, float], ...] = (("edit", 0.7), ("bulk", 0.3))
    roi_classes: Tuple[Tuple[str, int, float], ...] = (
        ("small", 1, 0.6), ("medium", 4, 0.3), ("large", 16, 0.1))


class Arrival(NamedTuple):
    t: float                         # scheduled arrival (s from start)
    tenant: str
    lane: str
    roi: str
    n_blocks: int


class VirtualClock:
    """A clock that only moves when told to — the shared timebase of the
    deterministic mode (generator, server and SLO engine all read it)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))


class SyntheticPipeline:
    """Stub request pipeline with a deterministic cost model.

    Service time is ``prepare_s + n_blocks * block_s + finalize_s``;
    with a :class:`VirtualClock` the cost advances the clock (virtual
    mode), without one it really sleeps (threaded mode).  ``fail_every``
    > 0 makes every Nth prepared request raise, exercising the
    availability SLO and the server's tenant isolation under load.
    """

    n_blocks = 1                      # fallback when request_n_blocks absent

    def __init__(self, clock: Optional[VirtualClock] = None,
                 prepare_s: float = 0.002, block_s: float = 0.004,
                 finalize_s: float = 0.001, fail_every: int = 0):
        self.clock = clock
        self.prepare_s = float(prepare_s)
        self.block_s = float(block_s)
        self.finalize_s = float(finalize_s)
        self.fail_every = int(fail_every)
        self.prepared = 0

    def _spend(self, dt: float) -> None:
        if self.clock is not None:
            self.clock.advance(dt)
        else:
            time.sleep(dt)

    def request_n_blocks(self, volume) -> int:
        # the generator encodes the ROI class's block count in the stub
        # volume's length (see synthetic_volume)
        return max(1, int(volume.shape[0]))

    def prepare(self, volume) -> Dict[str, Any]:
        self.prepared += 1
        self._spend(self.prepare_s)
        if self.fail_every and self.prepared % self.fail_every == 0:
            raise RuntimeError("synthetic pipeline fault injection")
        return {"n_blocks": self.request_n_blocks(volume)}

    def run_block(self, ctx, bid: int):
        self._spend(self.block_s)
        return bid

    def finalize(self, ctx, block_results) -> Dict[str, Any]:
        self._spend(self.finalize_s)
        return {"n_fragments": len(block_results),
                "n_segments": len(block_results)}


def _weighted(rng: random.Random, rows: Sequence[Tuple], weight_idx: int):
    """Seeded weighted choice (no numpy: the schedule must be a pure
    function of the stdlib Random stream)."""
    total = sum(r[weight_idx] for r in rows)
    x = rng.random() * total
    acc = 0.0
    for r in rows:
        acc += r[weight_idx]
        if x < acc:
            return r
    return rows[-1]


def generate_schedule(spec: LoadSpec) -> List[Arrival]:
    """The open-loop arrival schedule: Poisson inter-arrivals at
    ``rate_hz``, tenant/lane/ROI drawn per arrival from ONE seeded
    stream.  A pure function of the spec — same seed, same schedule."""
    rng = random.Random(spec.seed)
    t = 0.0
    out: List[Arrival] = []
    for _ in range(int(spec.n_requests)):
        t += rng.expovariate(spec.rate_hz)
        tenant = f"t{rng.randrange(spec.n_tenants):04d}"
        lane = _weighted(rng, spec.lanes, 1)[0]
        roi_name, n_blocks, _ = _weighted(rng, spec.roi_classes, 2)
        out.append(Arrival(round(t, 9), tenant, lane, roi_name,
                           int(n_blocks)))
    return out


def synthetic_volume(arrival: Arrival) -> np.ndarray:
    """The stub request payload: a tiny vector whose LENGTH carries the
    ROI class's block count into ``SyntheticPipeline.request_n_blocks``."""
    return np.zeros((arrival.n_blocks,), dtype=np.uint8)


def run_virtual(spec: LoadSpec, workdir: str, *,
                pipeline: Optional[SyntheticPipeline] = None,
                slo_engine=None,
                admission_hook=None,
                metrics_path: str = "") -> Dict[str, Any]:
    """Deterministic single-threaded replay of the schedule under a
    shared virtual clock.  Returns :func:`summarize`'s row plus the
    schedule and the server (tests inspect both)."""
    clock = VirtualClock()
    if pipeline is None:
        pipeline = SyntheticPipeline(clock=clock)
    elif pipeline.clock is None:
        raise ValueError("run_virtual needs a clock-driven pipeline "
                         "(pass SyntheticPipeline(clock=...))")
    else:
        clock = pipeline.clock
    if slo_engine is not None:
        slo_engine.clock = clock
    server = ResidentSegmentationServer(
        workdir, pipeline, clock=clock, slo=slo_engine,
        admission_hook=admission_hook, metrics_path=metrics_path)
    schedule = generate_schedule(spec)
    rejected = 0
    i = 0
    while True:
        # admit every arrival that is due at the current virtual time
        while i < len(schedule) and schedule[i].t <= clock():
            a = schedule[i]
            i += 1
            try:
                server.submit(a.tenant, synthetic_volume(a), lane=a.lane,
                              arrival_t=a.t)
            except AdmissionRejected:
                rejected += 1
        if not server.step_once():
            if i >= len(schedule):
                break
            # idle: jump straight to the next scheduled arrival
            clock.advance_to(schedule[i].t)
    wall = clock() - (schedule[0].t if schedule else 0.0)
    row = summarize(server, spec, wall, mode="virtual",
                    rejected=rejected, slo_engine=slo_engine)
    row["server"] = server
    row["schedule"] = schedule
    return row


def run_threaded(spec: LoadSpec, workdir: str, *,
                 pipeline=None,
                 slo_engine=None,
                 admission_hook=None,
                 volume_fn: Callable[[Arrival], np.ndarray]
                 = synthetic_volume,
                 metrics_path: Optional[str] = None,
                 drain_timeout: Optional[float] = 120.0) -> Dict[str, Any]:
    """Real-time open loop: the server's worker thread consumes while
    this thread submits on the wall-clock schedule."""
    if pipeline is None:
        pipeline = SyntheticPipeline()        # sleeps for real
    server = ResidentSegmentationServer(
        workdir, pipeline, slo=slo_engine,
        admission_hook=admission_hook, metrics_path=metrics_path)
    schedule = generate_schedule(spec)
    rejected = 0
    server.start()
    try:
        t0 = time.perf_counter()
        for a in schedule:
            dt = (t0 + a.t) - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            try:
                server.submit(a.tenant, volume_fn(a), lane=a.lane,
                              arrival_t=t0 + a.t)
            except AdmissionRejected:
                rejected += 1
        drained = server.drain(timeout=drain_timeout)
        wall = time.perf_counter() - t0
    finally:
        server.shutdown(drain=False)
    row = summarize(server, spec, wall, mode="threaded",
                    rejected=rejected, slo_engine=slo_engine)
    row["drained"] = bool(drained)
    return row


def _lane_row(hist, wait_hist) -> Dict[str, Any]:
    out = {
        "n": hist.count,
        "mean_s": round(hist.sum / hist.count, 6) if hist.count else 0.0,
        "p50_s": round(hist.quantile(0.50), 6),
        "p95_s": round(hist.quantile(0.95), 6),
        "p99_s": round(hist.quantile(0.99), 6),
    }
    if wait_hist is not None:
        out["queue_wait_p95_s"] = round(wait_hist.quantile(0.95), 6)
    return out


def summarize(server: ResidentSegmentationServer, spec: LoadSpec,
              wall_s: float, *, mode: str, rejected: int = 0,
              slo_engine=None) -> Dict[str, Any]:
    """One load-level row: offered vs served throughput, per-lane
    latency percentiles straight off the cumulative histograms, and the
    SLO engine's full burn-rate report."""
    lat, wait, _tenant = server.latency_histograms()
    served = sum(h.count for h in lat.values())
    failed = sum(1 for r in server.stats()["requests"]
                 if r["state"] != "done")
    row: Dict[str, Any] = {
        "mode": mode,
        "seed": spec.seed,
        "offered_hz": spec.rate_hz,
        "n_requests": spec.n_requests,
        "n_tenants": spec.n_tenants,
        "wall_s": round(float(wall_s), 4),
        "served": served,
        "failed": failed,
        "rejected": rejected,
        "throughput_hz": round(served / wall_s, 4) if wall_s > 0 else 0.0,
        "lanes": {l: _lane_row(h, wait.get(l))
                  for l, h in sorted(lat.items())},
    }
    if slo_engine is not None:
        row["slo"] = slo_engine.report()
    return row
