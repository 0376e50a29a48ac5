"""Resident multi-tenant segmentation service: many small ROI requests
from many tenants, served on the card by one resident worker.

Port of cluster_tools_tpu/core/server.py.  Proofreaders issue many small
ROI jobs rather than whole-volume runs; this module puts a service on top
of the block runtime:

* a resident worker thread OWNS the device; requests from N logical
  tenants enqueue into per-tenant FIFO queues;
* scheduling is BLOCK-granular and fair: one round-robin sweep over
  tenants per step, one block of the tenant's oldest request per visit —
  a tenant that submits a 100-block request cannot starve a tenant with
  a 1-block request; ``edit``-lane requests at a queue head are claimed
  before ``bulk`` ones;
* every request gets a status JSON (``stage_counts``, ``exec_cache`` and
  ``ledger`` deltas attributed to that request), so warm vs cold
  dispatch is assertable per request;
* shutdown drains gracefully: queued requests finish, then the worker
  exits; ``shutdown(drain=False)`` cancels the queue instead (statuses
  record ``cancelled``).

The pipeline is pluggable (the tests inject a stub to check scheduling
alone; the ``edit`` lane mounts ``edits.EditPipeline``); the default
:class:`FusedROIPipeline` runs the fused chain's per-block device program
(``workflows/fused_pipeline.resident_block``, whose EDT is the CUDA
min-plus kernel) at ONE canonical request geometry.  The port has no
compiled executables; its counterpart of the JAX package's executable
cache is the set of native libraries ``core/build.py`` builds into
``_build/``, and each request resolves them through that counted cache.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import config as config_mod
from . import runtime
from . import telemetry


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` when the admission-control hook declines a
    request (the overload gate).  A rejection is bookkept
    (``ctt_server_admission_rejected_total``) but never reaches the
    queue."""


class RequestHandle:
    """Caller-side view of a submitted request."""

    def __init__(self, request: "_Request"):
        self._request = request

    @property
    def request_id(self) -> str:
        return self._request.req_id

    @property
    def status_path(self) -> str:
        return self._request.status_path

    def done(self) -> bool:
        return self._request.done.is_set()

    def result(self, timeout: Optional[float] = None):
        """The request's segmentation (blocks until finished).  Raises
        the request's failure, if any — one tenant's bad request must
        surface to THAT tenant, never kill the service."""
        if not self._request.done.wait(timeout):
            raise TimeoutError(
                f"request {self._request.req_id} not done "
                f"after {timeout}s")
        if self._request.error is not None:
            raise RuntimeError(
                f"request {self._request.req_id} failed: "
                f"{self._request.error}")
        return self._request.result


class _Request:
    def __init__(self, req_id: str, tenant: str, volume, params: Dict,
                 n_blocks: int, status_path: str, lane: str = "bulk",
                 pipeline=None):
        self.req_id = req_id
        self.tenant = tenant
        self.lane = lane
        # lane-routed pipeline (None -> the server default); stored per
        # request so an edit-lane request keeps its pipeline even if the
        # server's routing table changes mid-flight
        self.pipeline = pipeline
        self.volume = volume
        self.params = dict(params)
        self.status_path = status_path
        self.n_blocks = n_blocks
        self.next_block = 0
        self.ctx = None                     # pipeline context (device vol)
        self.block_results: List[Any] = []
        self.result = None
        self.error: Optional[str] = None
        self.state = "queued"
        self.done = threading.Event()
        self.submitted_at = time.perf_counter()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.stages: Dict[str, float] = {}
        self.stage_counts: Dict[str, int] = {}
        self.exec_cache: Dict[str, Any] = {}
        # scheduler gauges snapshotted at submit and re-snapshotted at
        # claim time (_step): how deep was the backlog when THIS request
        # got the device, and how many requests each tenant had in flight
        self.queue_depth: int = 0
        self.in_flight: Dict[str, int] = {}


class FusedROIPipeline:
    """The real request pipeline: the fused chain's per-block device
    program (watershed -> dense relabel -> RAG + edge stats, with the EDT
    on the CUDA min-plus kernel) against the request's resident volume at
    one canonical ROI geometry, plus a host tail (face pairs between grid
    blocks, count-weighted table merge, probability->cost transform,
    multicut, fragment relabel) that turns the per-block tables into the
    request's segmentation.

    Runs on ``device`` (default ``"cuda"``; asking for the card on a host
    without one raises, the CPU runs only when asked for).  The native
    libraries are built once per process (:meth:`ensure_compiled`); every
    later request resolves them as in-process cache hits.
    """

    def __init__(self, volume_shape, block_shape=(8, 32, 32),
                 halo=(2, 8, 8), config: Optional[Dict[str, Any]] = None,
                 device: str = "cuda"):
        from .blocking import Blocking
        from .device import resolve_device

        self.device = resolve_device(device)
        self.volume_shape = tuple(int(s) for s in volume_shape)
        self.block_shape = tuple(int(b) for b in block_shape)
        self.halo = tuple(int(h) for h in halo)
        self.cfg = {
            "threshold": 0.4, "sigma_seeds": 2.0, "sigma_weights": 2.0,
            "alpha": 0.8, "size_filter": 10, "refine_rounds": 2,
            "coarse_factor": 2, "e_max": 16384, "beta": 0.5,
            "agglomerator": "kernighan-lin",
        }
        self.cfg.update(config or {})
        self.blocking = Blocking(list(self.volume_shape),
                                 list(self.block_shape))
        self.n_blocks = self.blocking.n_blocks
        self.outer_shape = tuple(b + 2 * h for b, h in
                                 zip(self.block_shape, self.halo))
        self._gdims = [-(-s // b) for s, b in zip(self.volume_shape,
                                                  self.block_shape)]
        self._padded_shape = tuple(
            g * b + 2 * h for g, b, h in zip(self._gdims, self.block_shape,
                                             self.halo))
        n_inner = int(np.prod(self.block_shape))
        # worst-case capacities at ROI scale: overflow-proof and still
        # tiny (a [8,32,32] block's worst case is 2^15 pairs)
        self._pair_cap = 1 << int(np.ceil(np.log2(max(3 * n_inner, 2))))
        self._rle_cap = 1 << 14   # RLE unused by the server drain; minimal

    def _params(self, is_u8: bool):
        """The per-block chain's parameters for one input dtype."""
        from ..workflows.fused_pipeline import _params

        cfg = {**self.cfg, "rle_cap": self._rle_cap,
               "pair_cap": self._pair_cap}
        return _params(cfg, self.outer_shape, self.halo,
                       int(self.cfg["e_max"]), is_u8)

    def _resolve_libraries(self) -> None:
        """The native solver library and, on the card, the min-plus
        kernel's, through ``core/build.py``'s counted cache."""
        from .. import native
        from ..ops import edt

        native.library()
        if self.device.type == "cuda":
            edt.kernel_library()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ensure_compiled(self, dtype_str: str = "uint8") -> None:
        """Build (or load from ``_build/``) the libraries and run one block
        on zeros of the padded canonical shape before serving, so the
        first request pays neither a build nor the card's lazy
        initialisation."""
        from ..workflows.fused_pipeline import resident_block

        with runtime.stage("sync-compile"):
            self._resolve_libraries()
            zeros = torch.zeros(self._padded_shape,
                                dtype=getattr(torch, dtype_str),
                                device=self.device)
            block = self.blocking.get_block(0)
            resident_block(zeros, block.begin,
                           [e - b for b, e in zip(block.begin, block.end)],
                           self._params(dtype_str == "uint8"))
            self._sync()

    def prepare(self, volume: np.ndarray) -> Dict[str, Any]:
        """Upload one request's ROI volume (padded to the canonical grid
        by volume-level reflection, the same fold as the blockwise
        readers) through pinned memory."""
        from ..workflows.fused_pipeline import _upload
        from ..workflows.watershed import reflect_indices

        if tuple(volume.shape) != self.volume_shape:
            raise ValueError(
                f"request volume {tuple(volume.shape)} != server ROI "
                f"geometry {self.volume_shape}")
        is_u8 = volume.dtype == np.uint8
        vol = volume if is_u8 else np.clip(
            volume.astype("float32"), 0.0, 1.0)
        volp = vol[np.ix_(*[
            reflect_indices(-h, g * b + h, s)
            for h, g, b, s in zip(self.halo, self._gdims, self.block_shape,
                                  self.volume_shape)])]
        with runtime.stage("h2d-upload"):
            vol_dev = _upload(volp, self.device)
            self._sync()
        runtime.stage_bytes("h2d-upload", volp.nbytes)
        # resolve the libraries through the counted cache EVERY request:
        # a warm request shows up as a cache hit in its status's
        # ``exec_cache`` delta (and a cold one as the build), which makes
        # warm-vs-cold dispatch assertable per request
        with runtime.stage("sync-compile"):
            self._resolve_libraries()
        xf = (vol.astype("float64") / 255.0) if is_u8 else \
            vol.astype("float64")
        # the parameters live in the REQUEST ctx, not on the pipeline:
        # block-granular round-robin interleaves requests, and a shared
        # value would let one tenant's float32 prepare() switch the
        # parameters under another tenant's uint8 blocks mid-request
        return {"vol_dev": vol_dev, "volp": volp, "xf": xf,
                "is_u8": is_u8, "params": self._params(is_u8)}

    def run_block(self, ctx: Dict[str, Any], bid: int):
        """One block program against the resident request volume: returns
        (k, dense inner labels clipped to the real block, uv, feats) with
        block-LOCAL 1-based fragment ids."""
        from ..workflows.fused_pipeline import resident_block

        block = self.blocking.get_block(bid)
        extent = [e - b for b, e in zip(block.begin, block.end)]
        with runtime.stage("dispatch"):
            tbl_d, _packed, dense_d = resident_block(
                ctx["vol_dev"], block.begin, extent, ctx["params"])
        with runtime.stage("sync-execute"):
            # a copy to pageable memory waits for the block's work on the
            # worker thread's stream
            tbl = tbl_d.cpu().numpy()
        (k_i, n_r, e_over, cap_over, ws_ok, _n_rle,
         _rle_ok) = (int(x) for x in tbl[0, :7])
        real = tuple(slice(0, e - b) for b, e in zip(block.begin,
                                                     block.end))
        if cap_over > 0 or e_over > 0:
            raise RuntimeError(
                f"block {bid}: edge/pair capacity exceeded "
                f"(e_max={self.cfg['e_max']}) — shrink the ROI geometry")
        if not ws_ok:
            from ..workflows.fused_pipeline import _host_block_fallback

            outer_sl = tuple(slice(b, b + o) for b, o in
                             zip(block.begin, self.outer_shape))
            with runtime.stage("host-fallback"):
                dense_np, uv_np, feats_np, k_i = _host_block_fallback(
                    ctx["volp"][outer_sl], dict(self.cfg), self.halo,
                    block, device=str(self.device))
            return k_i, dense_np.astype("uint32"), \
                uv_np.astype("int64"), feats_np
        with runtime.stage("fetch-dense"):
            # int16 on the card when every id fits: half the download
            dense = dense_d.to(torch.int16) if k_i < (1 << 15) else dense_d
            dense_np = dense.cpu().numpy()
        runtime.stage_bytes("fetch-dense", dense_np.nbytes)
        uv_np = tbl[1:1 + n_r, :2].astype("int64")
        feats_np = tbl[1:1 + n_r, 2:].astype("float64")
        return k_i, dense_np[real].astype("uint32"), uv_np, feats_np

    def finalize(self, ctx: Dict[str, Any], block_results: List) -> Dict:
        """Host tail: assemble the global fragment volume, add the
        cross-block face edges, merge the per-block tables
        (count-weighted means), transform to signed costs, solve the
        multicut and relabel — the whole ProblemWorkflow at ROI scale."""
        from ..ops.rag import segmented_stats, unique_pairs
        from ..workflows.costs import transform_probabilities_to_costs
        from . import solvers

        with runtime.stage("host-solve"):
            frag = np.zeros(self.volume_shape, "uint32")
            offs = [0]
            uvs, means, cnts = [], [], []
            for bid, (k_i, dense_np, uv_np, feats_np) in enumerate(
                    block_results):
                block = self.blocking.get_block(bid)
                off = offs[-1]
                out = dense_np.astype("uint32")
                out[out > 0] += np.uint32(off)
                frag[block.bb] = out
                if len(uv_np):
                    uvs.append(uv_np.astype("int64") + off)
                    means.append(feats_np[:, 0])
                    cnts.append(feats_np[:, -1])
                offs.append(off + k_i)
            n_frag = offs[-1]

            # cross-block faces: grid-aligned boundary planes of the
            # ASSEMBLED fragment volume (two samples per face pair, the
            # nifty gridRag convention FusedFaceAssembly uses)
            xf = ctx["xf"]
            fu, fv, fx = [], [], []
            for axis in range(3):
                for c in range(self.block_shape[axis],
                               self.volume_shape[axis],
                               self.block_shape[axis]):
                    lo = tuple(slice(c - 1, c) if d == axis
                               else slice(None) for d in range(3))
                    hi = tuple(slice(c, c + 1) if d == axis
                               else slice(None) for d in range(3))
                    la, lb = frag[lo].ravel(), frag[hi].ravel()
                    fg = (la > 0) & (lb > 0) & (la != lb)
                    if not fg.any():
                        continue
                    u = np.minimum(la[fg], lb[fg]).astype("int64")
                    v = np.maximum(la[fg], lb[fg]).astype("int64")
                    fu.extend([u, u])
                    fv.extend([v, v])
                    fx.extend([xf[lo].ravel()[fg], xf[hi].ravel()[fg]])
            if fu:
                fu = np.concatenate(fu)
                fv = np.concatenate(fv)
                fx = np.concatenate(fx)
                uniq, inv = unique_pairs(fu, fv)
                face_feats = segmented_stats(inv, fx, len(uniq))
                uvs.append(uniq.astype("int64"))
                means.append(face_feats[:, 0])
                cnts.append(face_feats[:, -1])

            if uvs:
                uv = np.concatenate(uvs)
                mean = np.concatenate(means)
                cnt = np.maximum(np.concatenate(cnts), 1.0)
                # merge duplicate rows across blocks/faces by
                # count-weighted mean (sample counts add)
                uniq, inv = unique_pairs(uv[:, 0], uv[:, 1])
                sums = np.bincount(inv, mean * cnt, len(uniq))
                sizes = np.bincount(inv, cnt, len(uniq))
                mean = sums / sizes
                uv = uniq.astype("int64")
                costs = transform_probabilities_to_costs(
                    mean, beta=float(self.cfg["beta"]),
                    edge_sizes=sizes.astype("float64"))
                solver = solvers.key_to_agglomerator(
                    self.cfg["agglomerator"])
                node_labels = solver(n_frag + 1, uv,
                                     costs.astype("float64"))
                n_edges = int(len(uv))
            else:
                node_labels = np.arange(n_frag + 1, dtype="uint64")
                n_edges = 0
            seg_map = node_labels.astype("uint64") + 1
            seg_map[0] = 0
            seg = seg_map[frag]
        return {"segmentation": seg, "n_fragments": int(n_frag),
                "n_segments": int(len(np.unique(seg[seg > 0]))),
                "n_edges": n_edges}


class ResidentSegmentationServer:
    """Always-on executor for many small ROI requests from N tenants.

    Usage::

        server = ResidentSegmentationServer(workdir, pipeline)
        server.start()                       # owns the device from here
        h = server.submit("alice", volume)   # returns immediately
        seg = h.result()["segmentation"]
        server.shutdown()                    # graceful drain

    Scheduling contract: FIFO within a tenant, round-robin ACROSS
    tenants at block granularity — each sweep serves one block of each
    waiting tenant's oldest request.
    """

    def __init__(self, workdir: str, pipeline,
                 name: str = "segmentation_server",
                 metrics_path: Optional[str] = None,
                 metrics_interval_s: float = 2.0,
                 clock=time.perf_counter,
                 slo=None,
                 admission_hook=None,
                 latency_buckets=telemetry.DEFAULT_LATENCY_BUCKETS,
                 occupancy_samples: int = 4096,
                 lane_pipelines: Optional[Dict[str, Any]] = None):
        self.workdir = workdir
        self.pipeline = pipeline
        # per-lane pipeline routing: lane name -> pipeline (unlisted lanes
        # use the default).  The edits/ subsystem mounts its EditPipeline
        # on the "edit" lane this way — same scheduler, same telemetry,
        # different request semantics
        self.lane_pipelines: Dict[str, Any] = dict(lane_pipelines or {})
        self.name = name
        # request-lifecycle clock: injectable so the load harness's
        # deterministic virtual-time mode can drive generator, server
        # and SLO engine from ONE clock (latencies become exact)
        self._clock = clock
        # optional slo.SLOEngine: fed every terminal request, source of
        # the overload gauge and the admission-control decision input
        self.slo = slo
        # admission hook point: callable(tenant, lane, overloaded) ->
        # bool; False rejects the submit with AdmissionRejected.  None
        # accepts everything
        self.admission_hook = admission_hook
        self._latency_buckets = tuple(latency_buckets)
        os.makedirs(workdir, exist_ok=True)
        # Prometheus snapshot the worker rewrites periodically (and on
        # every request completion); metrics_path="" disables it
        self.metrics_path = (os.path.join(workdir, "metrics.prom")
                             if metrics_path is None else metrics_path)
        self._metrics_interval = float(metrics_interval_s)
        self._metrics_last = 0.0
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rr_next = 0                 # round-robin cursor over tenants
        # named_lock: plain threading.Lock normally; under the lock-order
        # witness (runtime.lock_witness_configure) an instrumented lock
        # recording acquisition order + blocking-under-lock violations
        self._lock = runtime.named_lock(f"server:{name}")
        self._work = threading.Condition(self._lock)
        # accepting from construction: requests may queue BEFORE start()
        # (the worker only begins consuming once started)
        self._accepting = True
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._served: Dict[str, int] = {}
        # bounded: an always-on service must not grow per-request state
        # forever (stats() reports the RECENT window + total counts)
        self._request_log: deque = deque(maxlen=1000)
        # latency distributions (cumulative-bucket histograms): request
        # latency and queue wait per lane, request latency per tenant
        self._lat_hist: Dict[str, telemetry.Histogram] = {}
        self._wait_hist: Dict[str, telemetry.Histogram] = {}
        self._tenant_hist: Dict[str, telemetry.Histogram] = {}
        self._rejected: Dict[str, int] = {}
        # occupancy timeline: gauge samples at enqueue, claim AND
        # completion — no blind spots between claims
        self._occupancy: deque = deque(maxlen=int(occupancy_samples))

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ResidentSegmentationServer":
        with self._lock:
            if self._thread is not None:
                return self
            if not self._accepting:
                raise RuntimeError(f"{self.name} was shut down")
            self._thread = threading.Thread(
                target=self._serve_loop, name=self.name, daemon=True)
            self._thread.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting requests; with ``drain=True`` (default) every
        queued request still completes before the worker exits, with
        ``drain=False`` queued-but-unstarted requests are cancelled."""
        cancelled = []
        with self._lock:
            self._accepting = False
            if not drain:
                # cancel QUEUED requests; a request the worker is
                # mid-way through stays in its queue so the worker
                # finishes it (its caller still gets a result and a
                # final status — never an abandoned done-event)
                for q in self._queues.values():
                    keep = []
                    for req in q:
                        if req.state == "queued":
                            req.state = "cancelled"
                            req.error = "cancelled at shutdown"
                            cancelled.append(req)
                        else:
                            keep.append(req)
                    q.clear()
                    q.extend(keep)
                self._occupancy_sample_locked("cancel")
            self._work.notify_all()
        # status IO + done-event wakeups happen OUTSIDE the lock (no
        # blocking under the lock): the state flip and dequeue
        # above were atomic, so the worker can no longer claim these
        for req in cancelled:
            try:
                self._write_status(req)
            except OSError:
                pass
            req.done.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None   # keep the handle if join timed out
        # final snapshot so a scrape after shutdown sees the drained state
        if self.metrics_path:
            try:
                self.write_metrics()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)
        return False

    # -- client API ----------------------------------------------------
    def submit(self, tenant: str, volume: np.ndarray, lane: str = "bulk",
               arrival_t: Optional[float] = None,
               **params) -> RequestHandle:
        """Enqueue one request.  ``lane`` tags the request's priority
        class for the latency histograms and SLO objectives;
        ``arrival_t`` lets an open-loop load generator charge latency
        from the SCHEDULED arrival instant rather than the submit call
        (under overload the two diverge, and open-loop semantics demand
        the former)."""
        if self.admission_hook is not None and \
                not self.admission_hook(tenant, lane, self.overloaded()):
            with self._lock:
                self._rejected[lane] = self._rejected.get(lane, 0) + 1
            raise AdmissionRejected(
                f"request from {tenant} (lane={lane}) rejected by "
                "admission hook")
        req_id = f"{tenant}_{next(self._seq)}"
        pipeline = self.lane_pipelines.get(lane, self.pipeline)
        n_blocks = (pipeline.request_n_blocks(volume)
                    if hasattr(pipeline, "request_n_blocks")
                    else pipeline.n_blocks)
        req = _Request(
            req_id, tenant, volume, params,
            n_blocks=n_blocks, lane=lane, pipeline=pipeline,
            status_path=os.path.join(self.workdir,
                                     f"request_{req_id}.status"))
        req.submitted_at = (self._clock() if arrival_t is None
                            else float(arrival_t))
        with self._lock:
            if not self._accepting:
                raise RuntimeError(f"{self.name} is not accepting "
                                   "requests (shut down?)")
            depth, in_flight = self._gauges_locked()
        # pre-publish the queued status OUTSIDE the lock (no blocking
        # under the lock): the file exists before the worker can
        # see the request, so every later write (claim-time gauge
        # re-snapshot, terminal states) strictly supersedes this one.
        # Gauges count this request manually — it is not enqueued yet.
        req.queue_depth = depth + 1
        req.in_flight = dict(in_flight)
        self._write_status(req)
        with self._lock:
            if not self._accepting:
                # raced with shutdown between the two critical sections
                req.state = "cancelled"
                req.error = "cancelled at shutdown"
                raise RuntimeError(f"{self.name} is not accepting "
                                   "requests (shut down?)")
            self._queues.setdefault(tenant, deque()).append(req)
            self._occupancy_sample_locked("enqueue")
            self._work.notify_all()
        return RequestHandle(req)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued request has finished (the service
        keeps accepting).  Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while any(self._queues.values()):
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._work.wait(left)
        # drained: flush the throttled metrics snapshot so a scrape right
        # after a drain never sees a stale backlog (outside the lock —
        # write_metrics takes it)
        if self.metrics_path:
            try:
                self.write_metrics()
            except OSError:
                pass
        return True

    def overloaded(self) -> bool:
        """The SLO engine's multi-window overload verdict (False when no
        engine is attached) — the admission hook's third argument."""
        return bool(self.slo is not None and self.slo.overload())

    def occupancy_timeline(self) -> List[Dict[str, Any]]:
        """Recent (bounded) gauge samples taken at enqueue, claim and
        completion — the serve path's occupancy-over-time record."""
        with self._lock:
            return list(self._occupancy)

    def _occupancy_sample_locked(self, event: str) -> None:
        depth, inflight = self._gauges_locked()
        self._occupancy.append({
            "t": round(self._clock(), 6), "event": event,
            "queue_depth": depth, "tenants": len(inflight)})

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tenants_served": dict(self._served),
                "requests": list(self._request_log),
                "exec_cache": runtime.exec_cache_snapshot(),
            }

    def latency_histograms(self):
        """Copies of the live distributions: ``(request latency by lane,
        queue wait by lane, request latency by tenant)`` — the load
        harness reads percentiles (and the determinism test bucket
        counts) from these."""
        with self._lock:
            return ({l: h.copy() for l, h in self._lat_hist.items()},
                    {l: h.copy() for l, h in self._wait_hist.items()},
                    {t: h.copy() for t, h in self._tenant_hist.items()})

    def _gauges_locked(self):
        """(queue_depth, per-tenant in-flight) — called under the lock.
        A running request stays in its queue until its terminal pop, so
        both gauges count queued + in-flight work."""
        return (sum(len(q) for q in self._queues.values()),
                {t: len(q) for t, q in self._queues.items() if q})

    def write_metrics(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Prometheus text-format snapshot (server gauges +
        runtime counters).  Takes the lock for the gauge snapshot — must
        NOT be called while holding it (see _finish's deadlock note)."""
        path = path or self.metrics_path
        if not path:
            return None
        # SLO evaluation BEFORE taking our lock (the engine has its own)
        rep = self.slo.report() if self.slo is not None else None
        with self._lock:
            depth, inflight = self._gauges_locked()
            served = dict(self._served)
            rejected = dict(self._rejected)
            lat = [({"lane": l}, h.copy()) for l, h in
                   sorted(self._lat_hist.items())]
            wait = [({"lane": l}, h.copy()) for l, h in
                    sorted(self._wait_hist.items())]
            ten = [({"tenant": t}, h.copy()) for t, h in
                   sorted(self._tenant_hist.items())]
        families = [
            ("ctt_server_queue_depth", "gauge",
             "Requests queued or in flight across all tenants",
             [(None, depth)]),
            ("ctt_server_in_flight", "gauge",
             "Requests queued or in flight per tenant",
             [({"tenant": t}, n) for t, n in sorted(inflight.items())]
             or [(None, 0)]),
            ("ctt_server_requests_served_total", "counter",
             "Completed (done or failed) requests per tenant",
             [({"tenant": t}, n) for t, n in sorted(served.items())]),
            ("ctt_server_overload", "gauge",
             "1 when any SLO objective breaches on every burn-rate "
             "window",
             [(None, int(bool(rep["overload"])) if rep is not None
               else 0)]),
            ("ctt_server_admission_rejected_total", "counter",
             "Requests declined by the admission hook, per lane",
             [({"lane": l}, n) for l, n in sorted(rejected.items())]
             or [(None, 0)]),
        ]
        if lat:
            families.append(telemetry.histogram_family(
                "ctt_server_request_latency_seconds",
                "Request latency (submit/arrival to terminal) per lane",
                lat))
        if wait:
            families.append(telemetry.histogram_family(
                "ctt_server_queue_wait_seconds",
                "Queue wait (submit/arrival to first quantum) per lane",
                wait))
        if ten:
            families.append(telemetry.histogram_family(
                "ctt_server_tenant_latency_seconds",
                "Request latency per tenant", ten))
        if self.slo is not None:
            families += self.slo.metrics_families(rep)
        # lane-routed pipelines contribute their own families (the edit
        # lane's ctt_edit_* counters/histograms land in the same scrape)
        for lp in self.lane_pipelines.values():
            if hasattr(lp, "metrics_families"):
                families += lp.metrics_families()
        families += runtime.metrics_families()
        families += telemetry.metrics_families()
        # witness marker: the Prometheus rewrite must never run under
        # the server lock (write_metrics itself takes it above)
        with runtime.witness_blocking("metrics-write"):
            return telemetry.write_prometheus(path, families)

    # -- scheduler -----------------------------------------------------
    def _pick(self) -> Optional[_Request]:
        """Lane-aware fair pick: ``edit``-lane requests are claimed before
        ``bulk`` within the round-robin tenant scan (interactive
        proofreading must not wait behind streamed ROI jobs); within a priority class, next tenant
        in round-robin order, and within the tenant the OLDEST request
        (FIFO — only each queue's head is considered, so a tenant's edit
        never overtakes its own earlier bulk work).  With no edit
        requests queued this degenerates to the original fair
        round-robin.  Called under the lock."""
        tenants = list(self._queues.keys())
        if not tenants:
            return None
        n = len(tenants)
        for edit_only in (True, False):
            for i in range(n):
                tenant = tenants[(self._rr_next + i) % n]
                q = self._queues[tenant]
                if q and (q[0].lane == "edit" or not edit_only):
                    self._rr_next = (self._rr_next + i + 1) % n
                    return q[0]
        return None

    def _retire(self, req: _Request) -> None:
        """Pop a finished request from its queue (terminal pop) and wake
        waiters.  No-op while the request still has blocks left."""
        with self._lock:
            if req.done.is_set() or req.error is not None:
                q = self._queues.get(req.tenant)
                if q and q[0] is req:
                    q.popleft()
                # completion sample AFTER the terminal pop: the timeline
                # shows the backlog the NEXT pick will see
                self._occupancy_sample_locked(
                    "done" if req.state == "done" else "failed")
                self._work.notify_all()

    def step_once(self) -> bool:
        """Run ONE scheduling quantum on the calling thread (no worker).

        The deterministic spine of the load harness's virtual-time mode:
        with an injected clock and a synchronous pipeline, driving the
        server exclusively through ``step_once`` makes every latency —
        hence every histogram bucket count — an exact function of the
        seed.  Returns False when no request is runnable.  Mutually
        exclusive with ``start()``: refusing to mix modes is what keeps
        the quantum single-threaded."""
        if self._thread is not None:
            raise RuntimeError(
                f"{self.name}: step_once() cannot run while the worker "
                "thread owns the device (started server)")
        with self._lock:
            req = self._pick()
        if req is None:
            return False
        self._step(req)
        self._retire(req)
        return True

    def _serve_loop(self) -> None:
        while True:
            with self._lock:
                req = self._pick()
                while req is None:
                    if not self._accepting:
                        return
                    self._work.wait()
                    req = self._pick()
            self._step(req)
            self._retire(req)
            # periodic metrics rewrite between quanta (outside the lock;
            # terminal steps also write immediately, see _step)
            if self.metrics_path and (time.monotonic() - self._metrics_last
                                      >= self._metrics_interval):
                self._metrics_last = time.monotonic()
                try:
                    self.write_metrics()
                except OSError:
                    pass

    def _step(self, req: _Request) -> None:
        """One scheduling quantum: a single block of ``req`` (plus the
        upload on its first quantum and the finalize tail on its last).
        Per-request stage attribution comes from deltas of the global
        accumulators — the worker is the only thread timing stages."""
        with self._lock:
            # claim under the lock: shutdown's cancel sweep only touches
            # 'queued' requests under the same lock, so a request is
            # either cancelled here (and skipped) or running (and safe)
            if req.done.is_set() or req.state == "cancelled":
                return
            if req.state == "queued":
                req.state = "running"
                # claim-time gauge snapshot: the backlog THIS request saw
                # when it first got the device
                req.queue_depth, req.in_flight = self._gauges_locked()
                self._occupancy_sample_locked("claim")
        st0 = runtime.stages_snapshot()
        cn0 = runtime.counts_snapshot()
        ex0 = runtime.exec_cache_snapshot()
        pipeline = req.pipeline if req.pipeline is not None else self.pipeline
        try:
            if req.started_at is None:
                req.started_at = self._clock()
                req.ctx = pipeline.prepare(req.volume)
                telemetry.record("queue-wait", req.submitted_at,
                                 req.started_at, cat="queue-wait",
                                 tenant=req.tenant, request=req.req_id,
                                 lane=req.lane)
            bid = req.next_block
            with telemetry.span(f"block:{bid}", cat="block", block=bid,
                                tenant=req.tenant,
                                request=req.req_id) as sp:
                req.block_results.append(
                    pipeline.run_block(req.ctx, bid))
                telemetry.annotate_memory(sp)
            req.next_block += 1
            if req.next_block >= req.n_blocks:
                req.result = pipeline.finalize(req.ctx,
                                               req.block_results)
                self._finish(req, "done")
        except Exception as e:          # noqa: BLE001 — isolate tenants
            req.error = f"{type(e).__name__}: {e}"
            self._finish(req, "failed")
            # postmortem dump for the faulted request: span ring, memory
            # timeline, queue state and the correlation id — best-effort
            # (the recorder must never take down the worker)
            try:
                self._flight_record(req)
            except Exception:           # noqa: BLE001 — telemetry only
                pass
        finally:
            # the worker serializes quanta, so these per-step deltas are
            # EXACTLY this request's activity — no cross-tenant bleed
            for k, v in runtime.stages_delta(st0).items():
                req.stages[k] = req.stages.get(k, 0.0) + v
            for k, v in runtime.counts_delta(cn0).items():
                req.stage_counts[k] = req.stage_counts.get(k, 0) + v
            for k, v in runtime.exec_cache_delta(ex0).items():
                req.exec_cache[k] = round(req.exec_cache.get(k, 0) + v, 4)
            if req.state in ("done", "failed"):
                # final status BEFORE signalling completion: a client
                # woken by done() must never read the stale queued
                # status.  The write itself must never kill the worker
                # (status is telemetry; a full disk would otherwise
                # strand every queued request)
                try:
                    self._write_status(req)
                except OSError:
                    pass
                # whole-request span (queue-wait -> blocks -> tail) and
                # an immediate metrics rewrite — both OUTSIDE self._lock
                # (write_metrics takes it)
                telemetry.record(f"request:{req.req_id}",
                                 req.submitted_at,
                                 req.finished_at if req.finished_at
                                 is not None else self._clock(),
                                 cat="request", tenant=req.tenant,
                                 request=req.req_id, state=req.state,
                                 n_blocks=req.n_blocks, lane=req.lane)
                req.done.set()
                if self.metrics_path:
                    self._metrics_last = time.monotonic()
                    try:
                        self.write_metrics()
                    except OSError:
                        pass

    def _finish(self, req: _Request, state: str) -> None:
        """Terminal bookkeeping; the caller (_step) writes the final
        status and THEN sets the done event."""
        req.state = state
        req.finished_at = self._clock()
        # free the device volume: its memory goes back to the caching
        # allocator for the next request
        req.ctx = None
        req.volume = None
        req.block_results = []
        lat = req.finished_at - req.submitted_at
        # explicit None check: a virtual clock legitimately starts at 0.0
        wait = ((req.started_at if req.started_at is not None
                 else req.finished_at) - req.submitted_at)
        with self._lock:
            self._served[req.tenant] = self._served.get(req.tenant, 0) + 1
            self._request_log.append({
                "request_id": req.req_id, "tenant": req.tenant,
                "lane": req.lane, "state": state,
                "latency_s": round(lat, 4),
                "queue_wait_s": round(wait, 4),
            })
            self._lat_hist.setdefault(
                req.lane,
                telemetry.Histogram(self._latency_buckets)).observe(lat)
            self._wait_hist.setdefault(
                req.lane,
                telemetry.Histogram(self._latency_buckets)).observe(wait)
            self._tenant_hist.setdefault(
                req.tenant,
                telemetry.Histogram(self._latency_buckets)).observe(lat)
        # feed the SLO engine OUTSIDE our lock (it has its own)
        if self.slo is not None:
            self.slo.record(req.lane, lat, ok=(state == "done"))

    def _flight_record(self, req: _Request) -> Optional[str]:
        """Dump a flight-recorder snapshot for a faulted request into the
        server workdir: queue/SLO state plus the in-flight correlation
        ids, on top of telemetry's span ring + memory timeline."""
        with self._lock:
            depth, inflight = self._gauges_locked()
            pending = [r.req_id for q in self._queues.values() for r in q]
        rep = None
        if self.slo is not None:
            try:
                rep = self.slo.report()
            except Exception:           # noqa: BLE001 — telemetry only
                rep = None
        return telemetry.flight_record(
            self.workdir, f"tenant-fault:{req.req_id}",
            extra={
                "request": req.req_id,
                "tenant": req.tenant,
                "lane": req.lane,
                "error": req.error,
                "blocks_done": req.next_block,
                "n_blocks": req.n_blocks,
                "queue_depth": int(depth),
                "in_flight": {t: int(n) for t, n in sorted(
                    inflight.items())},
                "pending_requests": pending,
                "slo": rep,
            })

    def _write_status(self, req: _Request) -> None:
        now = self._clock()
        status = {
            "request": req.req_id,
            "tenant": req.tenant,
            "lane": req.lane,
            "state": req.state,
            "n_blocks": req.n_blocks,
            "blocks_done": req.next_block,
            "queue_wait_s": round(
                (req.started_at - req.submitted_at)
                if req.started_at is not None
                else (now - req.submitted_at), 4),
            "wall_time": round(
                ((req.finished_at if req.finished_at is not None
                  else now) - req.submitted_at), 4),
            "stages": {k: round(v, 4) for k, v in sorted(
                req.stages.items(), key=lambda kv: -kv[1])},
            "stage_counts": dict(sorted(req.stage_counts.items(),
                                        key=lambda kv: -kv[1])),
            "exec_cache": dict(req.exec_cache),
            # live bytes pinned by the warm caches at status-write time
            # (server-wide accounts, not per-request deltas)
            "ledger": runtime.ledger_snapshot(),
            # scheduler gauges as this request saw them: snapshotted at
            # submit, re-snapshotted when the worker claimed the request
            "queue_depth": int(req.queue_depth),
            "in_flight": {t: int(n) for t, n in
                          sorted(req.in_flight.items())},
            "error": req.error,
        }
        if req.result is not None:
            status["n_fragments"] = req.result.get("n_fragments")
            status["n_segments"] = req.result.get("n_segments")
        # witness marker: status IO must never run under the server lock
        with runtime.witness_blocking("status-write"):
            config_mod.write_config(req.status_path, status)
