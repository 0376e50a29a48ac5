"""Server-facing edit pipeline.

:class:`EditPipeline` speaks the resident server's duck-typed pipeline
protocol with the EDIT PAYLOAD as the "volume": a request submitted on
the ``edit`` lane carries ``{"op": "merge"|"split", "fragments": [...]}``
and flows submit -> resolve -> incremental solve -> LUT patch -> block
rewrite, one scheduling quantum per affected subproblem — so a cheap
edit yields the worker after each block exactly like bulk traffic does,
and the lane-priority claim order in core/server.py keeps its queue-wait
low while a bulk tenant streams ROI requests.

Every phase runs under its registered ``edit:*`` stage so the spans land
in the same telemetry the bulk path uses, and per-edit results carry the
edit-log correlation id end to end (status JSON, flight records).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core import telemetry
from ..core.runtime import stage
from .incremental import EditSession
from .log import EditLog
from .patcher import (patch_assignment_table, patch_paintera_assignment)


class EditPipeline:
    """Adapter from proofreading edits to the server pipeline protocol.

    ``assignment_path`` is the dense LUT the bulk workflow wrote
    (``.npy``); ``ws/output`` name the fragment volume and segmentation
    to patch (block grid must match the problem's
    ``sub_graph_block_shape`` so touched-block ids line up; that is the
    grid both were produced on).  Omitting ``output_path`` skips the
    block rewrite (LUT-only serving).
    """

    def __init__(self, session: EditSession, edit_log: EditLog,
                 assignment_path: str, *,
                 ws_path: Optional[str] = None,
                 ws_key: Optional[str] = None,
                 output_path: Optional[str] = None,
                 output_key: Optional[str] = None,
                 paintera_path: Optional[str] = None,
                 paintera_label_group: Optional[str] = None,
                 write_block_shape: Optional[Sequence[int]] = None):
        self.session = session
        self.log = edit_log
        self.assignment_path = assignment_path
        self.ws_path, self.ws_key = ws_path, ws_key
        self.output_path, self.output_key = output_path, output_key
        self.paintera_path = paintera_path
        self.paintera_label_group = paintera_label_group
        self.write_block_shape = list(write_block_shape
                                      or session.block_shape)
        self.blocks_rewritten = 0
        self.round_trip_hist = telemetry.Histogram()

    # -- server pipeline protocol ------------------------------------------

    def request_n_blocks(self, edit: Dict[str, Any]) -> int:
        """One scheduling quantum per affected subproblem (at least one —
        an edit between fragments sharing no block still needs its
        reduce/global pass in finalize)."""
        return max(1, len(self.session.affected_blocks(edit["fragments"])))

    def prepare(self, edit: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        with stage("edit:resolve"):
            rec = self.log.append(edit["op"], edit["fragments"],
                                  note=str(edit.get("note", "")),
                                  edit_id=edit.get("edit_id"))
            affected = self.session.apply_edit(rec)
        return {"record": rec, "affected": affected, "t0": t0}

    def run_block(self, ctx: Dict[str, Any], block_index: int):
        affected: List[int] = ctx["affected"]
        if block_index >= len(affected):
            return None
        with stage("edit:solve"):
            self.session.ensure_block(affected[block_index],
                                      expected=set(affected),
                                      corr_id=ctx["record"].edit_id)
        return int(affected[block_index])

    def finalize(self, ctx: Dict[str, Any],
                 block_results: Dict[int, Any]) -> Dict[str, Any]:
        rec = ctx["record"]
        expected = set(ctx["affected"])
        with stage("edit:solve"):
            labels = self.session.solve(incremental=True, expected=expected,
                                        corr_id=rec.edit_id)
        with stage("edit:patch"):
            new_table, changed = patch_assignment_table(
                self.assignment_path, self.session.s0_nodes, labels)
            patch_paintera_assignment(self.paintera_path,
                                      self.paintera_label_group, new_table)
        touched: List[int] = []
        if changed.size and self.output_path:
            with stage("edit:write"):
                touched = self.session.blocks_with_fragments(changed)
                from ..workflows.write import rewrite_blocks

                self.blocks_rewritten += rewrite_blocks(
                    self.ws_path, self.ws_key, self.output_path,
                    self.output_key, new_table, touched,
                    self.write_block_shape)
        dt = time.perf_counter() - ctx["t0"]
        self.round_trip_hist.observe(dt)
        return {
            "edit_id": rec.edit_id, "seq": rec.seq, "op": rec.op,
            "fragments": list(rec.fragments),
            "affected_blocks": [int(b) for b in ctx["affected"]],
            "changed_fragments": int(changed.size),
            "touched_blocks": [int(b) for b in touched],
            "round_trip_s": dt,
            "counters": dict(self.session.counters),
        }

    # -- observability ------------------------------------------------------

    def metrics_families(self):
        """Prometheus families under the registered ``ctt_edit_*`` names
        (mergeable into the server's ``write_metrics`` output)."""
        c = self.session.counters
        return [
            ("ctt_edit_applied_total", "counter",
             "Proofreading edits applied to the live session",
             [(None, c["applied"])]),
            ("ctt_edit_subproblems_total", "counter",
             "Subproblems solved cold by the edit lane",
             [(None, c["subproblems_solved"])]),
            ("ctt_edit_warm_reused_total", "counter",
             "Subproblem solutions reused after signature validation",
             [(None, c["warm_reused"])]),
            ("ctt_edit_fallback_total", "counter",
             "Stale-cache fallbacks to a full subproblem solve",
             [(None, c["fallback"])]),
            ("ctt_edit_blocks_rewritten_total", "counter",
             "Output blocks rewritten by the assignment patcher",
             [(None, self.blocks_rewritten)]),
            telemetry.histogram_family(
                "ctt_edit_round_trip_seconds",
                "End-to-end edit round-trip (submit overlay to rewrite)",
                [(None, self.round_trip_hist)]),
        ]
