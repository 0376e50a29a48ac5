"""Append-only proofreading edit log.

One JSONL file per segmentation: each record is a single merge/split
edit with a correlation id that follows the edit through the resolver,
the incremental solver, telemetry spans, and any flight-recorder dump.

Atomicity model: every append is ONE ``os.write`` of one complete
``\\n``-terminated JSON line onto an ``O_APPEND`` descriptor, followed
by an fsync — so concurrent appenders never interleave bytes within a
record, and a crash can only ever truncate the final line.  The reader
tolerates exactly that (a torn, unterminated tail is skipped unless
``strict``), which is the classic write-ahead-log contract and the
reason replay is safe after any interruption.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

#: legal edit operations: "merge" biases every pairwise edge between the
#: listed fragments attractive, "split" biases them repulsive
OPS = ("merge", "split")


@dataclass(frozen=True)
class EditRecord:
    """One replayable proofreading decision."""
    edit_id: str          #: correlation id (spans, flight records, status)
    seq: int              #: position in the log, 0-based, monotonic
    op: str               #: "merge" | "split"
    fragments: Tuple[int, ...]  #: >= 2 watershed fragment ids, nonzero
    time: float           #: wall-clock seconds at append
    note: str = ""        #: free-form provenance (user, tool, session)

    def to_json(self) -> str:
        return json.dumps({
            "edit_id": self.edit_id, "seq": self.seq, "op": self.op,
            "fragments": list(self.fragments), "time": self.time,
            "note": self.note,
        }, sort_keys=True)

    @staticmethod
    def from_json(line: str) -> "EditRecord":
        d = json.loads(line)
        return EditRecord(edit_id=str(d["edit_id"]), seq=int(d["seq"]),
                          op=str(d["op"]),
                          fragments=tuple(int(f) for f in d["fragments"]),
                          time=float(d["time"]), note=str(d.get("note", "")))


def _validate(op: str, fragments: Sequence[int]) -> Tuple[int, ...]:
    if op not in OPS:
        raise ValueError(f"unknown edit op {op!r}; expected one of {OPS}")
    frs = tuple(sorted({int(f) for f in fragments}))
    if len(frs) < 2:
        raise ValueError(
            f"an edit needs >= 2 distinct fragments, got {fragments!r}")
    if frs[0] <= 0:
        raise ValueError(
            f"fragment ids must be positive (0 is background): {frs}")
    return frs


class EditLog:
    """Append-only JSONL log of :class:`EditRecord`; see module docstring
    for the atomicity contract."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._next_seq: Optional[int] = None

    # -- append ------------------------------------------------------------

    def append(self, op: str, fragments: Sequence[int], *, note: str = "",
               edit_id: Optional[str] = None) -> EditRecord:
        """Validate, stamp, and durably append one edit; returns the
        record (with its assigned seq and correlation id)."""
        frs = _validate(op, fragments)
        with self._lock:
            if self._next_seq is None:
                # WAL recovery before the first append: a torn tail from
                # an interrupted writer is truncated away, so the new
                # record never concatenates onto a half-written line
                self._recover()
                self._next_seq = len(self.records())
            rec = EditRecord(
                edit_id=edit_id or uuid.uuid4().hex[:12],
                seq=self._next_seq, op=op, fragments=frs,
                time=time.time(), note=note)
            payload = (rec.to_json() + "\n").encode("utf-8")
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, payload)
                os.fsync(fd)
            finally:
                os.close(fd)
            self._next_seq += 1
        return rec

    def _recover(self) -> None:
        """Truncate a torn (unterminated) trailing line, if any — the
        interrupted append it came from never happened."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        if raw and not raw.endswith(b"\n"):
            keep = raw.rfind(b"\n") + 1     # 0 when no newline at all
            with open(self.path, "r+b") as f:
                f.truncate(keep)

    # -- read / replay -----------------------------------------------------

    def records(self, *, strict: bool = False) -> List[EditRecord]:
        """Parse the log.  A torn (unterminated) trailing line is skipped
        — the interrupted append never happened; ``strict=True`` raises on
        it instead.  Seq numbers must be 0..n-1 in order (an out-of-order
        log means two writers disagreed about history; always an error)."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        torn = lines[-1]  # b"" when the last record was fully terminated
        if torn and strict:
            raise ValueError(
                f"torn trailing record in {self.path!r}: {torn[:80]!r}")
        out = []
        for line in lines[:-1]:
            if not line.strip():
                continue
            out.append(EditRecord.from_json(line.decode("utf-8")))
        for i, rec in enumerate(out):
            if rec.seq != i:
                raise ValueError(
                    f"non-monotonic edit log {self.path!r}: record {i} "
                    f"has seq {rec.seq}")
        return out

    def replay(self, apply_fn: Callable[[EditRecord], None]) -> int:
        """Re-apply every durable record in order; returns the count.
        With a deterministic ``apply_fn`` (the edits session is), replay
        reconstructs the exact post-edit state from the log alone."""
        recs = self.records()
        for rec in recs:
            apply_fn(rec)
        return len(recs)

    def __len__(self) -> int:
        return len(self.records())
