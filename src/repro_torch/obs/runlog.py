"""Structured JSONL run log for launch/train.py.

One JSON object per line, two row kinds:

  {"kind": "round", "round": r, "loss": ..., "tau": ...}
  {"kind": "chunk", "start": r0, "stop": r1, "telemetry": [RoundTelemetry
   .to_json(), ...], "metrics": {...}}

Resume safety: a checkpoint at round k restarts training at round k+1,
but the previous process may have logged rounds past k before dying (the
engine runs ahead of ckpt_every-aligned chunk boundaries). On open with
``resume_round=k+1`` the log is truncated to rows strictly before the
restart point — round rows with round < resume_round, chunk rows with
stop <= resume_round — so re-run rounds are never duplicated. Truncation
rewrites via a temp file + os.replace, so a crash mid-truncate leaves
either the old or the new log, never a torn one.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional


def _keep_on_resume(row: Dict[str, Any], resume_round: int) -> bool:
    kind = row.get("kind")
    if kind == "round":
        return row.get("round", -1) < resume_round
    if kind == "chunk":
        return row.get("stop", -1) <= resume_round
    return True    # unknown kinds (headers, notes) are preserved


class RunLog:
    """Append-only JSONL writer with resume-safe truncation."""

    def __init__(self, path: str, resume_round: int = 0,
                 log_every: int = 1):
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        self.path = path
        self.log_every = int(log_every)
        if resume_round > 0 and os.path.exists(path):
            kept = [r for r in read_jsonl(path)
                    if _keep_on_resume(r, resume_round)]
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                for row in kept:
                    fh.write(json.dumps(row) + "\n")
            os.replace(tmp, path)
        self._fh = open(path, "a", encoding="utf-8")

    def write(self, row: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def round(self, round_idx: int, **fields) -> None:
        """Log one round row, honouring log_every (round 0 always logs)."""
        if round_idx % self.log_every == 0:
            self.write({"kind": "round", "round": int(round_idx), **fields})

    def chunk(self, start: int, stop: int,
              telemetry: Iterable[Any] = (), **fields) -> None:
        """Log one chunk row; telemetry items are RoundTelemetry records
        (serialized via .to_json()) or plain dicts."""
        tel = [t.to_json() if hasattr(t, "to_json") else dict(t)
               for t in telemetry]
        self.write({"kind": "chunk", "start": int(start), "stop": int(stop),
                    "telemetry": tel, **fields})

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def read_jsonl(path: str, kind: Optional[str] = None
               ) -> List[Dict[str, Any]]:
    """Read a JSONL log back; optionally filter by row kind. Tolerates a
    trailing partial line (crash mid-write)."""
    rows: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if kind is None or row.get("kind") == kind:
                rows.append(row)
    return rows
