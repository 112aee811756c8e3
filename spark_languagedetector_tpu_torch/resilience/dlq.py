"""Dead-letter queue: quarantine for rows a streaming batch cannot score.

Port of ``spark_languagedetector_tpu.resilience.dlq``; the records and the
JSONL file are the same in both packages.

Spark Structured Streaming kills the whole query when a batch exhausts its
task retries; the production answer (and this module) is to quarantine the
offending input instead — the query keeps serving every healthy row, and
the poison rows land somewhere a human (or a replayer) can find them with
enough context to debug: batch sequence number, row index, the full row,
the error, and a timestamp.

The queue is an in-memory record list plus an optional append-only JSONL
file (one ``dlq.row`` object per line — the same event-log shape as the
telemetry JSONL, so the usual tooling greps it). Writes are contained: a
full disk must degrade the quarantine to memory-only, never take down the
stream that is busy surviving a poison batch.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings

from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("resilience.dlq")


class DeadLetterQueue:
    """Ordered record of quarantined rows; optionally file-backed."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []
        self._lock = threading.Lock()
        self._fh = None
        self._write_warned = False
        if path is not None:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")

    def put(self, *, batch: int, row_index: int, row: dict, error: str) -> dict:
        """Quarantine one row; returns the stored record."""
        record = {
            "event": "dlq.row",
            "ts": time.time(),
            "batch": int(batch),
            "row_index": int(row_index),
            "row": row,
            "error": error,
        }
        with self._lock:
            self.records.append(record)
            count = len(self.records)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(record, default=str) + "\n")
                    self._fh.flush()
                except Exception as e:
                    REGISTRY.incr("resilience/dlq_write_errors")
                    if not self._write_warned:
                        self._write_warned = True
                        warnings.warn(
                            f"dead-letter file {self.path!r} write failed, "
                            f"quarantining in memory only: {e}",
                            RuntimeWarning,
                            stacklevel=2,
                        )
        REGISTRY.incr("resilience/dlq_rows")
        REGISTRY.set_gauge("langdetect_dlq_rows", count)
        log_event(_log, "dlq.row", batch=batch, row_index=row_index, error=error)
        return record

    def rows(self) -> list[dict]:
        """The quarantined row payloads, in arrival order."""
        with self._lock:
            return [r["row"] for r in self.records]

    def __len__(self) -> int:
        with self._lock:
            return len(self.records)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    @staticmethod
    def load(path: str) -> list[dict]:
        """Read a dead-letter JSONL file back into record dicts."""
        out: list[dict] = []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
