"""Streaming resume tokens: tiny atomic JSON checkpoints.

Port of ``spark_languagedetector_tpu.persist.checkpoint``; the file format
is the same, so a token written by either package resumes a stream in the
other.

The streaming engine commits one record per sunk batch (the analog of
Structured Streaming's offset log): ``{"committed": N, ...}`` means source
batches ``[0, N)`` are fully sunk and must not be re-emitted after a
restart. Writes are write-temp-then-rename atomic, so a process killed
mid-commit leaves either the previous checkpoint or the new one — never a
torn file. (Same-directory rename: POSIX guarantees atomicity only within a
filesystem.)
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

CHECKPOINT_VERSION = 1


def save_checkpoint(path: str | Path, state: dict) -> None:
    """Atomically persist ``state`` (plus version + timestamp) to ``path``."""
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    record = {"version": CHECKPOINT_VERSION, "ts": time.time(), **state}
    tmp = target.with_name(target.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(record, default=str) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, target)


def load_checkpoint(path: str | Path) -> dict | None:
    """Read a checkpoint; ``None`` when absent.

    A malformed file raises: the atomic writer cannot produce one, so
    corruption means something external touched the resume token — losing
    exactly-once silently would be worse than failing loudly.
    """
    target = Path(path)
    if not target.exists():
        return None
    text = target.read_text(encoding="utf-8").strip()
    if not text:
        raise ValueError(f"empty checkpoint file {target}")
    record = json.loads(text.splitlines()[0])
    if not isinstance(record, dict):
        raise ValueError(f"checkpoint {target} is not a JSON object")
    return record
