"""Structured logging for the port.

Port of ``spark_languagedetector_tpu.utils.logging``: a per-module logger
under one namespace of the port's own, quiet by default (WARNING), and a
``log_event`` helper that attaches machine-readable key/value fields.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any

_ROOT_NAME = "sparklangdetect_tpu_torch"

_root = logging.getLogger(_ROOT_NAME)
if not _root.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    _root.addHandler(_handler)
    _root.setLevel(logging.WARNING)
    _root.propagate = False


def get_logger(module: str) -> logging.Logger:
    """Logger namespaced under the port's root, e.g. ``persist.io``."""
    return logging.getLogger(f"{_ROOT_NAME}.{module}")


def log_event(logger: logging.Logger, event: str, **fields: Any) -> None:
    """Emit a structured (JSON-payload) INFO event; cheap when disabled."""
    if logger.isEnabledFor(logging.INFO):
        payload = {"event": event, "ts": time.time(), **fields}
        logger.info(json.dumps(payload, default=str))
