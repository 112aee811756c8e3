"""Structured logging for the port.

Port of ``spark_languagedetector_tpu.utils.logging``: a per-module logger
under one namespace of the port's own, quiet by default (WARNING), and a
``log_event`` helper that attaches machine-readable key/value fields. The
root level comes from ``LANGDETECT_TPU_LOGLEVEL``: read once here at import
(the knob table in ``exec.config`` logs through this root, so it cannot
exist yet), then re-resolved through that table by
:func:`sync_level_from_config` when ``exec.config`` finishes importing.
"""

from __future__ import annotations

import json
import logging
import os
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
    # Bootstrap read (see the module docstring); a bad value keeps WARNING
    # rather than making the package unimportable.
    _level = os.environ.get("LANGDETECT_TPU_LOGLEVEL", "WARNING").upper()
    try:
        _root.setLevel(_level)
    except ValueError:
        _root.setLevel(logging.WARNING)
        _root.warning("LANGDETECT_TPU_LOGLEVEL ignored: unknown level %r", _level)
    _root.propagate = False


def get_logger(module: str) -> logging.Logger:
    """Logger namespaced under the port's root, e.g. ``persist.io``."""
    return logging.getLogger(f"{_ROOT_NAME}.{module}")


def set_level(level: str) -> None:
    _root.setLevel(level.upper())


def sync_level_from_config(resolve) -> None:
    """Re-resolve the root level through ``exec.config``'s knob table (the
    resolver is passed in, so this module imports nothing of the package):
    the live level then matches what ``effective_config`` reports for
    ``loglevel``."""
    try:
        level = resolve("loglevel")
        if level:
            _root.setLevel(str(level).upper())
    except ValueError as e:
        _root.warning("LANGDETECT_TPU_LOGLEVEL ignored: %s", e)


def log_event(logger: logging.Logger, event: str, **fields: Any) -> None:
    """Emit a structured (JSON-payload) INFO event; cheap when disabled."""
    if logger.isEnabledFor(logging.INFO):
        payload = {"event": event, "ts": time.time(), **fields}
        logger.info(json.dumps(payload, default=str))
