"""Structured JSON-lines logger.

The port's own copy of ``mri_acl_imagesegmentation_adsp_tpu/utils/
logger.py`` (the reference's ``src/utils/logger.py``): one JSON object a
line with timestamp, level, logger, message, run id and host, the
record's process / thread / code location, and any user extras; a
midnight-rotating file handler keeping 7 backups; ``RUN_ID`` from
``$RUN_ID`` or made fresh, and ``get_logger`` / ``set_run_id``.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import sys
import time
import uuid
from logging.handlers import TimedRotatingFileHandler
from typing import Any, Dict


def _fresh_run_id() -> str:
    return f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"


RUN_ID = os.environ.get("RUN_ID") or _fresh_run_id()
HOST = socket.gethostname()

# LogRecord attribute -> output key
_RECORD_FIELDS = {
    "process": "pid",
    "processName": "processName",
    "thread": "tid",
    "threadName": "threadName",
    "module": "module",
    "funcName": "func",
    "lineno": "lineno",
    "pathname": "pathname",
}

# record attributes that are logging plumbing, never user extras
_PLUMBING = frozenset({"args", "msg", "message", "exc_text", "exc_info"})

_JSONABLE = (str, int, float, bool, dict, list, type(None))


class JsonFormatter(logging.Formatter):
    """Each record, with its extras, as one JSON line."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.localtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "run_id": RUN_ID,
            "host": HOST,
        }
        out.update({key: getattr(record, attr)
                    for attr, key in _RECORD_FIELDS.items()})

        extra = getattr(record, "extra", None)
        if isinstance(extra, dict):
            out.update(extra)
        for name, value in vars(record).items():
            if name in out or name in _PLUMBING:
                continue
            if isinstance(value, _JSONABLE):
                out[name] = value
        return json.dumps(out, ensure_ascii=False)


def get_logger(name: str, log_file: str | None = None,
               console: bool = True) -> logging.Logger:
    """Idempotent logger factory: console and / or a midnight-rotating
    file."""
    logger = logging.getLogger(name)
    if logger.handlers:               # already configured for this name
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False

    handlers: list[logging.Handler] = []
    if console:
        handlers.append(logging.StreamHandler(sys.stdout))
    if log_file:
        log_dir = os.path.dirname(log_file)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        handlers.append(TimedRotatingFileHandler(
            log_file, when="midnight", backupCount=7, encoding="utf-8"))
    for h in handlers:
        h.setFormatter(JsonFormatter())
        h.setLevel(logging.INFO)
        logger.addHandler(h)
    return logger


def set_run_id(run_id: str) -> None:
    global RUN_ID
    RUN_ID = run_id
