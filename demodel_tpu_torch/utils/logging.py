"""Env-filtered structured logging (copy of ``demodel_tpu.utils.logging``).

One-line records tagged ``[demodel-tpu-torch <logger>] <level-letter>
<message>``, level set by ``DEMODEL_LOG`` (``debug``, ``info``,
``warning``; default info).
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "demodel_tpu_torch"
_CONFIGURED = False


class _Fmt(logging.Formatter):
    LETTER = {"DEBUG": "D", "INFO": "I", "WARNING": "W", "ERROR": "E",
              "CRITICAL": "C"}

    def format(self, record: logging.LogRecord) -> str:
        letter = self.LETTER.get(record.levelname, "?")
        return (f"[demodel-tpu-torch {record.name[len(_ROOT) + 1:]}] "
                f"{letter} {record.getMessage()}")


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_Fmt())
        root.addHandler(h)
        root.propagate = False
    level = os.environ.get("DEMODEL_LOG", "info").strip().upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """Logger ``demodel_tpu_torch.<name>`` under the env-filtered root."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}")
