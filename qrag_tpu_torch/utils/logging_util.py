"""Logging setup matching the reference's shape
(``app.py:16-18``: ``%(asctime)s - %(name)s - %(levelname)s -
%(message)s`` at INFO, per-module loggers).  The port's own copy of
``qrag_tpu.utils.logging_util``."""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def configure_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(level=level, format=_FORMAT)
