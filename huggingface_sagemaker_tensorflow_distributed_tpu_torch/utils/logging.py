"""Logging setup (counterpart of the JAX package's ``utils/logging.py``):
stdlib logging to stdout at INFO with a timestamped format; ranks other
than 0 log at WARNING unless ``all_hosts``."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_CONFIGURED = False


def setup_logging(level: str = "INFO", process_index: int = 0,
                  all_hosts: bool = False) -> None:
    """Configure root logging to stdout; non-zero ranks are quieted to
    WARNING unless ``all_hosts`` is set."""
    global _CONFIGURED
    effective = level if (process_index == 0 or all_hosts) else "WARNING"
    logging.basicConfig(
        level=logging.getLevelName(effective),
        handlers=[logging.StreamHandler(sys.stdout)],
        format=_FORMAT,
        force=True,
    )
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    if not _CONFIGURED:
        setup_logging()
    return logging.getLogger(name)
