"""Leveled logging helpers.

Copy of ``llmd_kv_cache_tpu/utils/logging.py`` under this package's logger
namespace (``llmd_kv_cache_tpu_torch.<name>``).

Mirrors the reference's verbosity convention (``pkg/utils/logging/levels.go``:
DEBUG=1, TRACE=2 on top of INFO) onto Python's stdlib logging: DEBUG maps to
``logging.DEBUG`` and TRACE to a custom finer level. Level selection via the
``KVTPU_LOG_LEVEL`` env var (``info``/``debug``/``trace``).
"""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"llmd_kv_cache_tpu_torch.{name}")


def trace(logger: logging.Logger, msg: str, *args) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, *args)


def configure_from_env() -> None:
    """Configure root logger level from ``KVTPU_LOG_LEVEL``."""
    level_name = os.environ.get("KVTPU_LOG_LEVEL", "info").lower()
    level = {"trace": TRACE, "debug": logging.DEBUG, "info": logging.INFO,
             "warn": logging.WARNING, "warning": logging.WARNING,
             "error": logging.ERROR}.get(level_name, logging.INFO)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
