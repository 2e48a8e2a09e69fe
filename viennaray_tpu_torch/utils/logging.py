"""Leveled logging (port of the ViennaCore logger surface used by the
reference: ``Logger::setLogLevel(LogLevel::DEBUG)``,
examples/triangle3D/triangle3D.cpp:14). A copy of
``viennaray_tpu/utils/logging.py`` under the logger "viennaray_tpu_torch"."""

from __future__ import annotations

import enum
import logging
import sys


class LogLevel(enum.IntEnum):
    ERROR = 0
    WARNING = 1
    INFO = 2
    TIMING = 3
    INTERMEDIATE = 4
    DEBUG = 5


_LEVEL_MAP = {
    LogLevel.ERROR: logging.ERROR,
    LogLevel.WARNING: logging.WARNING,
    LogLevel.INFO: logging.INFO,
    LogLevel.TIMING: logging.INFO,
    LogLevel.INTERMEDIATE: logging.DEBUG,
    LogLevel.DEBUG: logging.DEBUG,
}

logger = logging.getLogger("viennaray_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[viennaray-tpu-torch] %(levelname)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def set_log_level(level: LogLevel):
    logger.setLevel(_LEVEL_MAP[LogLevel(level)])
