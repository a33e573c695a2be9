"""Logging setup: console plus an optional rotating file, on the standard
library. Port of `vae_teb_tpu.utils.logging` (`setup_logging`,
`get_logger`) for the logger named "vae_teb_tpu_torch"."""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from typing import Optional

LOGGER = "vae_teb_tpu_torch"
_FMT = ("%(asctime)s | %(levelname)-8s | %(name)s:%(funcName)s:%(lineno)d - "
        "%(message)s")


def setup_logging(log_file: Optional[str] = None, level: int = logging.INFO,
                  rotate_mb: int = 100, backups: int = 5,
                  capture_root: bool = True) -> logging.Logger:
    """Configure the package's logger: stderr, and `log_file` rotated at
    `rotate_mb` MB when given. capture_root routes the root logger through
    the same handlers, so other libraries' logging lands there too."""
    logger = logging.getLogger(LOGGER)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter(_FMT)
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fileh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=rotate_mb * 1024 * 1024, backupCount=backups)
        fileh.setFormatter(formatter)
        logger.addHandler(fileh)
    if capture_root:
        root = logging.getLogger()
        root.setLevel(level)
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in logger.handlers:
            root.addHandler(h)
        logger.propagate = False
    return logger


def get_logger(name: str = LOGGER) -> logging.Logger:
    return logging.getLogger(name)
