"""Logging: console + timestamped per-experiment file (the port's own copy
of ``pointcloud_style_transfer_tpu/utils/logger.py``): named loggers writing
to stdout and to ``{log_dir}/{experiment_name}/{ts}.log``, with handler
de-duplication so repeated construction doesn't double-log.
"""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime


def get_logger(
    name: str = "pcst",
    log_dir: str | None = None,
    experiment_name: str | None = None,
    file_output: bool = True,
    level: int = logging.INFO,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False

    if not any(isinstance(h, logging.StreamHandler) and h.stream is sys.stdout
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(
            "%(asctime)s [%(name)s] %(levelname)s: %(message)s", "%H:%M:%S"))
        logger.addHandler(sh)

    if file_output and log_dir is not None:
        exp = experiment_name or "default"
        dir_path = os.path.join(log_dir, exp)
        has_file = any(isinstance(h, logging.FileHandler) for h in logger.handlers)
        if not has_file:
            os.makedirs(dir_path, exist_ok=True)
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            fh = logging.FileHandler(os.path.join(dir_path, f"{ts}.log"))
            fh.setFormatter(logging.Formatter(
                "%(asctime)s [%(name)s] %(levelname)s: %(message)s"))
            logger.addHandler(fh)

    return logger


class Logger:
    """Class facade over ``get_logger`` (``Logger(name, log_dir,
    experiment_name).info(...)``)."""

    def __init__(self, name: str = "pcst", log_dir: str | None = None,
                 experiment_name: str | None = None, file_output: bool = True):
        self._logger = get_logger(name, log_dir, experiment_name, file_output)

    def __getattr__(self, item):
        return getattr(self._logger, item)
