"""Logging (``deltakd_tpu/obs/logger.py``): a timestamped file on the main
process plus stdout (reference logs/logger.py:10-24, 170-173)."""

from __future__ import annotations

import datetime
import logging
import os
import sys


def get_timestamped_log_file_path(log_file_path: str) -> str:
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    return f"{log_file_path}_{timestamp}"


def setup_logger(log_file: str, *, is_main: bool = True) -> logging.Logger:
    logger = logging.getLogger("deltakd_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    if is_main:
        formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger
