"""stderr logging, mirroring the reference's mylogger facility
(ccsmeth/utils/logging.py:26-42)."""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def mylogger(name: str = "ccsmeth_tpu", log_file: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(handler)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
        logger.propagate = False
    return logger
