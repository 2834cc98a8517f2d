"""Logging setup — dual console + file handlers.

The port's own copy of :mod:`ieache_tpu.utils.log`.

Counterpart of the reference's logging config (console +
``dragonfly.log``, uniform format, duplicated per node at
``Client1/dragonfly_private_client.py:65-79``), provided once.
"""

from __future__ import annotations

import logging
import sys

FORMAT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"


def setup(name: str = "ieache", logfile: str | None = "dragonfly.log",
          level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(FORMAT)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
