"""Logging setup (copy of tpuvdb.utils.logging under the port's logger name).

Level via TPUVDB_LOG_LEVEL, optional file via TPUVDB_LOG_FILE. Hot paths
log at DEBUG.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s - %(message)s"
_configured = False


def get_logger(name: str = "tpuvdb_torch") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("TPUVDB_LOG_LEVEL", "INFO").upper()
        root = logging.getLogger("tpuvdb_torch")
        root.setLevel(level)
        if not root.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(h)
            log_file = os.environ.get("TPUVDB_LOG_FILE")
            if log_file:
                fh = logging.FileHandler(log_file)
                fh.setFormatter(logging.Formatter(_FORMAT))
                root.addHandler(fh)
        _configured = True
    return logging.getLogger(name)
