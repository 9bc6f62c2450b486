"""Logging helpers (port of gigapose_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    """Module logger propagating to a once-configured root stderr handler."""
    global _CONFIGURED
    if not _CONFIGURED:
        root = logging.getLogger()
        if not root.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
            )
            root.addHandler(h)
            root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(name)


def disable_output(log_path: str):
    """Redirect stdout / stderr to a file via os.dup2 (the CLI's
    disable_output=true, for quiet batch runs). Returns the open file, which
    must stay open while the redirection is in use."""
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    f = open(log_path, "a")
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(f.fileno(), sys.stdout.fileno())
    os.dup2(f.fileno(), sys.stderr.fileno())
    return f
