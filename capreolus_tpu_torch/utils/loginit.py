"""Logging setup with repeat suppression (a copy of the JAX package's
``utils/loginit.py`` under the port's own root logger): a console handler, a
RepeatFilter suppressing more than MAX_REPEATS identical consecutive messages,
and the level from the CAPREOLUS_LOGGING environment variable.
"""

from __future__ import annotations

import logging
import os

MAX_REPEATS = 5
_CONFIGURED = False


class RepeatFilter(logging.Filter):
    """Suppress identical consecutive log messages after MAX_REPEATS occurrences."""

    def __init__(self):
        super().__init__()
        self._last = None
        self._count = 0

    def filter(self, record: logging.LogRecord) -> bool:
        current = (record.module, record.levelno, record.getMessage())
        if current == self._last:
            self._count += 1
        else:
            self._last = current
            self._count = 1
        if self._count == MAX_REPEATS:
            record.msg = f"{record.msg} (suppressing further repeats)"
            return True
        return self._count < MAX_REPEATS


def _level_from_env() -> int:
    name = os.environ.get("CAPREOLUS_LOGGING", "INFO").upper()
    return getattr(logging, name, logging.INFO)


def _configure_root():
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger("capreolus_tpu_torch")
    root.setLevel(_level_from_env())
    handler = logging.StreamHandler()
    fmt = "%(asctime)s - %(levelname)s - %(name)s.%(funcName)s - %(message)s"
    try:
        import colorlog

        handler = colorlog.StreamHandler()
        handler.setFormatter(colorlog.ColoredFormatter("%(log_color)s" + fmt))
    except ImportError:
        handler.setFormatter(logging.Formatter(fmt))
    handler.addFilter(RepeatFilter())
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("capreolus_tpu_torch"):
        name = f"capreolus_tpu_torch.{name}"
    return logging.getLogger(name)

