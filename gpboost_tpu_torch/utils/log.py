"""Central redirectable logger (reference ``register_logger``,
``python-package/gpboost/basic.py:39``): all library messages flow through
one registered logger object so applications can silence or redirect them.
"""
from __future__ import annotations

import warnings
from logging import Logger


class _DummyLogger:
    def info(self, msg):
        print(msg)

    def warning(self, msg):
        warnings.warn(msg, stacklevel=3)


_LOGGER = _DummyLogger()


def register_logger(logger) -> None:
    """Register a custom ``logging.Logger`` for all library output."""
    if not isinstance(logger, Logger):
        raise TypeError("Logger should inherit logging.Logger class")
    global _LOGGER
    _LOGGER = logger


def log_info(msg: str) -> None:
    _LOGGER.info(msg)


def log_warning(msg: str) -> None:
    _LOGGER.warning(msg)
