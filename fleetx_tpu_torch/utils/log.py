"""Colored logger with custom TRAIN/EVAL levels (copy of
``fleetx_tpu/utils/log.py``; the logger is named ``fleetx_tpu_torch``;
``set_rank_context`` prefixes a gang member's records with its rank)."""

from __future__ import annotations

import logging
import os
import sys

TRAIN = 21
EVAL = 22
logging.addLevelName(TRAIN, "TRAIN")
logging.addLevelName(EVAL, "EVAL")

_COLORS = {
    "DEBUG": "\033[37m",
    "INFO": "\033[36m",
    "TRAIN": "\033[32m",
    "EVAL": "\033[33m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"

_rank_prefix = ""


def set_rank_context(rank: int, world: int) -> None:
    """Prefix every record with ``[r<rank>/<world>]`` when ``world > 1``
    (``utils/env.py:init_dist_env`` calls it); ``world <= 1`` clears it."""
    global _rank_prefix
    _rank_prefix = f"[r{int(rank)}/{int(world)}] " if int(world) > 1 else ""


class _ColorFormatter(logging.Formatter):
    """Colorize per the HANDLER's stream, not ``sys.stderr`` globally."""

    def __init__(self, fmt=None, datefmt=None, stream=None):
        super().__init__(fmt, datefmt)
        self._stream = stream

    def _colorize(self) -> bool:
        stream = self._stream if self._stream is not None else sys.stderr
        if isinstance(stream, logging.StreamHandler):
            stream = stream.stream
        isatty = getattr(stream, "isatty", None)
        try:
            return bool(isatty and isatty())
        except ValueError:  # closed stream
            return False

    def format(self, record: logging.LogRecord) -> str:
        """Inject the level color codes."""
        msg = _rank_prefix + super().format(record)
        if self._colorize():
            color = _COLORS.get(record.levelname, "")
            return f"{color}{msg}{_RESET}"
        return msg


class _Logger(logging.Logger):
    def train(self, msg, *args, **kwargs):
        if self.isEnabledFor(TRAIN):
            self._log(TRAIN, msg, args, **kwargs)

    def eval(self, msg, *args, **kwargs):
        if self.isEnabledFor(EVAL):
            self._log(EVAL, msg, args, **kwargs)


logging.setLoggerClass(_Logger)
logger: _Logger = logging.getLogger("fleetx_tpu_torch")  # type: ignore[assignment]
logging.setLoggerClass(logging.Logger)


def _initial_level() -> int:
    """``FLEETX_LOG_LEVEL`` env override, honoured at import time."""
    raw = os.environ.get("FLEETX_LOG_LEVEL", "").strip()
    if not raw:
        return logging.INFO
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    if isinstance(level, int):
        return level
    print(f"fleetx_tpu_torch: unknown FLEETX_LOG_LEVEL={raw!r}, using INFO",
          file=sys.stderr)
    return logging.INFO


if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(_ColorFormatter(
        "[%(asctime)s] [%(levelname)8s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", stream=_handler))
    logger.addHandler(_handler)
    logger.setLevel(_initial_level())
    logger.propagate = False
