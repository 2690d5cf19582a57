"""Colored stdout logger (counterpart of ``paddlefleetx_tpu/utils/log.py``)."""

from __future__ import annotations

import logging
import sys
import time

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelname, "")
        prefix = (
            f"{color}[{time.strftime('%Y-%m-%d %H:%M:%S')}] "
            f"[{record.levelname:>7s}]{_RESET}"
        )
        return f"{prefix} {record.getMessage()}"


def get_logger(name: str = "paddlefleetx_tpu_torch") -> logging.Logger:
    """The package logger: INFO level, one stdout handler, no propagation.
    ``logging.getLogger`` returns the same object on every call, so the
    handler is attached once."""
    lg = logging.getLogger(name)
    if not lg.handlers:
        lg.setLevel(logging.INFO)
        lg.propagate = False
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(_ColorFormatter())
        lg.addHandler(h)
    return lg


logger = get_logger()


def log_server_error(surface: str, code: int, path: str, **fields) -> None:
    """One ``key=value`` line for every 5xx a serving surface writes;
    None/empty fields are dropped and values with spaces are quoted."""
    parts = [f"surface={surface}", f"code={code}", f"path={path}"]
    for key in sorted(fields):
        val = fields[key]
        if val is None or val == "":
            continue
        sval = str(val)
        if " " in sval:
            sval = '"' + sval.replace('"', "'") + '"'
        parts.append(f"{key}={sval}")
    logger.error("http_5xx " + " ".join(parts))
