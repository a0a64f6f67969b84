"""Shared logging bootstrap (console + truncating rotating file handler).

The port's own copy of ``crimp_tpu/utils/logging.py``. Behavioral parity
with CRIMP's logging_utils: every CLI tool writes a
``<output>.log`` file that is truncated per run and records the full input
parameters, while console verbosity is controlled by -v/-vv.
"""

from __future__ import annotations

import logging
from logging.handlers import RotatingFileHandler

_FORMAT = "[%(asctime)s] %(levelname)8s %(message)s (%(name)s:%(lineno)s)"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def configure_logging(
    *,
    console_level: str = "WARNING",
    file_path: str | None = None,
    file_level: str = "INFO",
    file_max_bytes: int = 10_000_000,
    file_backup_count: int = 3,
    force: bool = False,
) -> None:
    """Configure the root logger with a console handler and, optionally, a
    truncate-on-run rotating file handler."""
    root = logging.getLogger()
    if force:
        for handler in list(root.handlers):
            root.removeHandler(handler)
    # Root sits at the lowest level any of our handlers wants — NOT at DEBUG:
    # third-party libraries attach their own stderr handlers that
    # inherit the root's effective level, so an unconditional DEBUG root
    # floods the console with their internals.
    console_lvl = getattr(logging, console_level.upper(), logging.WARNING)
    file_lvl = getattr(logging, file_level.upper(), logging.INFO)
    root.setLevel(min(console_lvl, file_lvl) if file_path else console_lvl)

    console = logging.StreamHandler()
    console.setLevel(console_lvl)
    console.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    root.addHandler(console)

    if file_path:
        # Truncate any pre-existing log from an earlier run.
        open(file_path, "w").close()
        file_handler = RotatingFileHandler(
            file_path, mode="w", maxBytes=file_max_bytes, backupCount=file_backup_count
        )
        file_handler.setLevel(file_lvl)
        file_handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        root.addHandler(file_handler)


def get_logger(name: str) -> logging.Logger:
    """Module logger with a NullHandler so imports never configure logging."""
    logger = logging.getLogger(name)
    if not logger.handlers and not logger.propagate:
        logger.addHandler(logging.NullHandler())
    return logger


def verbosity_to_level(verbose_count: int) -> str:
    """Map argparse -v count to a console level (WARNING/INFO/DEBUG)."""
    return ("WARNING", "INFO", "DEBUG")[min(verbose_count, 2)]
