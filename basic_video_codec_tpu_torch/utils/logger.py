"""Logging setup: ``HH:MM:SS.mmm LEVEL [file.py:line] message``."""

import logging

_CONFIGURED = False


def get_logger(level: int = logging.INFO) -> logging.Logger:
    """Root logger with a timestamp + file:line format."""
    global _CONFIGURED
    if not _CONFIGURED:
        logging.basicConfig(
            format="%(asctime)s.%(msecs)03d %(levelname)-7s "
            "[%(filename)s:%(lineno)-3d] %(message)s",
            datefmt="%H:%M:%S",
        )
        _CONFIGURED = True
    logger = logging.getLogger()
    logger.setLevel(level)
    return logger
