"""Script logging setup: console INFO + fresh-per-run DEBUG file.

The port's own copy of ``mermaid_classifier_tpu/utils/logging_config.py``
(stdlib only): scripts get human-readable INFO on the console and a full
DEBUG trace in a fresh file per run, so a failed run's forensics never
depend on console scrollback.
"""

from __future__ import annotations

import logging.config
from datetime import datetime
from pathlib import Path


def logging_config_for_script(
    script_name: str,
    *,
    log_dir: str | Path = "logs",
    console_level: str = "INFO",
) -> Path:
    """Configure root logging; returns the debug-file path."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    debug_file = log_dir / f"{script_name}_{stamp}.debug.log"
    logging.config.dictConfig(
        {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": {
                "console": {"format": "%(levelname)s %(name)s %(message)s"},
                "file": {
                    "format": (
                        "%(asctime)s %(levelname)s %(name)s"
                        " %(filename)s:%(lineno)d %(message)s"
                    )
                },
            },
            "handlers": {
                "console": {
                    "class": "logging.StreamHandler",
                    "level": console_level,
                    "formatter": "console",
                },
                "debug_file": {
                    "class": "logging.FileHandler",
                    "level": "DEBUG",
                    "formatter": "file",
                    "filename": str(debug_file),
                    "mode": "w",
                },
            },
            "root": {"level": "DEBUG", "handlers": ["console", "debug_file"]},
        }
    )
    return debug_file
