"""Logger setup: named logger with per-scenario file handler + stdout.

Equivalent of the reference's initialize_logger
(reference: commonroad_rp/utility/logger.py:8-46).
"""

from __future__ import annotations

import logging
import os
from datetime import datetime


def initialize_logger(config) -> logging.Logger:
    """Configure the RP_LOGGER used across the planner modules."""
    logger = logging.getLogger("RP_LOGGER")
    logger.handlers.clear()
    level = getattr(logging, str(config.debug.logging_level).upper(), logging.INFO)
    logger.setLevel(level)

    if config.debug.save_config or config.debug.save_plots:
        os.makedirs(config.general.path_logs, exist_ok=True)
        stamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        name = config.general.name_scenario or "scenario"
        file_handler = logging.FileHandler(
            os.path.join(config.general.path_logs, f"{name}_{stamp}.log"))
        file_handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-8s %(name)s: %(message)s"))
        file_handler.setLevel(level)
        logger.addHandler(file_handler)

    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter("%(levelname)-8s %(message)s"))
    stream.setLevel(level)
    logger.addHandler(stream)
    logger.propagate = False
    return logger
