"""Logging setup (counterpart of ``scan_tpu/utils/logger.py``; reference
``fcos_core/utils/logger.py``)."""

import logging
import os
import sys


def setup_logger(name: str = "scan_tpu_torch", save_dir: str = "",
                 filename: str = "log.txt", distributed_rank: int = 0):
    """The logger ``name``, writing to stdout and to ``save_dir/filename``.
    Each call replaces the handlers that an earlier call added, so every
    run in a process logs into its own output directory. A rank other
    than 0 of a process group gets no handler (reference logger.py:7-10):
    only rank 0 logs."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in [h for h in logger.handlers if getattr(h, "run_handler", False)]:
        logger.removeHandler(h)
        h.close()
    if distributed_rank > 0:
        return logger
    handlers = [logging.StreamHandler(stream=sys.stdout)]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(save_dir, filename)))
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    for h in handlers:
        h.run_handler = True
        h.setLevel(logging.DEBUG)
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger
