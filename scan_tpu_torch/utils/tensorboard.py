"""TensorBoard scalar logging (counterpart of
``scan_tpu/utils/tensorboard.py``).

Parity target: reference ``fcos_core/utils/metric_logger.py:71-106``
(``TensorboardLogger`` via tensorboardX, enabled by --use_tensorboard).
Writes through ``torch.utils.tensorboard.SummaryWriter`` where the
``tensorboard`` package imports; otherwise it logs one warning and does
nothing, as ``scan_tpu`` does without TensorFlow.
"""

import logging

logger = logging.getLogger("scan_tpu_torch.tb")


class TensorboardLogger:
    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
            logger.info("tensorboard logs -> %s", log_dir)
        except ImportError as e:
            logger.warning("tensorboard unavailable: %s", e)

    def log_scalars(self, scalars: dict, step: int):
        """Same scalar set as the reference's TensorboardLogger.update
        (metric_logger.py:93-106: every loss term each window)."""
        if self._writer is None:
            return
        for k, v in scalars.items():
            self._writer.add_scalar(k, float(v), global_step=step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
