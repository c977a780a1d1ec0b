from .dynamic_conv import dynamic_conv
from .focal_loss import (
    bce_focal_loss,
    binary_adversarial_focal_loss,
    sigmoid_focal_loss,
    softmax_focal_loss,
)
from .iou_loss import iou_loss
from .locations import (compute_locations, compute_locations_level,
                        level_sizes_from_image)
from . import nms  # the module, which runs nms.nms when called
from .nms import ml_nms, nms_keep_mask

__all__ = [
    "sigmoid_focal_loss",
    "softmax_focal_loss",
    "bce_focal_loss",
    "binary_adversarial_focal_loss",
    "iou_loss",
    "compute_locations",
    "compute_locations_level",
    "level_sizes_from_image",
    "nms",
    "ml_nms",
    "nms_keep_mask",
    "dynamic_conv",
]
