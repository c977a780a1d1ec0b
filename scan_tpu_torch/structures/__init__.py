from .boxes import Boxes, box_area, box_iou, decode_boxes, encode_boxes
from .image_batch import ImageBatch, batch_images

__all__ = [
    "Boxes",
    "box_area",
    "box_iou",
    "encode_boxes",
    "decode_boxes",
    "ImageBatch",
    "batch_images",
]
