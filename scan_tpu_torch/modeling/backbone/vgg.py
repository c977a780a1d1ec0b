"""VGG-16 backbone over NHWC tensors (counterpart of ``scan_tpu/modeling/backbone/vgg.py``).

Stages of (2, 2, 3, 3, 3) 3x3 convs with ReLU and a 2x2 max-pool after each
(reference ``fcos_core/modeling/backbone/mmdetection/vgg.py``, no BN in the
SCAN configs). Returns the post-pool feature of every stage, C1..C5.

Stage 1 (conv1_1, ReLU, conv1_2, ReLU, pool) goes through
``ops/cuda/stem_kernel.py::fused_stem``: kernel K2 on the card, the plain
conv/relu/conv/relu/pool on the CPU. ``scan_tpu``'s space-to-depth phase
packing (``_phase_packed_weight``) is a TPU layout device and is not ported.
Convs are named ``conv0..conv12`` as in ``scan_tpu``, so weights carry over.
"""

import torch.nn.functional as F
from torch import nn

from ...ops.cuda.stem_kernel import STEM_IN, fused_stem
from ..layers import Conv, to_nchw, to_nhwc

VGG16_STAGE_BLOCKS = (2, 2, 3, 3, 3)
VGG16_STAGE_CHANNELS = (64, 128, 256, 512, 512)


class VGG16(nn.Module):
    def __init__(self, width_div: int = 1, stage_blocks=VGG16_STAGE_BLOCKS):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.channels = tuple(max(8, c // width_div) for c in VGG16_STAGE_CHANNELS)
        idx, cin = 0, STEM_IN
        for blocks, ch in zip(self.stage_blocks, self.channels):
            for _ in range(blocks):
                self.add_module(f"conv{idx}",
                                Conv(cin, ch, 3, kernel_init="vgg"))
                cin = ch
                idx += 1

    def forward(self, x):
        """x (B, H, W, 3) NHWC float32 -> tuple of C1..C5, NHWC, in the
        dtype of the conv weights."""
        outs = []
        idx = 0
        for stage, blocks in enumerate(self.stage_blocks):
            if stage == 0 and blocks == 2:
                c0, c1 = self.conv0, self.conv1
                x = fused_stem(x, c0.weight, c0.bias, c1.weight, c1.bias,
                               out_dtype=c0.weight.dtype)
                idx += 2
            else:
                x = x.to(getattr(self, f"conv{idx}").weight.dtype)
                for _ in range(blocks):
                    x = F.relu(getattr(self, f"conv{idx}")(x))
                    idx += 1
                x = to_nhwc(F.max_pool2d(to_nchw(x), 2, 2))
            outs.append(x)
        return tuple(outs)

