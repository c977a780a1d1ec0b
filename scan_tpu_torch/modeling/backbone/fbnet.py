"""FBNet bodies over NHWC tensors (counterpart of
``scan_tpu/modeling/backbone/fbnet.py``; reference
``fcos_core/modeling/backbone/fbnet.py``, ``fbnet_builder.py`` and
``fbnet_modeldef.py``).

An arch is a stem ``(c, s)`` and stages of ``(op, t, c, n, s)`` groups of
inverted-residual (IRF) blocks, whose op picks the depthwise kernel
(``ir_k3``, ``ir_k5``, ``ir_k7``); the trunk returns the last block of
each stage listed in ``endpoints`` (C2..C5). ``FBNET_ARCHS`` is the port's
own copy of ``scan_tpu``'s five tables (plain data). ``SCALE_FACTOR`` and
``WIDTH_DIVISOR`` scale every width as ``scaled`` does in ``scan_tpu``: the
width times the factor, truncated, then rounded to the nearest multiple of
the divisor, and at least the divisor; the expansions are not scaled.

The block is MobileNetV2's (``mobilenet.InvertedResidual``) under FBNet's
names (``pw``, ``dw``, ``pwl`` and their ``_bn``) with the op's kernel, and
the stem, its norm frozen as ``scan_tpu``'s solver freezes it, and the bf16
arithmetic are MobileNetV2's (see ``mobilenet.py``).
"""

from torch import nn

from ..layers import ChannelNorm, clip
from .mobilenet import InvertedResidual, mobile_conv

# arch tables: stem (c, s), stages: lists of (op, t, c, n, s) groups
FBNET_ARCHS = {
    "default": {
        "first": (32, 2),
        "stages": [
            [("ir_k3", 1, 16, 1, 1)],
            [("ir_k3", 6, 24, 2, 2)],
            [("ir_k3", 6, 32, 3, 2)],
            [("ir_k3", 6, 64, 4, 2), ("ir_k3", 6, 96, 3, 1)],
            [("ir_k3", 4, 160, 1, 2), ("ir_k3", 6, 160, 2, 1),
             ("ir_k3", 6, 240, 1, 1)],
        ],
        "endpoints": (1, 2, 3, 4),
    },
    "mnv2": {
        "first": (32, 2),
        "stages": [
            [("ir_k3", 1, 16, 1, 1)],
            [("ir_k3", 6, 24, 2, 2)],
            [("ir_k3", 6, 32, 3, 2)],
            [("ir_k3", 6, 64, 4, 2), ("ir_k3", 6, 96, 3, 1)],
            [("ir_k3", 6, 160, 3, 2), ("ir_k3", 6, 320, 1, 1)],
        ],
        "endpoints": (1, 2, 3, 4),
    },
    "xirb16d_dsmask": {
        "first": (16, 2),
        "stages": [
            [("ir_k3", 1, 16, 1, 1)],
            [("ir_k3", 6, 32, 2, 2)],
            [("ir_k3", 6, 48, 3, 2)],
            [("ir_k3", 6, 96, 4, 2), ("ir_k3", 6, 128, 3, 1)],
            [("ir_k3", 4, 128, 1, 2), ("ir_k3", 6, 128, 2, 1),
             ("ir_k3", 6, 160, 1, 1)],
        ],
        "endpoints": (1, 2, 3, 4),
    },
    "cham_v1a": {
        "first": (32, 2),
        "stages": [
            [("ir_k3", 1, 24, 1, 1)],
            [("ir_k7", 4, 48, 2, 2)],
            [("ir_k3", 7, 64, 5, 2)],
            [("ir_k5", 12, 56, 7, 2), ("ir_k3", 8, 88, 5, 1)],
            [("ir_k3", 7, 152, 4, 2), ("ir_k3", 10, 104, 1, 1)],
        ],
        "endpoints": (1, 2, 3, 4),
    },
    "cham_v2": {
        "first": (32, 2),
        "stages": [
            [("ir_k3", 1, 24, 1, 1)],
            [("ir_k5", 8, 32, 4, 2)],
            [("ir_k7", 5, 48, 6, 2)],
            [("ir_k5", 9, 56, 3, 2), ("ir_k3", 6, 56, 6, 1)],
            [("ir_k3", 2, 160, 6, 2), ("ir_k3", 6, 112, 1, 1)],
        ],
        "endpoints": (1, 2, 3, 4),
    },
}


class IRFBlock(InvertedResidual):
    """The FBNet inverted-residual block (reference fbnet_builder.py:37-170)."""

    CONVS = ("pw", "dw", "pwl")
    NORMS = ("pw_bn", "dw_bn", "pwl_bn")


def op_kernel(op: str) -> int:
    if op.startswith("ir_k7"):
        return 7
    return 5 if op.startswith("ir_k5") else 3


class FBNetTrunk(nn.Module):
    def __init__(self, arch="default", scale_factor=1.0, width_divisor=1):
        super().__init__()
        self.spec = FBNET_ARCHS[arch]
        self.scale_factor = scale_factor
        self.width_divisor = width_divisor
        c0, s0 = self.spec["first"]
        self.stem = mobile_conv(3, self.scaled(c0), 3, stride=s0)
        self.stem_bn = ChannelNorm(self.scaled(c0))
        self.stem_bn.requires_grad_(False)  # scan_tpu's solver freezes it
        self.blocks = []
        cin, channels = self.scaled(c0), []
        for si, stage in enumerate(self.spec["stages"]):
            for gi, (op, t, c, n, s) in enumerate(stage):
                for bi in range(n):
                    name = f"stage{si}_g{gi}_b{bi}"
                    self.add_module(name, IRFBlock(
                        cin, t, self.scaled(c), s if bi == 0 else 1,
                        kernel=op_kernel(op)))
                    self.blocks.append((si, name))
                    cin = self.scaled(c)
            if si in self.spec["endpoints"]:
                channels.append(cin)
        self.channels = tuple(channels)  # C2..C5

    def scaled(self, c):
        c = int(c * self.scale_factor)
        d = self.width_divisor
        return max(d, (c + d // 2) // d * d)

    def forward(self, x):
        """x (B, H, W, 3) NHWC float32 -> tuple of C2..C5, NHWC float32."""
        y = clip(self.stem_bn(self.stem(x)), 6)
        outs = []
        for si in range(len(self.spec["stages"])):
            for _, name in (b for b in self.blocks if b[0] == si):
                y = getattr(self, name)(y)
            if si in self.spec["endpoints"]:
                outs.append(y)
        return tuple(outs)
