"""Backbone factory (counterpart of ``scan_tpu/modeling/backbone/build.py``).

Ported: ``VGG-16-FPN-RETINANET`` (the SCAN configs' body), the
``R-50-FPN-RETINANET`` / ``R-101-FPN-RETINANET`` bodies of the EPM R-101
configs (``build.py:89-110``: C3-C5 into an FPN of
``RESNETS.BACKBONE_OUT_CHANNELS`` with the ``p6p7`` top block), and the
two-stage detector's ``R-50-FPN`` / ``R-101-FPN`` (``build.py:115-135``:
C2-C5 into that FPN with the ``maxpool`` top block, P2..P6). ``scan_tpu``
builds the last two with its ResNet's default widths and reads neither
``RESNETS.RES2_OUT_CHANNELS`` nor ``STEM_OUT_CHANNELS``; the port reads
them, as for the ``-RETINANET`` bodies, which changes nothing at their
defaults (256, 64) and lets the tests run narrow (ROADMAP queue C). Other
bodies raise. ``TPU.VGG_WIDTH_DIV``, ``TPU.VGG_STAGE_BLOCKS``,
``TPU.FPN_IN_FEATURES`` and ``TPU.FPN_TOP_BLOCK`` shrink the network
through the same code, as in ``scan_tpu``, so tests can run small.
``quant`` builds the int8 variant (``TPU.INT8_INFERENCE``) and reads the
``TPU.*`` stem switches (``scan_tpu/modeling/backbone/build.py:21-86``).
``scan_tpu`` turns its s2d stem off on the CPU backend; the port's stem is
the same on every device, and its switches select the same arithmetic
(see ``vgg.py``). Under ``TPU.INT8_INFERENCE`` a ResNet body stays fp and
only its FPN runs int8: ``scan_tpu`` passes ``quant`` only to a body that has
that field (``build.py:29-31``), and its ``ResNet`` has none.
"""

from torch import nn

from .fpn import FPN
from .resnet import ResNet
from .vgg import VGG16, VGG16_STAGE_BLOCKS


class BackboneWithFPN(nn.Module):
    """(B, H, W, 3) NHWC -> tuple of NHWC pyramid levels (P3..P7)."""

    def __init__(self, body, fpn):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, x):
        return self.fpn(self.body(x))


def build_vgg_fpn_backbone(cfg, quant=False):
    tpu = cfg.TPU
    if quant and tpu.get("PALLAS_STEM", False):
        raise NotImplementedError(
            "TPU.PALLAS_STEM (the fp stem kernel inside the int8 forward) is "
            "not ported; the fp forward runs that kernel without the switch")
    body = VGG16(
        width_div=int(tpu.VGG_WIDTH_DIV),
        stage_blocks=tuple(tpu.get("VGG_STAGE_BLOCKS") or VGG16_STAGE_BLOCKS),
        quant=quant,
        stem_s8_epilogue=bool(tpu.get("STEM_S8_EPILOGUE", True)),
        stem_pair_conv=bool(tpu.get("STEM_PAIR_CONV", True)),
        pallas_conv0=bool(tpu.get("PALLAS_CONV0", False)),
        pallas_phase_max=bool(tpu.get("PALLAS_PHASE_MAX", False)),
        pallas_stem_int8=bool(tpu.get("PALLAS_STEM_INT8", False)),
    )
    top = cfg.TPU.get("FPN_TOP_BLOCK", "p6p7")
    if top not in ("p6p7", "maxpool", "none"):
        raise NotImplementedError(f"FPN_TOP_BLOCK {top!r} is not ported yet")
    fpn = FPN(
        in_channels=body.channels,
        in_features=tuple(cfg.TPU.get("FPN_IN_FEATURES") or (2, 3, 4)),
        out_channels=256,
        top_block=None if top == "none" else top,
        use_gn=cfg.MODEL.FPN.USE_GN,
        use_relu=cfg.MODEL.FPN.USE_RELU,
        use_c5_for_p6=cfg.MODEL.RETINANET.USE_C5,
        quant=quant,
    )
    return BackboneWithFPN(body, fpn)


def build_resnet_fpn_backbone(cfg, quant=False, two_stage=False):
    """C3-C5 and P6/P7 for the one-stage heads; with ``two_stage`` C2-C5
    and the ``maxpool`` level (P2..P6), ``scan_tpu``'s R-50/101-FPN."""
    res = cfg.MODEL.RESNETS
    body = ResNet(
        depth=101 if "101" in cfg.MODEL.BACKBONE.CONV_BODY else 50,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        stride_in_1x1=res.STRIDE_IN_1X1,
        res2_out_channels=res.RES2_OUT_CHANNELS,
        stem_out_channels=res.STEM_OUT_CHANNELS,
    )
    fpn = FPN(
        in_channels=body.channels,
        in_features=(0, 1, 2, 3) if two_stage else (1, 2, 3),
        out_channels=res.BACKBONE_OUT_CHANNELS,
        top_block="maxpool" if two_stage else "p6p7",
        use_gn=cfg.MODEL.FPN.USE_GN,
        use_relu=cfg.MODEL.FPN.USE_RELU,
        use_c5_for_p6=cfg.MODEL.RETINANET.USE_C5,
        quant=quant,
    )
    return BackboneWithFPN(body, fpn)


def build_backbone(cfg, quant=False):
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body in ("R-50-FPN-RETINANET", "R-101-FPN-RETINANET"):
        return build_resnet_fpn_backbone(cfg, quant)
    if body in ("R-50-FPN", "R-101-FPN"):
        return build_resnet_fpn_backbone(cfg, quant, two_stage=True)
    if body != "VGG-16-FPN-RETINANET":
        raise KeyError(f"backbone {body!r} is not ported to scan_tpu_torch yet")
    if cfg.MODEL.BACKBONE.VGG_W_BN:
        raise NotImplementedError("VGG with BN is not ported yet")
    return build_vgg_fpn_backbone(cfg, quant)
