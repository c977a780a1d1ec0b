"""The SCAN detector's eval forward (counterpart of ``scan_tpu/modeling/detector.py``).

``scan_tpu`` keeps parameters in a dict of pytrees applied by a stateless
``SCANDetector``; here the detector is an ``nn.Module`` that owns its
submodules (``backbone``, ``middle_head``, ``fcos``, the names of
``scan_tpu``'s parameter dict) and the prototype state as buffers.

Ported: construction with the per-level discriminators of a DA config
(``detector.py:113-175``: GA, center-aware CA, output-space OUT and CKA),
the seeded init, ``_prep_images``, the training forward ``forward_train``
and ``discriminator_losses`` (``detector.py:262-358``), and
``forward_inference`` for the FCOS head with condgraph in all three
TEST.MODEs, in fp32/bf16 or, with ``TPU.INT8_INFERENCE``, as w8a8 int8
(``detector.py:82-98, 361-464``) with ``calibrate_int8`` for static
activation scales. ``scan_tpu`` keeps int8 variants of the backbone and
heads beside the fp ones over one parameter tree; here an int8 detector's
backbone, middle head and head are the int8 variants themselves, over the
same float32 parameters, and it does not train. Discriminator modules are
attributes named as ``scan_tpu``'s top-level keys (``dis_P3``,
``dis_P3_CA``, ``dis_P3_OUT``, ``dis_P3_CON``, ...). Under ``MODEL.ATSS_ON``
the head is ATSS's (``modeling/atss/atss.py``), chosen before FCOS as
``scan_tpu`` chooses it (``detector.py:58-67``), under the same name
``fcos``: its classes and postprocess settings come from ``MODEL.ATSS``,
its losses from its anchors (on the ``MODEL.FCOS.FPN_STRIDES`` grid, as in
``scan_tpu``), and it has no ``TEST.MODE`` mixing; the GA, CA and OUT
discriminators read its score maps as they read FCOS's.

In bfloat16 (``TPU.COMPUTE_DTYPE``) the convolutions and GroupNorms compute
in bf16, as ``scan_tpu``'s flax ``dtype=`` makes them (``layers.py``). A
detector built for training keeps every parameter in float32, the masters
that SGD updates; a detector built for evaluation only holds its conv and
GroupNorm parameters in bf16 (``set_compute_dtype``).
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.locations import compute_locations
from ..utils.profiler import span
from .anchors import atss_level_sizes, grid_anchors
from .atss.atss import ATSSConfig, ATSSHead, atss_losses, atss_postprocess
from .backbone.build import build_backbone
from .backbone.vgg import VGG16
from .condgraph.module import CondGraph, CondGraphConfig
from .condgraph.prototype import ProtoState, init_proto_state
from .discriminator.discriminators import (FCOSDiscriminator,
                                           FCOSDiscriminatorCA,
                                           FCOSDiscriminatorCon,
                                           FCOSDiscriminatorOut)
from .fcos.head import FCOSHead
from .fcos.loss import fcos_losses
from .fcos.module import mix_cls_maps
from .fcos.postprocess import PostProcessConfig, fcos_postprocess
from .layers import (NO_SCALE, Conv, GroupNorm32, calibration,
                     init_parameters, read_scales)

LAYERS = ("P3", "P4", "P5", "P6", "P7")


class SCANDetector(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.int8_inference = bool(cfg.TPU.get("INT8_INFERENCE", False))
        quant = self.int8_inference
        self.cfg = cfg
        self.compute_dtype = (
            torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
            else torch.float32
        )
        self.strides = tuple(cfg.MODEL.FCOS.FPN_STRIDES)
        self.num_classes = cfg.MODEL.FCOS.NUM_CLASSES
        self.backbone = build_backbone(cfg, quant)
        # the FPN's width (RESNETS.BACKBONE_OUT_CHANNELS for a ResNet body),
        # the input of the head's and the GA/CA discriminators' first convs
        # (flax infers it; their towers are 256 wide whatever it is)
        self.channels = self.backbone.fpn.out_channels
        self.condgraph_on = cfg.MODEL.MIDDLE_HEAD.CONDGRAPH_ON
        if self.condgraph_on:
            self.cg_cfg = CondGraphConfig.from_cfg(cfg)
            self.middle_head = CondGraph(self.cg_cfg, quant)
            shape = (self.cg_cfg.used_classes, self.cg_cfg.proto_channel)
            if self.cg_cfg.proto_iter > 1:
                shape += (self.cg_cfg.proto_iter,)
            self.register_buffer("prototype", torch.zeros(shape))
            self.register_buffer("proto_counter",
                                 torch.tensor(-1, dtype=torch.int32))
        # ATSS_ON > FCOS_ON, as the reference's build_rpn (rpn.py:201-206)
        self.atss_on = cfg.MODEL.ATSS_ON
        if self.atss_on:
            self.atss_cfg = ATSSConfig.from_cfg(cfg)
            self.num_classes = self.atss_cfg.num_classes
            self.fcos = ATSSHead(self.atss_cfg, num_levels=len(self.strides),
                                 quant=quant, input_channels=self.channels)
        else:
            self.fcos = FCOSHead(
                num_classes=self.num_classes,
                num_convs_cls=cfg.MODEL.FCOS.NUM_CONVS_CLS,
                num_convs_reg=cfg.MODEL.FCOS.NUM_CONVS_REG,
                input_channels=self.channels,
                prior_prob=cfg.MODEL.FCOS.PRIOR_PROB,
                with_reg_ctr=cfg.MODEL.FCOS.REG_CTR_ON,
                num_levels=len(self.strides),
                quant=quant,
            )
        self.test_mode = cfg.TEST.MODE
        head_cfg = cfg.MODEL.ATSS if self.atss_on else cfg.MODEL.FCOS
        self.pp_cfg = PostProcessConfig(
            pre_nms_thresh=head_cfg.INFERENCE_TH,
            pre_nms_top_n=head_cfg.PRE_NMS_TOP_N,
            nms_thresh=head_cfg.NMS_TH,
            fpn_post_nms_top_n=cfg.TEST.DETECTIONS_PER_IMG,
            num_classes=self.num_classes,
            nms_cap=cfg.TPU.get("NMS_CAP", 512),
        )
        self.loss_gamma = cfg.MODEL.FCOS.LOSS_GAMMA
        self.loss_alpha = cfg.MODEL.FCOS.LOSS_ALPHA
        # on the module's device, so normalising copies nothing from the host
        self.register_buffer("pixel_mean", torch.tensor(
            cfg.INPUT.PIXEL_MEAN, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(
            cfg.INPUT.PIXEL_STD, dtype=torch.float32), persistent=False)
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self._build_discriminators(cfg)

    def _build_discriminators(self, cfg):
        """The per-level discriminators of a DA config, in ``scan_tpu``'s
        order and under its names (``detector.py:113-171``)."""
        adv = cfg.MODEL.ADV
        self.lambdas = {"GA": adv.GA_DIS_LAMBDA, "CA": adv.CA_DIS_LAMBDA,
                        "OUT": adv.OUT_DIS_LAMBDA, "CON": adv.CON_DIS_LAMBDA}
        self.dis_names = []
        # the target pass runs the FCOS head for the CA and OUT families
        # (detector.py:173-175)
        self.need_score_maps = cfg.MODEL.DA_ON and (
            adv.USE_DIS_CENTER_AWARE or adv.USE_DIS_OUT)
        if not cfg.MODEL.DA_ON:
            return
        for layer in LAYERS:
            grl_w = adv[f"GRL_WEIGHT_{layer}"]
            ca_grl_w = adv[f"CA_GRL_WEIGHT_{layer}"]
            ca_convs = adv[f"CA_DIS_{layer}_NUM_CONVS"]
            use = adv[f"USE_DIS_{layer}"]
            if adv.USE_DIS_GLOBAL and use:
                self._add_dis(f"dis_{layer}", FCOSDiscriminator(
                    num_convs=adv[f"DIS_{layer}_NUM_CONVS"],
                    input_channels=self.channels, grl_lambda=grl_w,
                    grl_applied_domain=adv.GRL_APPLIED_DOMAIN,
                    patch_stride=adv.PATCH_STRIDE))
            if adv.USE_DIS_CENTER_AWARE and use:
                self._add_dis(f"dis_{layer}_CA", FCOSDiscriminatorCA(
                    num_convs=ca_convs, input_channels=self.channels,
                    grl_lambda=ca_grl_w, center_aware_weight=adv.CENTER_AWARE_WEIGHT,
                    center_aware_type=adv.CENTER_AWARE_TYPE,
                    grl_applied_domain=adv.GRL_APPLIED_DOMAIN))
            if adv.USE_DIS_OUT and use:
                self._add_dis(f"dis_{layer}_OUT", FCOSDiscriminatorOut(
                    num_convs=ca_convs, grl_lambda=ca_grl_w,
                    out_weight=adv.OUT_WEIGHT, out_loss=adv.OUT_LOSS,
                    outmap_op=adv.OUTMAP_OP, use_reg=adv.OUTPUT_REG_DA,
                    use_cls=adv.OUTPUT_CLS_DA,
                    use_ctr=adv.OUTPUT_CENTERNESS_DA,
                    num_classes=self.num_classes,
                    base_dis_tower=adv.BASE_DIS_TOWER,
                    grl_applied_domain=adv.GRL_APPLIED_DOMAIN))
            if adv.USE_DIS_CON and adv[f"USE_DIS_{layer}_CON"]:
                self._add_dis(f"dis_{layer}_CON", FCOSDiscriminatorCon(
                    num_convs=adv[f"CON_NUM_SHARED_CONV_{layer}"],
                    num_classes=self.num_classes,
                    fusion_cfg=adv.CON_FUSUIN_CFG, grl_lambda=grl_w,
                    grl_applied_domain=adv.GRL_APPLIED_DOMAIN))

    def _add_dis(self, name, module):
        self.add_module(name, module)
        self.dis_names.append(name)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init_parameters(self, seed: int = 0):
        """Seeded init with ``scan_tpu``'s conventions (see
        ``modeling/layers.py``), drawn on the CPU so a seed gives the same
        weights on every device; prototypes are standard normal."""
        gen = torch.Generator().manual_seed(seed)
        for name in ("backbone", "middle_head", "fcos", *self.dis_names):
            if hasattr(self, name):
                init_parameters(getattr(self, name), gen)
        if self.condgraph_on:
            state = init_proto_state(gen, self.cg_cfg.used_classes,
                                     self.cg_cfg.proto_channel,
                                     self.cg_cfg.proto_iter)
            self.load_proto_state(state)
        return self

    @torch.no_grad()
    def load_proto_state(self, state: ProtoState):
        self.prototype.copy_(state.prototype)
        self.proto_counter.copy_(state.counter)

    def proto_state(self):
        """The prototype state, or None without the condgraph (the EPM
        configs), as ``scan_tpu`` carries it."""
        if not self.condgraph_on:
            return None
        return ProtoState(self.prototype, self.proto_counter)

    def set_compute_dtype(self, cast_params: bool = True):
        """Convolutions, GroupNorms and the VGG stem run in
        TPU.COMPUTE_DTYPE, as flax's ``dtype=`` does; dense layers, Scales,
        FrozenBatchNorms and prototypes stay float32. With ``cast_params``
        the conv and GroupNorm parameters are cast to the compute dtype (a
        detector for evaluation only); without, they stay float32 masters
        and are cast at use (a detector that trains). The int8 modules keep their
        float32 parameters (they quantize the float32 masters) and take the
        compute dtype for their outputs."""
        for m in self.modules():
            if getattr(m, "quant", False):
                m.dtype = self.compute_dtype
            elif isinstance(m, (Conv, GroupNorm32, VGG16)):
                m.compute_dtype = self.compute_dtype
                if cast_params and not isinstance(m, VGG16):
                    m.to(self.compute_dtype)
                if isinstance(m, Conv):
                    m.to(memory_format=torch.channels_last)
        return self

    # ------------------------------------------------------------------ #
    def _head(self, feats, compute_cls=True):
        """(logits, bbox_reg, centerness) of the head; ATSS's computes all
        three always."""
        if self.atss_on:
            return self.fcos(feats)
        return self.fcos(feats, compute_cls)

    def _anchors(self, feats):
        """The ATSS anchors of each level, on the features' device."""
        c = self.atss_cfg
        return grid_anchors(
            [(f.shape[1], f.shape[2]) for f in feats], self.strides,
            atss_level_sizes(c.anchor_sizes, c.octave, c.scales_per_octave),
            c.aspect_ratios, device=feats[0].device)

    def _prep_images(self, images):
        """uint8 RGB NHWC -> (BGR*255 - mean) / std in float32; float inputs
        are taken as already normalised (``detector.py:181-194``)."""
        if images.dtype != torch.uint8:
            return images
        x = images.to(torch.float32)
        if self.to_bgr255:
            x = x.flip(-1)
        else:
            x = x / 255.0
        return ((x - self.pixel_mean) / self.pixel_std).contiguous()

    # ------------------------------------------------------------------ #
    def forward_train(self, proto_state, images, targets, mode: str,
                      forward_target: bool = False, generator=None):
        """One domain's G pass (``detector.py:262-328``; reference
        ``foward_detector``, trainer.py:20-72). ``mode`` is "source" (with
        ``targets``: ``boxes``, ``labels``, ``mask``) or "target"; the
        target pass runs the condgraph's target mode only when
        ``forward_target``. ``generator`` draws the MHA's dropout; without
        one the pass is deterministic. Returns (losses, features, act_maps,
        score_maps, new_proto_state)."""
        with span("prep"):
            images = self._prep_images(images)
        with span("backbone"):
            feats = list(self.backbone(images))
        losses = {}
        act_maps = None
        new_state = proto_state
        if self.condgraph_on:
            mh_mode = mode if (mode == "source" or forward_target) else "inference"
            with span("middle_head"):
                feats, mh_losses, act_maps, new_state = self.middle_head(
                    feats, proto_state, mh_mode,
                    targets if mode == "source" else None, generator=generator)
            losses.update(mh_losses)
        score_maps = None
        if mode == "source" or self.need_score_maps:
            with span("fcos"):
                logits, reg, ctr = self._head(feats)
            score_maps = {"box_cls": logits, "box_regression": reg,
                          "centerness": ctr}
        if mode == "source" and self.atss_on:
            with span("fcos_loss"):
                losses.update(atss_losses(
                    self.atss_cfg, self._anchors(feats), logits, reg, ctr,
                    targets["boxes"], targets["labels"], targets["mask"]))
        elif mode == "source":
            with span("fcos_loss"):
                shapes = [(f.shape[1], f.shape[2]) for f in feats]
                locations = compute_locations(shapes, self.strides,
                                              device=images.device)
                losses.update(fcos_losses(
                    locations, logits, reg, ctr, targets["boxes"],
                    targets["labels"], targets["mask"], gamma=self.loss_gamma,
                    alpha=self.loss_alpha))
        return losses, feats, act_maps, score_maps, new_state

    def discriminator_losses(self, feats, act_maps, score_maps,
                             domain_label: float, domain: str):
        """Per-level adversarial losses (``detector.py:330-358``; reference
        trainer.py:314-376), ``lambda * loss`` under the names
        ``loss_adv_{P}_{FAMILY}_{ds|dt}``. The center-aware family reads
        the score maps detached; the output-space family reads them with
        their gradient, as ``scan_tpu`` does (no stop_gradient there)."""
        with span("discriminator"):
            losses = {}
            suffix = "ds" if domain == "source" else "dt"
            for name in self.dis_names:
                parts = name.split("_")
                layer = parts[1]
                family = parts[2] if len(parts) > 2 else "GA"
                lvl = LAYERS.index(layer)
                mod = getattr(self, name)
                if family == "GA":
                    val = mod(feats[lvl], domain_label, domain)
                elif family == "CA":
                    sm = {k: v[lvl].detach() for k, v in score_maps.items()}
                    val = mod(feats[lvl], domain_label, sm, domain)
                elif family == "OUT":
                    sm = {k: v[lvl] for k, v in score_maps.items()}
                    val = mod(sm, domain_label, domain)
                else:  # CON
                    val = mod(feats[lvl], domain_label, act_maps[lvl], domain)
                losses[f"loss_adv_{layer}_{family}_{suffix}"] = (
                    self.lambdas[family] * val)
            return losses

    @torch.no_grad()
    def reset_int8_calibration(self):
        """Return every int8 |x|max buffer to ``NO_SCALE``, so the convs
        quantize dynamically again: the un-calibrated state that
        ``scan_tpu``'s ``calibrate_int8`` starts each call from (its base
        parameters). ``calibrate_int8`` folds into the running maxima, so a
        caller that calibrates for another dataset resets first."""
        for m in self.modules():
            for name in getattr(m, "scale_names", ()):
                getattr(m, name).fill_(NO_SCALE)
        read_scales(self)
        return self

    @torch.no_grad()
    def calibrate_int8(self, image_batches):
        """Store static int8 activation scales (``detector.py:361-414``):
        run the inference path over each batch of ``image_batches`` (uint8
        NHWC, numpy or tensors) with every int8 conv quantizing dynamically
        and recording its input's running |x|max, folded into the maxima
        the buffers already hold (``reset_int8_calibration`` clears them).
        In ``light`` mode the cls tower does not run and keeps no scale, as
        in ``scan_tpu``. No-op without ``TPU.INT8_INFERENCE``."""
        if not self.int8_inference:
            return self
        device = next(self.parameters()).device
        with calibration(self):
            for images in image_batches:
                if not isinstance(images, torch.Tensor):
                    images = torch.from_numpy(np.asarray(images))
                x = self._prep_images(images.to(device))
                feats = list(self.backbone(x))
                if self.condgraph_on:
                    feats = self.middle_head(feats, self.proto_state(),
                                             "inference")[0]
                self._head(feats, self.test_mode != "light")
        return self

    @torch.no_grad()
    def forward_inference(self, images, image_sizes):
        """Eval path (reference trainer.py foward_detector eval branch +
        fcos.py TEST.MODE mixing). images (B, H, W, 3) uint8 or normalised
        float, image_sizes (B, 2) int [h, w]. Returns a dict of
        (B, DETECTIONS_PER_IMG) tensors: boxes, scores, labels, valid."""
        with span("inference"):
            with span("prep"):
                images = self._prep_images(images)
            with span("backbone"):
                feats = list(self.backbone(images))
            act_maps = None
            if self.condgraph_on:
                with span("middle_head"):
                    feats, _, act_maps, _ = self.middle_head(
                        feats, self.proto_state(), "inference")
            if self.atss_on:
                with span("fcos"):
                    logits, reg, ctr = self._head(feats)
                anchors = self._anchors(feats)
                sizes = image_sizes.to(images.device)
                with span("postprocess"):
                    return atss_postprocess(self.atss_cfg, self.pp_cfg,
                                            anchors, logits, reg, ctr, sizes)
            shapes = [(f.shape[1], f.shape[2]) for f in feats]
            compute_cls = self.test_mode != "light"
            with span("fcos"):
                logits, reg, ctr = self.fcos(feats, compute_cls)
            locations = compute_locations(shapes, self.strides,
                                          device=images.device)
            sizes = image_sizes.to(images.device)
            # mix_cls_maps and fcos_postprocess are looked up on this module
            # at call time, so a caller's wrapper set there wraps them
            with span("postprocess"):
                cls_maps, apply_sigmoid = mix_cls_maps(self.test_mode, logits,
                                                       act_maps)
                pp = dataclasses.replace(self.pp_cfg,
                                         apply_sigmoid=apply_sigmoid)
                return fcos_postprocess(pp, locations, cls_maps, reg, ctr,
                                        sizes)


def build_detector(cfg, device=None, seed: int = 0,
                   train: bool = False) -> SCANDetector:
    """Build the detector with seeded weights on ``device`` (the card unless
    the caller asks for another; raises when there is no card). ``train``
    keeps every parameter float32 whatever the compute dtype (the masters a
    bf16 training step updates); without it a bf16 detector holds its conv
    and GroupNorm parameters in bf16 and only evaluates."""
    dev = resolve_device(device)
    det = SCANDetector(cfg).init_parameters(seed)
    return det.to(dev).set_compute_dtype(cast_params=not train).eval()
