"""The two-stage detector, Faster / Mask / Keypoint R-CNN (counterpart of
``scan_tpu/modeling/generalized_rcnn.py``; reference
``fcos_core/modeling/detector/generalized_rcnn.py:16-70``).

A backbone (``R-50-FPN`` / ``R-101-FPN``: P2..P6), the anchor RPN
(``rpn_anchor.py``), the box head on P2..P5 and, behind MODEL.MASK_ON and
MODEL.KEYPOINT_ON, the mask and keypoint branches (``roi_heads.py``).
``scan_tpu`` exposes this family only as a class, with no CLI and no
config in ``configs/``; so does the port. Submodules carry the names of
``scan_tpu``'s parameter tree (``backbone``, ``rpn``, ``roi_box``,
``roi_mask``, ``roi_keypoint``), so ``utils/jax_weights.py`` carries it
over.

Images come in as ``scan_tpu``'s do: (B, H, W, 3) NHWC, already
normalised. Proposals are detached where ``scan_tpu`` stops their
gradient. K1 runs once a level in the RPN (5 launches a forward, every
image in each) and once in the box postprocess (ML-NMS).

Compute dtype (``TPU.COMPUTE_DTYPE``): the convs and deconvs compute in
bf16 as flax's ``dtype=`` makes them; the box head's Dense layers, the
FrozenBatchNorms and RoIAlign stay float32. Built with ``train=True`` the
detector keeps every parameter float32 (the masters SGD updates, as
``build_detector(..., train=True)``); without, its conv parameters are
bf16 and it only evaluates.
"""

import torch
from torch import nn

from ..device import resolve_device
from ..ops.roi_align import roi_align
from .anchors import grid_anchors
from .backbone.build import build_backbone
from .layers import Conv, ConvTranspose, GroupNorm32, init_parameters
from .roi_heads import (RoIBoxConfig, RoIBoxHead, RoIKeypointConfig,
                        RoIKeypointHead, RoIMaskConfig, RoIMaskHead,
                        fpn_pooler, keypoints_to_heatmap, match_proposals,
                        pool_branch, roi_box_losses, roi_box_postprocess,
                        roi_keypoint_decode, roi_keypoint_loss, roi_mask_loss)
from .rpn_anchor import RPNConfig, RPNHead, rpn_losses, rpn_proposals


class FasterRCNN(nn.Module):
    """Box head always; the mask and keypoint branches behind MODEL.MASK_ON
    and MODEL.KEYPOINT_ON (reference ``roi_heads/roi_heads.py:14-49``).

    ``FasterRCNN(cfg)`` builds with seeded weights (``seed``) on the card,
    or on ``device`` when the caller asks (``device="cpu"``); it raises
    when the card is asked for and there is none."""

    def __init__(self, cfg, device=None, seed: int = 0, train: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = (torch.bfloat16
                              if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                              else torch.float32)
        self.backbone = build_backbone(cfg)
        channels = self.backbone.fpn.out_channels
        self.rpn_cfg_train = RPNConfig.from_cfg(cfg, is_train=True)
        self.rpn_cfg_test = RPNConfig.from_cfg(cfg, is_train=False)
        self.rpn = RPNHead(self.rpn_cfg_train.num_anchors,
                           input_channels=channels)
        self.box_cfg = RoIBoxConfig.from_cfg(cfg)
        self.roi_box = RoIBoxHead(self.box_cfg, channels)
        self.mask_on = bool(cfg.MODEL.MASK_ON)
        self.keypoint_on = bool(cfg.MODEL.KEYPOINT_ON)
        if self.mask_on:
            self.mask_cfg = RoIMaskConfig.from_cfg(cfg)
            self.roi_mask = RoIMaskHead(self.mask_cfg, channels)
        if self.keypoint_on:
            self.kp_cfg = RoIKeypointConfig.from_cfg(cfg)
            self.roi_keypoint = RoIKeypointHead(self.kp_cfg, channels)
        self.init_parameters(seed)
        self.to(dev)
        self.set_compute_dtype(cast_params=not train)
        self.eval()

    @torch.no_grad()
    def init_parameters(self, seed: int = 0):
        """Seeded init with ``scan_tpu``'s conventions (``layers.py``),
        drawn on the CPU so a seed gives the same weights on every device."""
        gen = torch.Generator().manual_seed(seed)
        for name in ("backbone", "rpn", "roi_box", "roi_mask", "roi_keypoint"):
            if hasattr(self, name):
                init_parameters(getattr(self, name), gen)
        return self

    def set_compute_dtype(self, cast_params: bool = True):
        """Convs, deconvs and GroupNorms compute in TPU.COMPUTE_DTYPE; with
        ``cast_params`` their parameters are cast to it (evaluation only),
        without they stay float32 masters, cast at use. Dense layers and
        FrozenBatchNorms stay float32."""
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose, GroupNorm32)):
                m.compute_dtype = self.compute_dtype
                if cast_params:
                    m.to(self.compute_dtype)
                if isinstance(m, Conv):
                    m.to(memory_format=torch.channels_last)
        return self

    def _anchors(self, feats, rpn_cfg):
        """The RPN's anchors per level, one size a level
        (``generalized_rcnn.py:77-85``)."""
        shapes = [(f.shape[1], f.shape[2]) for f in feats]
        strides = rpn_cfg.strides
        if len(strides) != len(shapes):
            strides = tuple(strides[:1]) * len(shapes)
        sizes = [(s,) for s in rpn_cfg.anchor_sizes[:len(shapes)]]
        if len(sizes) != len(shapes):
            sizes = [(rpn_cfg.anchor_sizes[0],)] * len(shapes)
        return grid_anchors(shapes, strides, sizes, rpn_cfg.aspect_ratios,
                            device=feats[0].device)

    def forward_train(self, images, targets, image_sizes):
        """Losses of one step (``generalized_rcnn.py:113-175``). targets:
        ``boxes`` (B, G, 4), ``labels`` (B, G), ``mask`` (B, G) bool, and
        with the branches ``gt_masks`` (B, G, H, W) bitmaps at image
        resolution and ``gt_keypoints`` (B, G, K, 3) [x, y, visibility]."""
        feats = list(self.backbone(images))
        obj, reg = self.rpn(feats)
        anchors = self._anchors(feats, self.rpn_cfg_train)
        losses = rpn_losses(self.rpn_cfg_train, anchors, obj, reg,
                            targets["boxes"], targets["mask"])
        props = rpn_proposals(self.rpn_cfg_train, anchors, obj, reg,
                              image_sizes)
        proposals = props["boxes"].detach()
        prop_valid = props["valid"]
        matched_labels, reg_targets, matched_idx = match_proposals(
            self.box_cfg, proposals, prop_valid, targets["boxes"],
            targets["labels"], targets["mask"])
        b, n = proposals.shape[:2]
        rois = proposals.reshape(-1, 4)
        bidx = torch.arange(b, device=rois.device).repeat_interleave(n)
        pooled = fpn_pooler(self.box_cfg, feats[:4], rois, bidx)
        cls_logits, bbox_pred = self.roi_box(pooled)
        losses.update(roi_box_losses(
            self.box_cfg, cls_logits, bbox_pred, rois, prop_valid.reshape(-1),
            matched_labels.reshape(-1), reg_targets.reshape(-1, 4)))
        labels = matched_labels.reshape(-1)
        pos_mask = labels > 0
        if self.mask_on or self.keypoint_on:
            # each positive's matched GT row in the (B * G, ...) targets
            g = targets["boxes"].shape[1]
            gidx = matched_idx.reshape(-1).clamp_min(0).long() + bidx * g
        if self.mask_on and "gt_masks" in targets:
            # the matched GT bitmap cropped to each proposal by ROIAlign
            # (the fixed-shape form of the reference's project_masks_on_boxes)
            gm = targets["gt_masks"].float()
            flat_gm = gm.reshape(b * g, gm.shape[2], gm.shape[3], 1)
            s = self.mask_cfg.pooler_resolution * 2  # the logits' 2x deconv
            with torch.no_grad():
                crops = roi_align(flat_gm, rois, gidx, s, 1.0,
                                  self.mask_cfg.sampling_ratio)[..., 0]
            mask_targets = (crops >= 0.5).float()
            mpooled = pool_branch(self.box_cfg, self.mask_cfg, feats[:4],
                                  rois, bidx)
            losses["loss_mask"] = roi_mask_loss(
                self.roi_mask(mpooled), labels, mask_targets, pos_mask)
        if self.keypoint_on and "gt_keypoints" in targets:
            kp = targets["gt_keypoints"].float()
            k = kp.shape[2]
            kp_rois = kp.reshape(b * g, k, 3)[gidx]
            hm_size = self.kp_cfg.pooler_resolution * 4  # deconv 2x, up 2x
            kp_t, kp_valid = keypoints_to_heatmap(kp_rois, rois, hm_size)
            kp_valid = kp_valid * pos_mask.float()[:, None]
            kpooled = pool_branch(self.box_cfg, self.kp_cfg, feats[:4], rois,
                                  bidx)
            losses["loss_kp"] = roi_keypoint_loss(
                self.roi_keypoint(kpooled), kp_t, kp_valid)
        return losses

    @torch.no_grad()
    def forward_inference(self, images, image_sizes):
        """Detections (``generalized_rcnn.py:177-229``): dict of (B, D, ...)
        ``boxes``, ``scores``, ``labels``, ``valid``; with MASK_ON
        ``masks`` (B, D, 2 res, 2 res), the sigmoid of each detection's own
        class; with KEYPOINT_ON ``keypoints`` (B, D, K, 3) and
        ``keypoint_scores`` (B, D, K). The branches run on every slot of the
        final detections, the invalid ones too."""
        feats = list(self.backbone(images))
        obj, reg = self.rpn(feats)
        anchors = self._anchors(feats, self.rpn_cfg_test)
        props = rpn_proposals(self.rpn_cfg_test, anchors, obj, reg,
                              image_sizes)
        b, n = props["boxes"].shape[:2]
        rois = props["boxes"].reshape(-1, 4)
        bidx = torch.arange(b, device=rois.device).repeat_interleave(n)
        pooled = fpn_pooler(self.box_cfg, feats[:4], rois, bidx)
        cls_logits, bbox_pred = self.roi_box(pooled)
        dets = roi_box_postprocess(
            self.box_cfg, cls_logits.reshape(b, n, -1),
            bbox_pred.reshape(b, n, -1), props["boxes"], props["valid"],
            image_sizes)
        if not (self.mask_on or self.keypoint_on):
            return dets
        d = dets["boxes"].shape[1]
        det_rois = dets["boxes"].reshape(-1, 4)
        det_bidx = torch.arange(b, device=rois.device).repeat_interleave(d)
        if self.mask_on:
            mpooled = pool_branch(self.box_cfg, self.mask_cfg, feats[:4],
                                  det_rois, det_bidx)
            logits = self.roi_mask(mpooled)  # (B * D, S, S, classes)
            s = logits.shape[1]
            idx = dets["labels"].reshape(-1).clamp_min(0).long()
            sel = torch.gather(logits, 3, idx[:, None, None, None].expand(
                b * d, s, s, 1))[..., 0]
            dets["masks"] = torch.sigmoid(sel).reshape(b, d, s, s)
        if self.keypoint_on:
            kpooled = pool_branch(self.box_cfg, self.kp_cfg, feats[:4],
                                  det_rois, det_bidx)
            xy, kscores = roi_keypoint_decode(self.roi_keypoint(kpooled),
                                              det_rois)
            dets["keypoints"] = xy.reshape(b, d, -1, 3)
            dets["keypoint_scores"] = kscores.reshape(b, d, -1)
        return dets
