"""VGG-16 backbone over NHWC tensors (counterpart of ``scan_tpu/modeling/backbone/vgg.py``).

Stages of (2, 2, 3, 3, 3) 3x3 convs with ReLU and a 2x2 max-pool after each
(reference ``fcos_core/modeling/backbone/mmdetection/vgg.py``, no BN in the
SCAN configs). Returns the post-pool feature of every stage, C1..C5.
Convs are named ``conv0..conv12`` as in ``scan_tpu``, so weights carry over.

fp path: stage 1 (conv1_1, ReLU, conv1_2, ReLU, pool) goes through
``ops/cuda/stem_kernel.py::fused_stem``, kernel K2 on the card, with its
weights packed once per weight version. Stages 1-2 (conv0..conv3) are built
frozen, ``requires_grad`` False, as ``scan_tpu``'s solver freezes a VGG body
(``solver/build.py:59-100``, FREEZE_CONV_BODY_AT 2). So a training forward
runs K2 too: its output needs no gradient. K2 has no backward, so a
training forward with stage 1 unfrozen raises (``fused_stem``).

int8 path (``quant``): stages 2-5 are int8 convs, and stage 1 follows
``scan_tpu``'s ``_stage1_s2d`` (``vgg.py:236-528``) branch for branch, with
its static scales ``conv0_act``, ``conv1_act`` and ``stem_out_act`` held in
buffers of those names (see ``layers.stored_scale``). ``scan_tpu``'s
space-to-depth phase packing, its row-phase pair convs and the col-split
layout are TPU layout devices: the packed stride-2 conv and the two pair
convs sum exactly the taps of one full-resolution 3x3 conv, so here conv1_2
is that conv and the 2x2 pool (the phase max) follows it. The switches
select the same arithmetic as in ``scan_tpu``:

* default chain: conv1_1 and conv1_2 as int8 convs with fp outputs, pool,
  ReLU; fp out;
* ``stem_s8_epilogue``: both convs requantize in their epilogues (at s1,
  s_out, ReLU folded), the pool runs on s8; s8 out;
* ``stem_pair_conv``: the pair convs, numerically the default chain;
* ``pallas_conv0``: K3 (``ops/cuda/conv0_kernel.py``) for conv1_1 and its
  requant, then conv1_2 with fp output (the compute dtype; ``scan_tpu``
  casts it to int8 here, a fault recorded in ROADMAP queue C); fp out;
* ``pallas_phase_max``: K4 (``phase_max_kernel.phase_max_requant``) for the
  default chain's pool, ReLU and requant, or with ``stem_s8_epilogue`` and
  ``stem_pair_conv`` K6 (``pair_phase_max_s8``) for the s8 pool; s8 out;
* ``pallas_stem_int8``: K5 (``stem_int8_kernel.fused_stem_int8``); s8 out.

``scan_tpu`` gates each kernel on the TPU backend; here the gate is the
full stage-1 width (64 channels) and the branch's own switches and scales.
On the card a branch launches its kernel; on the CPU the same branch runs
the kernel's plain version. The XLA branches quantize the weights cast to
the compute dtype (``vgg.py:276-279, 365``); K3 and K5 quantize the float32
weights (``vgg.py:336-341, 436-437``). ``STEM_CHUNK`` and
``STEM_IM2COL_CONV0`` change only how ``scan_tpu`` schedules the work and
are not ported. Nor is ``PALLAS_STEM`` inside the int8 forward (the fp
stem kernel there); the backbone factory raises on it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cuda.conv0_kernel import conv0_s8, pack_weight
from ...ops.cuda.phase_max_kernel import pair_phase_max_s8, phase_max_requant
from ...ops.cuda.stem_int8_kernel import fused_stem_int8
from ...ops.cuda.stem_int8_kernel import pack_weights as pack_stem_int8
from ...ops.cuda.stem_kernel import STEM_CH, STEM_IN, fused_stem
from ...ops.cuda.stem_kernel import pack_weights as pack_stem
from ...ops.quant import (QuantizedActivation, int8_conv, max_pool_2x2,
                          quantize_activation)
from ..layers import (Conv, add_scales, record_amax, stored_scale, to_nchw,
                      to_nhwc)

VGG16_STAGE_BLOCKS = (2, 2, 3, 3, 3)
VGG16_STAGE_CHANNELS = (64, 128, 256, 512, 512)
FREEZE_AT = 2  # stages frozen in a VGG body (scan_tpu/solver/build.py:66)
N_FROZEN_CONVS = sum(VGG16_STAGE_BLOCKS[:FREEZE_AT])
STEM_SCALES = ("conv0_act", "conv1_act", "stem_out_act")
_PAD1 = ((1, 1), (1, 1))


class VGG16(nn.Module):
    def __init__(self, width_div: int = 1, stage_blocks=VGG16_STAGE_BLOCKS,
                 quant: bool = False,
                 stem_s8_epilogue: bool = True, stem_pair_conv: bool = True,
                 pallas_conv0: bool = False, pallas_phase_max: bool = False,
                 pallas_stem_int8: bool = False):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.channels = tuple(max(8, c // width_div) for c in VGG16_STAGE_CHANNELS)
        self.quant = quant
        # stem switches, as scan_tpu's VGG16 fields (and their defaults)
        self.stem_s8_epilogue = stem_s8_epilogue
        self.stem_pair_conv = stem_pair_conv
        self.pallas_conv0 = pallas_conv0
        self.pallas_phase_max = pallas_phase_max
        self.pallas_stem_int8 = pallas_stem_int8
        self.stem = self.stage_blocks[0] == 2
        self._packs = {}
        idx, cin = 0, STEM_IN
        for blocks, ch in zip(self.stage_blocks, self.channels):
            for _ in range(blocks):
                in_stem = self.stem and idx < 2
                self.add_module(f"conv{idx}", Conv(
                    cin, ch, 3, kernel_init="vgg", quant=quant,
                    act_scale=not in_stem))
                cin = ch
                idx += 1
        for i in range(min(N_FROZEN_CONVS, idx)):
            getattr(self, f"conv{i}").requires_grad_(False)
        if quant:
            self.dtype = None  # compute dtype, set by the detector
            self.calibrating = False
            if self.stem:
                add_scales(self, STEM_SCALES)

    def forward(self, x):
        """x (B, H, W, 3) NHWC float32 -> tuple of C1..C5, NHWC, in the
        compute dtype."""
        outs = []
        idx = 0
        for stage, blocks in enumerate(self.stage_blocks):
            if stage == 0 and self.stem:
                x = self._stage1_int8(x) if self.quant else self._stage1_fp(x)
                idx += 2
            else:
                if not self.quant:
                    x = x.to(getattr(self, f"conv{idx}").weight.dtype)
                for _ in range(blocks):
                    x = F.relu(getattr(self, f"conv{idx}")(x))
                    idx += 1
                x = to_nhwc(F.max_pool2d(to_nchw(x), 2, 2))
            if isinstance(x, QuantizedActivation):
                # the next conv reads the s8 tensor; the C1 tap gets fp
                outs.append(x.dequantize(self.dtype or torch.float32))
            else:
                outs.append(x)
        return tuple(outs)

    def _stage1_fp(self, x):
        """Stage 1 through K2 (``fused_stem``), in inference and in
        training, where the stem is frozen. ``fused_stem`` raises when grad
        mode is on and the input or a stem weight requires grad."""
        c0, c1 = self.conv0, self.conv1
        weights = (c0.weight, c0.bias, c1.weight, c1.bias)
        dt = c0.weight.dtype
        return fused_stem(x, *weights, out_dtype=dt,
                          packed=self._packed(pack_stem, *weights))

    def _stage1_int8(self, x):
        """Stage 1 of the int8 path (``scan_tpu``'s ``_stage1_s2d`` with
        ``quant``). Returns fp (B, H/2, W/2, ch) or a QuantizedActivation."""
        ch = self.channels[0]
        full = ch == STEM_CH
        k0, k1 = self.conv0.hwio(), self.conv1.hwio()   # float32 masters
        b0_raw, b1_raw = self.conv0.bias, self.conv1.bias
        dt = self.dtype or x.dtype
        x = x.to(dt)
        w0, b0, w1, b1 = (t.to(dt) for t in (k0, b0_raw, k1, b1_raw))

        if self.calibrating:
            # every scale dynamic, fp out (vgg.py:302-313)
            record_amax(self, "conv0_act", x)
            y = F.relu(int8_conv(x, w0, b0, 1, _PAD1, out_dtype=dt))
            record_amax(self, "conv1_act", y)
            z = int8_conv(y, w1, b1, 1, _PAD1, out_dtype=dt)
            out = F.relu(max_pool_2x2(z))
            record_amax(self, "stem_out_act", out)
            return out

        s0, s1, s_out = (stored_scale(self, n) for n in STEM_SCALES)
        static = s0 is not None and s1 is not None and s_out is not None
        if self.pallas_stem_int8 and static and full:
            x_q, _ = quantize_activation(x, s0)
            out = fused_stem_int8(x_q, k0, b0_raw, k1, b1_raw, s0, s1, s_out,
                                  packed=self._packed(pack_stem_int8, k0, k1))
            return QuantizedActivation(out, s_out)

        use_s8 = self.stem_s8_epilogue and static
        use_pair = self.stem_pair_conv and s1 is not None
        use_conv0 = (self.pallas_conv0 and s0 is not None and s1 is not None
                     and full)
        if use_conv0:
            x_q, _ = quantize_activation(x, s0)
            y_q = conv0_s8(x_q, k0, b0_raw, s0, s1,
                           packed=self._packed(pack_weight, k0))
            z = int8_conv(y_q, w1, b1, 1, _PAD1, out_dtype=dt, act_scale=s1)
            return F.relu(max_pool_2x2(z))
        if use_s8:
            y_q = int8_conv(x, w0, b0, 1, _PAD1, act_scale=s0,
                            out_quant_scale=s1, fold_relu=True)
            z_q = int8_conv(y_q, w1, b1, 1, _PAD1, act_scale=s1,
                            out_quant_scale=s_out, fold_relu=True)
            if use_pair and self.pallas_phase_max and full:
                out = pair_phase_max_s8(z_q)
            else:
                out = max_pool_2x2(z_q)
            return QuantizedActivation(out, s_out)
        y = F.relu(int8_conv(x, w0, b0, 1, _PAD1, out_dtype=dt, act_scale=s0))
        z = int8_conv(y, w1, b1, 1, _PAD1, out_dtype=dt, act_scale=s1)
        if (self.pallas_phase_max and s1 is not None and s_out is not None
                and not use_pair and full):
            s_out_q = torch.clamp_min(s_out, 1e-8)
            return QuantizedActivation(phase_max_requant(z, s_out_q), s_out_q)
        return F.relu(max_pool_2x2(z))

    def _packed(self, pack, *weights):
        """``pack(*weights)`` for K2, K3 or K5, made once per weight version
        (as ``Conv.quantized_weight`` quantizes once)."""
        key = tuple((w.data_ptr(), w._version) for w in weights)
        if self._packs.get(pack, (None,))[0] != key:
            with torch.no_grad():
                self._packs[pack] = (key, pack(*weights))
        return self._packs[pack][1]
