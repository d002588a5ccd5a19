"""ESMStereo confidence variant: the LAFNet-style confidence head on
ESMStereo-S, eval mode (NCHW inside).

Counterpart of ``esmstereo_tpu/models/confidence.py``. The head is defined
only at ``cv_scale=16`` with mobilenetv2_100, as in the reference: it reads
the /16 cost, the initial /16 disparity, the matching descriptor and two
pyramid features (``ESMStereo``'s ``capture_internals``) and returns a
full-resolution confidence map in [0, 1]. The head runs plain PyTorch (no
TPU kernel of the JAX package sits in it); its ESMStereo-S runs the S
slice's kernels.

Reference quirks kept, as in JAX:
  * the enlarged sampling grid scales the x-offset by ``2/(w-1)`` and the
    y-offset by the raw scale (``build_enlarged_grid``);
  * three fusion iterations share their convs but not their BatchNorms;
  * the scale head's last BatchNorm starts at zero, so sampling starts at
    scale 1.

``PhConfUpsample``, the JAX default, is a phase re-layout of
``ConfUpsample``; the port computes ``ConfUpsample``.

At the deploy numerics (a ``dtype="bfloat16"`` config) the head computes in
bf16 as its ESMStereo-S does (``nn.blocks.set_compute_dtype``), after
``esmstereo_tpu/models/confidence.py:60-357`` with ``dtype=bfloat16``: the
cost's top-7 softmax runs on the fp32 cost, the enlarged grid is fp32 (the
bf16 scale promotes, as in jnp), the grid sample weighs the bf16 features
in fp32 and rounds to bf16, and the confidence map is the sigmoid of bf16
logits, bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esmstereo_tpu_torch.device import resolve_device
from esmstereo_tpu_torch.models.esmstereo import ESMStereo, ESMStereoConfig
from esmstereo_tpu_torch.nn import blocks
from esmstereo_tpu_torch.nn.blocks import (ConvBlock, TorchConv,
                                           TorchConvTranspose, batch_norm)
from esmstereo_tpu_torch.nn.init import init_model_
from esmstereo_tpu_torch.ops.sampling import (context_upsample,
                                              grid_sample_bilinear)


def build_enlarged_grid(scale: torch.Tensor) -> torch.Tensor:
    """The 3x enlarged sampling grid of a per-pixel ``scale`` (B, h, w):
    normalised coordinates (B, 3h, 3w, 2), x-offset ``dx * 2/(w-1) *
    scale`` and y-offset ``dy * scale`` (the reference's asymmetry); at
    least fp32, as jnp promotes a bf16 scale against its fp32 grid."""
    b, h, w = scale.shape
    dev = scale.device
    dt = torch.promote_types(scale.dtype, torch.float32)
    scale = scale.to(dt)
    base_x = torch.linspace(-1.0, 1.0, w, device=dev, dtype=dt)
    base_y = torch.linspace(-1.0, 1.0, h, device=dev, dtype=dt)
    taps = torch.tensor([-1.0, 0.0, 1.0], device=dev, dtype=dt)
    sc = scale[:, :, None, :, None]                        # (B, h, 1, w, 1)
    x = base_x.view(1, 1, 1, w, 1) + taps.view(1, 1, 1, 1, 3) * (
        2.0 / (w - 1)) * sc
    y = base_y.view(1, h, 1, 1, 1) + taps.view(1, 1, 3, 1, 1) * sc
    x = x.expand(b, h, 3, w, 3)
    y = y.expand(b, h, 3, w, 3)
    return torch.stack([x, y], dim=-1).reshape(b, 3 * h, 3 * w, 2)


def _conv(cin: int, cout: int, k: int, s: int, p: int, device) -> TorchConv:
    # LAFNet's kaiming_normal with fan_out is the msra distribution
    return TorchConv(cin, cout, k, s, p, use_bias=True, init_mode="msra",
                     device=device)


class _ConvBnRelu3(nn.Module):
    """(k3, k3, k1) convs with bias, each + BN + ReLU."""

    def __init__(self, cin: int, c: int, device=None):
        super().__init__()
        self.conv1 = _conv(cin, c, 3, 1, 1, device)
        self.bn1 = batch_norm(c, device=device)
        self.conv2 = _conv(c, c, 3, 1, 1, device)
        self.bn2 = batch_norm(c, device=device)
        self.conv3 = _conv(c, c, 1, 1, 0, device)
        self.bn3 = batch_norm(c, device=device)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.relu(self.bn3(self.conv3(x)))


class _AttHead(nn.Module):
    """Attention logit head: k3 conv + BN + ReLU, k1 conv to 1 + BN."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv1 = _conv(c, c, 3, 1, 1, device)
        self.bn1 = batch_norm(c, device=device)
        self.conv2 = _conv(c, 1, 1, 1, 0, device)
        self.bn2 = batch_norm(1, device=device)

    def forward(self, x):
        return self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))


class ConfUpsample(nn.Module):
    """x4 confidence upsampling (``ESMStereo_confidence.py:511-548``):
    context upsampling with learned softmax weights, plus a small
    conv-hourglass residual."""

    def __init__(self, c: int, feat_ch: int, device=None):
        super().__init__()
        self.cm0 = ConvBlock(1, c, 5, 1, 1, device=device)
        self.cm1 = ConvBlock(c, c, 3, 1, 1, device=device)
        self.cm2 = ConvBlock(c, c, 3, 1, 1, device=device)
        self.cm3 = ConvBlock(c, c, 1, 1, 1, device=device)
        self.spx4_0 = ConvBlock(c + feat_ch, c, 3, 1, 1, device=device)
        self.spx4_1 = TorchConv(c, c, 3, 1, 1, device=device)
        self.spx4_bn = batch_norm(c, device=device)
        # ConvTranspose(C -> 9, k4 s4 p0): an exact x4
        self.spx = TorchConvTranspose(c, 9, 4, 4, 0, use_bias=True,
                                      device=device)
        self.conv1 = ConvBlock(1, c, 3, 1, 1, device=device)
        self.conv2 = ConvBlock(c, c, 3, 2, 1, device=device)
        self.conv1_up = ConvBlock(c, 1, 4, 2, 1, deconv=True, device=device)

    def forward(self, feat, init_conf):
        f = self.cm3(self.cm2(self.cm1(self.cm0(init_conf))))
        fused = self.spx4_0(torch.cat([f, feat], dim=1))
        fused = F.relu(self.spx4_bn(self.spx4_1(fused)))
        sfm = blocks.softmax(self.spx(fused), 1)
        conf1 = context_upsample(init_conf, sfm, 4)
        conf = self.conv1_up(self.conv2(self.conv1(conf1)))
        return conf + conf1


class LAFNetHead(nn.Module):
    """LAFNet confidence head (``ESMStereo_confidence.py:551-744``):
    ``forward(cost (B, D, h, w), disp (B, 1, h, w), imag (B, 64, h, w),
    f1 (B, C1, h, w), f2 (B, C2, 4h, 4w))`` -> confidence (B, 1, 16h, 16w)."""

    def __init__(self, c: int = 16, imag_ch: int = 64, f1_ch: int = 96,
                 f2_ch: int = 24, device=None):
        super().__init__()
        self.cost_feat = _ConvBnRelu3(7, c, device)
        self.disp_feat = _ConvBnRelu3(1, c, device)
        self.imag_feat = _ConvBnRelu3(imag_ch, c, device)
        self.cost_att = _AttHead(c, device)
        self.disp_att = _AttHead(c, device)
        self.imag_att = _AttHead(c, device)
        self.embed_conv1 = _conv(3 * c, c, 3, 1, 1, device)
        self.embed_bn1 = batch_norm(c, device=device)
        self.scale_conv1 = _conv(c, c, 3, 1, 1, device)
        self.scale_bn1 = batch_norm(c, device=device)
        self.scale_conv2 = _conv(c, c, 3, 1, 1, device)
        self.scale_bn2 = batch_norm(c, device=device)
        self.scale_conv3 = _conv(c, 1, 1, 1, 0, device)
        self.scale_bn3 = batch_norm(1, device=device)
        nn.init.zeros_(self.scale_bn3.weight)      # sampling starts at scale 1
        self.embed_conv2 = _conv(c, c, 3, 3, 0, device)
        self.embed_bn2 = batch_norm(c, device=device)
        self.fusion_conv1 = _conv(c + 1, c, 3, 1, 1, device)
        self.fusion_conv2 = _conv(c, c, 3, 1, 1, device)
        self.fusion_conv3 = _conv(c, 1, 1, 1, 0, device)
        for it in (1, 2, 3):
            for k, ch in ((1, c), (2, c), (3, 1)):
                self.add_module(f"fusion_bn{k}_iter{it}",
                                batch_norm(ch, device=device))
        self.conf_up4 = ConfUpsample(c, f1_ch, device)
        self.conf_up1 = ConfUpsample(c, f2_ch, device)

    def forward(self, cost, disp, imag, f1, f2):
        # top-7 of the softmax of the sharpened, L2-normalised (over D) cost
        norm = torch.sqrt(torch.sum(cost ** 2, dim=1, keepdim=True) + 1e-6)
        x = blocks.softmax(-(cost / norm) * 100.0, 1)
        topv = torch.topk(x, 7, dim=1).values
        cost_x = self.cost_feat(topv)
        disp_x = self.disp_feat(disp)
        imag_x = self.imag_feat(imag)
        atts = blocks.softmax(torch.cat([self.cost_att(cost_x),
                                         self.disp_att(disp_x),
                                         self.imag_att(imag_x)], dim=1), 1)
        x = torch.cat([cost_x * atts[:, 0:1], disp_x * atts[:, 1:2],
                       imag_x * atts[:, 2:3]], dim=1)
        feat = F.relu(self.embed_bn1(self.embed_conv1(x)))

        s = F.relu(self.scale_bn1(self.scale_conv1(feat)))
        s = F.relu(self.scale_bn2(self.scale_conv2(s)))
        scale = 2.0 * blocks.sigmoid(self.scale_bn3(self.scale_conv3(s)))
        grid = build_enlarged_grid(scale[:, 0])
        feat = grid_sample_bilinear(feat, grid, align_corners=True)
        feat = F.relu(self.embed_bn2(self.embed_conv2(feat)))

        out = torch.full_like(feat[:, :1], 0.5)
        for it in (1, 2, 3):
            bn1, bn2, bn3 = (getattr(self, f"fusion_bn{k}_iter{it}")
                             for k in (1, 2, 3))
            x = torch.cat([feat, out], dim=1)
            x = F.relu(bn1(self.fusion_conv1(x)))
            x = F.relu(bn2(self.fusion_conv2(x)))
            out = F.relu(bn3(self.fusion_conv3(x)))
        out4 = self.conf_up4(f1, out)
        return blocks.sigmoid(self.conf_up1(f2, out4))


CONFIDENCE_CONFIG = ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100")


class ESMStereoConfidence(nn.Module):
    """ESMStereo-S plus the confidence head
    (``ESMStereo_confidence.py:746-976``), eval mode.

    ``forward(left, right)`` takes NHWC images ``(B, H, W, 3)`` (H and W
    multiples of 32) and returns ``(disparity (B, H, W), confidence (B, H,
    W))``, the disparity fp32 and the confidence in the compute dtype. The
    config must be cv16 with mobilenetv2_100 (either volume; the JAX class
    default is gwc, the published C row norm-correlation). Weights are
    drawn from ``seed``; ``models.convert_jax`` loads JAX ones.
    """

    def __init__(self, config: ESMStereoConfig = CONFIDENCE_CONFIG,
                 device=None, seed: int = 0):
        super().__init__()
        if config.cv_scale != 16:
            raise ValueError("the confidence head is only defined for "
                             "cv_scale=16 (ESMStereo_confidence.py:868-871)")
        dev = resolve_device(device)
        self.config = config
        self.stereo = ESMStereo(config, device=dev, seed=seed)
        chans = self.stereo.feature.chans
        self.confidence_net = LAFNetHead(16, 64, chans[3], chans[1], dev)
        if dev.type != "meta":
            init_model_(self.confidence_net,
                        torch.Generator().manual_seed(seed + 1))
        blocks.set_compute_dtype(self.confidence_net, config.torch_dtype)
        self.eval()

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                capture_internals: bool = False):
        if self.training:
            raise NotImplementedError(
                "the confidence model does not train in the port yet: its "
                "two-phase recipe (tools/accuracy_scoreboard.py) is a later "
                "slice; train ESMStereo-S, or call .eval() first")
        disp, aux = self.stereo(left, right, capture_internals=True)
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        conf = self.confidence_net(aux["cost"], nchw(aux["init_pred"]),
                                   nchw(aux["match_left"]), nchw(aux["f16"]),
                                   nchw(aux["f4"]))[:, 0]
        if capture_internals:
            return (disp[0], conf), dict(aux, disp=disp[0])
        return disp[0], conf
