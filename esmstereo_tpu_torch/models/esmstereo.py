"""ESMStereo, L variant, eval mode (NCHW / NCDHW inside).

Counterpart of ``esmstereo_tpu/models/esmstereo.py`` for its cv4 branch:
siamese feature pyramid -> FeatUp -> matching descriptors -> group-wise
correlation volume -> group_stem + agg -> 3-D hourglass -> top-2
regression -> ESM upsampling (ShuffleMixer + refinement) -> disparity x 4.

The TPU re-layouts of the JAX package (depth folding, phase folding,
W-phase mixing) are not ported: the port computes the plain function,
which the JAX package's own tests hold equal to its folded paths. Module
names follow the JAX parameter tree so ``models.convert_jax`` can carry
weights across by path.

Three hand-written kernels carry the path (``ops.kernels``): the fused
backbone head (inside ``FeaturePyramid``), the volume and group_stem + agg.
On CPU tensors their plain PyTorch versions run.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from esmstereo_tpu_torch.backbones.efficientnet import ARCHS, FeaturePyramid
from esmstereo_tpu_torch.device import resolve_device
from esmstereo_tpu_torch.nn import blocks
from esmstereo_tpu_torch.nn.blocks import (Conv2x, ConvBlock, StemBlock,
                                           TorchConv, apply_act, batch_norm,
                                           folded_once)
from esmstereo_tpu_torch.nn.init import init_model_
from esmstereo_tpu_torch.nn.shufflemixer import FMBlock, PixelShuffleUp
from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem
from esmstereo_tpu_torch.ops.regression import regression_topk
from esmstereo_tpu_torch.ops.sampling import resize_bilinear


@dataclasses.dataclass(frozen=True)
class ESMStereoConfig:
    """The configuration fields this slice keeps. Only the L variant
    (cv_scale 4, efficientnet_b2, gwc, 32 groups, reduction 8) in fp32 is
    ported; anything else raises ``NotImplementedError``."""

    max_disp: int = 192
    cost_volume: str = "gwc"
    backbone: str = "efficientnet_b2"
    cv_scale: int = 4
    num_groups: int = 32
    reduction: int = 8
    dtype: str = "float32"

    def __post_init__(self):
        got = (self.cost_volume, self.backbone, self.cv_scale,
               self.num_groups, self.reduction, self.dtype)
        want = ("gwc", "efficientnet_b2", 4, 32, 8, "float32")
        if got != want:
            raise NotImplementedError(
                f"this slice ports ESMStereo-L only {want}; got {got}")
        if self.max_disp % self.cv_scale:
            raise ValueError(f"max_disp {self.max_disp} is not a multiple "
                             f"of cv_scale {self.cv_scale}")


def _crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop the trailing spatial overhang of a deconv output."""
    return x[(..., *[slice(0, s) for s in ref.shape[2:]])]


class FeatUp(nn.Module):
    """Top-down fusion of the pyramid for cv_scale 4 (``ESMStereo.py:79-125``):
    ``[x2, x4, x8, x16, x32] -> [x4, x8, x16, x32]``."""

    def __init__(self, chans, device=None):
        super().__init__()
        c = chans
        self.deconv32_16 = Conv2x(c[4], c[3], c[3], device)
        self.deconv16_8 = Conv2x(2 * c[3], c[2], c[2], device)
        self.deconv8_4 = Conv2x(2 * c[2], c[1], c[1], device)
        self.conv4 = ConvBlock(2 * c[1], 2 * c[1], 3, 1, 1, init_mode="msra",
                               device=device)

    def forward(self, feats):
        _, x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


class Aggregation3D(nn.Module):
    """Three-level 3-D hourglass over the volume (``ESMStereo.py:129-182``);
    one channel out at the input's (D, H, W)."""

    def __init__(self, in_channels: int, add_channel: int, device=None):
        super().__init__()
        c1 = in_channels + add_channel
        c2 = in_channels + 2 * add_channel
        c3 = in_channels + 4 * add_channel

        def block(cin, cout, k, s, p, deconv=False, bn=True, act="gelu"):
            return ConvBlock(cin, cout, k, s, p, deconv=deconv, dims=3, bn=bn,
                             act=act, device=device)

        self.conv1_0 = block(in_channels, c1, 3, 2, 1)
        self.conv1_1 = block(c1, c1, 3, 1, 1)
        self.conv2_0 = block(c1, c2, 3, 2, 1)
        self.conv2_1 = block(c2, c2, 3, 1, 1)
        self.conv3_0 = block(c2, c3, 3, 2, 1)
        self.conv3_1 = block(c3, c3, 3, 1, 1)
        self.conv3_up = block(c3, c2, 4, 2, 1, deconv=True)
        self.agg_0_0 = block(2 * c2, c2, 1, 1, 0)
        self.agg_0_1 = block(c2, c2, 3, 1, 1)
        self.conv2_up = block(c2, c1, 4, 2, 1, deconv=True)
        self.agg_1_0 = block(2 * c1, c1, 1, 1, 0)
        self.agg_1_1 = block(c1, c1, 3, 1, 1)
        self.conv1_up = block(c1, 1, 4, 2, 1, deconv=True, bn=False, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1 = self.conv1_1(self.conv1_0(x))
        conv2 = self.conv2_1(self.conv2_0(conv1))
        conv3 = self.conv3_1(self.conv3_0(conv2))
        up = _crop_like(self.conv3_up(conv3), conv2)
        conv2 = self.agg_0_1(self.agg_0_0(torch.cat([up, conv2], dim=1)))
        up = _crop_like(self.conv2_up(conv2), conv1)
        conv1 = self.agg_1_1(self.agg_1_0(torch.cat([up, conv1], dim=1)))
        return self.conv1_up(conv1)


class UpRefinement(nn.Module):
    """2-D hourglass residual refinement (``ESMStereo.py:185-239``); ``f1``
    joins at /4 of the disparity input, ``f2`` at /2."""

    def __init__(self, channels: int, f1_ch: int, f2_ch: int, device=None):
        super().__init__()
        c = channels

        def block(cin, cout, k, s, p, deconv=False, bn=True, act="gelu"):
            return ConvBlock(cin, cout, k, s, p, deconv=deconv, bn=bn,
                             act=act, device=device)

        self.conv1_0 = block(1, c, 3, 2, 1)
        self.conv1_1 = block(c, c, 3, 1, 1)
        self.conv2_0 = block(c, c, 3, 2, 1)
        self.conv2_1 = block(c, c, 3, 1, 1)
        self.conv3_0 = block(c, c, 3, 2, 1)
        self.conv3_1 = block(c, c, 3, 1, 1)
        self.conv3_up = block(c, c, 4, 2, 1, deconv=True)
        self.agg_0_0 = block(2 * c + f1_ch, c, 1, 1, 0)
        self.agg_0_1 = block(c, c, 3, 1, 1)
        self.conv2_up = block(c, c, 4, 2, 1, deconv=True)
        self.agg_1_0 = block(2 * c + f2_ch, c, 1, 1, 0)
        self.agg_1_1 = block(c, c, 3, 1, 1)
        self.conv1_up = block(c, 1, 4, 2, 1, deconv=True, bn=False, act=None)

    def forward(self, disp, f1, f2):
        conv1 = self.conv1_1(self.conv1_0(disp))
        conv2 = self.conv2_1(self.conv2_0(conv1))
        conv3 = self.conv3_1(self.conv3_0(conv2))
        up = _crop_like(self.conv3_up(conv3), conv2)
        conv2 = self.agg_0_1(self.agg_0_0(torch.cat([up, conv2, f1], dim=1)))
        up = self.conv2_up(conv2)
        conv1 = self.agg_1_1(self.agg_1_0(torch.cat([up, conv1, f2], dim=1)))
        return self.conv1_up(conv1)


class DispFeatures(nn.Module):
    """``dm*`` stack k5p1 -> k3p1 -> k3p1 -> k1p1 (size preserved)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        c = channels
        self.conv0 = ConvBlock(1, c, 5, 1, 1, device=device)
        self.conv1 = ConvBlock(c, c, 3, 1, 1, device=device)
        self.conv2 = ConvBlock(c, c, 3, 1, 1, device=device)
        self.conv3 = ConvBlock(c, c, 1, 1, 1, device=device)

    def forward(self, disp):
        return self.conv3(self.conv2(self.conv1(self.conv0(disp))))


class SpxBlock(nn.Module):
    """ConvBlock -> conv3x3 -> BN -> GELU (``ESMStereo.py:255-258``)."""

    def __init__(self, in_ch: int, mid: int, out: int, device=None):
        super().__init__()
        self.conv0 = ConvBlock(in_ch, mid, 3, 1, 1, device=device)
        self.conv1 = TorchConv(mid, out, 3, 1, 1, device=device)
        self.bn = batch_norm(out, device=device)

    def forward(self, x):
        return apply_act(self.bn(self.conv1(self.conv0(x))), "gelu")


class _UpStage(nn.Module):
    """One x2 ESM stage: disparity features -> fuse -> (mix) -> shuffle-up ->
    tail -> hourglass refinement -> bilinear-up skip + residual."""

    def __init__(self, fuse_ch: int, f1_ch: int, f2_ch: int, dm_ch: int,
                 spx_out: int, n_feats: int, use_mixer: bool, device=None):
        super().__init__()
        self.dm = DispFeatures(dm_ch, device)
        self.spx = SpxBlock(dm_ch + fuse_ch, dm_ch, spx_out, device)
        self.use_mixer = use_mixer
        if use_mixer:
            self.to_feat = TorchConv(spx_out, n_feats, 3, 1, 1, device=device)
            self.block0 = FMBlock(n_feats, 7, 2, device)
            self.block1 = FMBlock(n_feats, 7, 2, device)
        self.up = PixelShuffleUp(n_feats if use_mixer else spx_out, n_feats,
                                 2, device)
        self.tail = TorchConv(n_feats, 1, 3, 1, 1, use_bias=True,
                              device=device)
        self.ref = UpRefinement(32, f1_ch, f2_ch, device)

    def forward(self, disp, fuse_feat, ref_f1, ref_f2):
        x = self.spx(torch.cat([self.dm(disp), fuse_feat], dim=1))
        if self.use_mixer:
            x = self.block1(self.block0(self.to_feat(x)))
        x = self.tail(self.up(x))
        x = self.ref(x, ref_f1, ref_f2)
        h, w = disp.shape[2] * 2, disp.shape[3] * 2
        return resize_bilinear(disp, (h, w)) + x


class Upsample4(nn.Module):
    """x4 ESM upsampler, two x2 stages (``ESMStereo.py:242-318``)."""

    def __init__(self, f1_ch: int, f2_ch: int, f4_ch: int, device=None):
        super().__init__()
        self.stage2x = _UpStage(f2_ch, f1_ch, f2_ch, 32, 32, 16, True, device)
        self.stage4x = _UpStage(f4_ch, f2_ch, f4_ch, 32, 16, 16, False, device)

    def forward(self, f1x, f2x, f4x, init_disp):
        up2 = self.stage2x(init_disp, f2x, f1x, f2x)
        up4 = self.stage4x(up2, f4x, f2x, f4x)
        return up4, up2


def _stem_agg_consts(model) -> dict:
    return fused_agg_stem.prepare_consts(model.group_stem, model.agg)


class ESMStereo(nn.Module):
    """ESMStereo-L in eval mode (``ESMStereo.py:511-745``, cv4 branch).

    ``forward(left, right)`` takes NHWC images ``(B, H, W, 3)`` (H and W
    multiples of 32) and returns ``[disparity (B, H, W)]``; with
    ``capture_internals=True`` also the dict of intermediates the JAX model
    returns (in the JAX package's layouts). Weights are drawn from ``seed``
    with the reference's init rules; ``models.convert_jax`` loads JAX ones.
    """

    def __init__(self, config: ESMStereoConfig = ESMStereoConfig(),
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        chans = ARCHS[config.backbone].chans
        self.feature = FeaturePyramid(config.backbone, device=dev)
        self.feature_up = FeatUp(chans, dev)
        self.stem_2 = StemBlock(3, 32, dev)
        self.stem_4 = StemBlock(32, 48, dev)
        match_in = 2 * chans[1] + 48
        self.conv = ConvBlock(match_in, 64, 3, 1, 1, device=dev)
        # the reference descriptor is a default nn.Conv2d, i.e. with a bias
        self.desc = TorchConv(64, 64, 1, 1, 0, use_bias=True, device=dev)
        red = config.reduction
        self.group_stem = ConvBlock(config.num_groups, red, 3, 1, 1, dims=3,
                                    device=dev)
        self.agg = ConvBlock(red, red, 3, 1, 1, dims=3, device=dev)
        self.aggregation_out = Aggregation3D(red, 16, dev)
        self.upsample_module = Upsample4(2 * chans[2], 2 * chans[1], 32, dev)
        if dev.type != "meta":
            init_model_(self, torch.Generator().manual_seed(seed))
        self.eval()

    @property
    def num_bins(self) -> int:
        return self.config.max_disp // self.config.cv_scale

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                capture_internals: bool = False):
        if self.training:
            raise NotImplementedError("training is not in this slice; "
                                      "call .eval() first")
        bsz = left.shape[0]
        both = torch.cat([left, right], dim=0).permute(0, 3, 1, 2).contiguous()
        f_both = self.feature_up(self.feature(both))
        s2 = self.stem_2(both)
        s4 = self.stem_4(s2)
        m = self.desc(self.conv(torch.cat([f_both[0], s4], dim=1)))
        match_l, match_r = m[:bsz], m[bsz:]

        volume = correlation.gwc_volume(match_l, match_r, self.num_bins,
                                        self.config.num_groups)
        consts = folded_once(self, _stem_agg_consts, self.group_stem,
                             self.agg)
        volume = fused_agg_stem.stem_agg(volume, consts,
                                         blocks.GELU_APPROXIMATE)
        cost = self.aggregation_out(volume)[:, 0]          # (B, D, H/4, W/4)

        # regression and the disparity stream stay fp32 (the slice is fp32)
        init_pred = regression_topk(cost, 2)               # (B, 1, H/4, W/4)
        fl = [f[:bsz] for f in f_both]
        disp_1, disp_2 = self.upsample_module(fl[1], fl[0], s2[:bsz],
                                              init_pred)
        result = [disp_1[:, 0] * 4]
        if capture_internals:
            nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
            # keys and pyramid indices as the JAX model's aux dict
            aux = {"cost": cost, "init_pred": nhwc(init_pred),
                   "match_left": nhwc(match_l), "f16": nhwc(fl[3]),
                   "f4": nhwc(fl[1]), "disp_2": disp_2[:, 0]}
            return result, aux
        return result
