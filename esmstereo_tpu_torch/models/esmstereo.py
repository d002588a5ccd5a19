"""ESMStereo, L, M and S variants, eval and training modes (NCHW / NCDHW
inside).

Counterpart of ``esmstereo_tpu/models/esmstereo.py`` for its cv4 (L), cv8
(M) and cv16 (S) branches: siamese feature pyramid -> FeatUp (cv4, cv8;
S takes the raw mobilenetv2 pyramid) -> matching descriptors -> group-wise
(gwc) or norm-correlation volume (at cv16 multiplied by a semantic
attention map) -> group_stem/corr_stem + agg -> 3-D hourglass ->
regression (top-2 at cv4, the raw-cost weighted sum at cv8 and cv16) ->
ESM upsampling (ShuffleMixer + refinement: two x2 stages at cv4, three at
cv8, two x4 stages at cv16) -> disparity x 4.

The TPU re-layouts of the JAX package (depth folding, phase folding,
W-phase mixing) are not ported: the port computes the plain function,
which the JAX package's own tests hold equal to its folded paths. Module
names follow the JAX parameter tree so ``models.convert_jax`` can carry
weights across by path.

Hand-written kernels carry the path (``ops.kernels``): the fused backbone
head (inside ``FeaturePyramid``), the volume and group_stem + agg (at cv16
norm-correlation corr_stem and agg stay plain, as in JAX); with the
config's ``fuse_*`` switches, the volume built inside group_stem (cv4,
cv8), the hourglass levels, the stem_2 + stem_4 towers and the cv4
upsampler's ShuffleMixer section. On CPU tensors their plain PyTorch
versions run.

Training mode (``model.train()``) computes what the JAX model's
``train=True`` computes: the siamese batch with every BatchNorm on the
joint left + right statistics (flax's running-variance rule,
``nn.blocks.BatchNorm2d``), the plain modules at every kernel site (JAX
takes its plain twins there, ``esmstereo_tpu/models/esmstereo.py:476,480,
538,630,638,775``, ``models/folded_agg.py:78,144``, ``backbones/fused.py:
163``: ``pallas_call`` has no AD rule, and the CUDA kernels are eval-only
too), and every scale's disparity (``train_status``, ``:814-817``). So a
training step launches no kernel.

The deploy numerics (``dtype="bfloat16"``, every variant and volume, with
any ``fuse_*`` switch): the modules compute in bf16 with fp32 parameters
and BN statistics (``nn.blocks``); kernel A writes bf16 (in either
backbone's form), B builds the bf16 volume in its rounding (gwc or
normalised), the cv16 attention multiply runs in bf16, and C runs its bf16
form (or, with ``volume_int8``, its int8 form on the quantised volume;
at cv16 with the norm-correlation volume corr_stem and agg stay plain bf16
modules). The switches' kernels run their bf16 forms: E on the bf16
descriptors, G and H on the bf16 volume's hourglass, F from the fp32 image
to bf16 stems, I from the bf16 spx map to a bf16 map, each rounding its
operands where the TPU kernel does. The cost is cast to fp32 before
regression, and the disparity stream stays fp32 from there
(``esmstereo_tpu/models/esmstereo.py:769-774``): the upsamplers' features
are bf16, their 1-channel disparity sums fp32.
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
from esmstereo_tpu_torch.ops.kernels import (correlation, fused_agg_stem,
                                             fused_hourglass, fused_mixer,
                                             fused_stems)
from esmstereo_tpu_torch.ops.regression import (disparity_regression,
                                                regression_topk)
from esmstereo_tpu_torch.ops.sampling import resize_bilinear


@dataclasses.dataclass(frozen=True)
class ESMStereoConfig:
    """The configuration fields the port keeps. Ported, in fp32 with 32
    groups and reduction 8: ``cv_scale`` 4 (L) or 8 (M) with
    efficientnet_b2, and 16 (S) with mobilenetv2_100, each with
    ``cost_volume`` ``"gwc"`` or ``"norm_correlation"``. cv8 or cv16 with
    another backbone raises ``ValueError``, as the JAX config does;
    mobilenetv2_100 at cv4 raises ``NotImplementedError``. ``dtype``
    ``"bfloat16"`` (the deploy numerics of ``bench.py``) is ported for L,
    M and S with either volume and any ``fuse_*`` switches, as
    ``bench.py``'s ``BENCH_FUSE_*`` settings run them.
    ``max_disp`` is floored to a multiple of ``cv_scale`` (``num_bins =
    max_disp // cv_scale``), as in JAX.

    ``volume_int8`` (``esmstereo_tpu/models/esmstereo.py:143``) stores the
    volume as int8 between kernels B and C, with one symmetric scale per
    batch folded into group_stem's weights, in fp32 or bf16. As in JAX it
    changes nothing under ``fuse_volume_agg`` (no volume is stored), nor at
    cv16 with the norm-correlation volume (corr_stem and agg are plain
    there), and the int8 form of kernel C runs bf16 operands in either
    dtype, as the TPU kernel does; it writes the model's dtype.

    The five ``fuse_*`` switches are the JAX config's opt-in kernel paths
    (``esmstereo_tpu/models/esmstereo.py:95,129,150-151,163``), off by
    default there and here: ``fuse_stems`` runs stem_2 + stem_4 as kernel
    F (at cv8 stem_8 stays plain, on F's stem_4); ``fuse_volume_agg``
    builds the volume inside group_stem or corr_stem (kernel E in place of
    B + C); ``fuse_hourglass`` runs each hourglass down level as kernel G
    and ``fuse_hourglass_up`` each up level as kernel H; ``fuse_mixer``
    runs the cv4 upsampler's to_feat -> FMBlock x2 -> shuffle-up section as
    kernel I. As in JAX (``PhUpsample8`` and ``PhUpsample16`` take no such
    switch), ``fuse_mixer`` changes nothing at cv8 and cv16, where kernel I
    never launches; nor does ``fuse_volume_agg`` at cv16, where the
    attention multiply sits between the volume and its stem
    (``esmstereo_tpu/models/esmstereo.py:650-651``), so kernel E never
    launches there. Each switch computes the same function as the default
    path, and they combine freely at every scale."""

    max_disp: int = 192
    cost_volume: str = "gwc"
    backbone: str = "efficientnet_b2"
    cv_scale: int = 4
    num_groups: int = 32
    reduction: int = 8
    dtype: str = "float32"
    fuse_volume_agg: bool = False
    fuse_hourglass: bool = False
    fuse_hourglass_up: bool = False
    fuse_stems: bool = False
    fuse_mixer: bool = False
    volume_int8: bool = False

    def __post_init__(self):
        if self.cost_volume not in ("gwc", "norm_correlation"):
            raise ValueError(f"cost_volume {self.cost_volume!r}")
        if self.cv_scale not in (4, 8, 16):
            raise ValueError(f"cv_scale {self.cv_scale}")
        # the JAX config's variant/backbone constraints (esmstereo.py:189-197)
        if self.cv_scale == 8 and self.backbone != "efficientnet_b2":
            raise ValueError("cv_scale=8 requires efficientnet_b2 (the "
                             "descriptor conv is sized for its /8 features)")
        if self.cv_scale == 16 and self.backbone != "mobilenetv2_100":
            raise ValueError("cv_scale=16 requires mobilenetv2_100 (the "
                             "semantic and descriptor convs are sized for "
                             "its 96-channel /16 features)")
        backbone = "mobilenetv2_100" if self.cv_scale == 16 else \
            "efficientnet_b2"
        rest = (self.backbone, self.num_groups, self.reduction)
        if rest != (backbone, 32, 8):
            raise NotImplementedError(
                "the port runs L and M (cv_scale 4 or 8 with efficientnet_b2) "
                "and S (cv_scale 16 with mobilenetv2_100), 32 groups, "
                f"reduction 8; got cv_scale {self.cv_scale}, {rest}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {self.dtype!r}")

    @property
    def torch_dtype(self) -> torch.dtype | None:
        """The compute dtype, ``None`` for fp32 (no casts)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else None


def _crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop the trailing spatial overhang of a deconv output."""
    return x[(..., *[slice(0, s) for s in ref.shape[2:]])]


class FeatUp(nn.Module):
    """Top-down fusion of the pyramid (``ESMStereo.py:79-125``):
    ``[x2, x4, x8, x16, x32] -> [x4, x8, x16, x32]``, fused down to /4 at
    cv_scale 4 and to /8 at cv_scale 8 (where x4 stays the backbone's)."""

    def __init__(self, chans, cv_scale: int = 4, device=None):
        super().__init__()
        c = chans
        self.cv_scale = cv_scale
        self.deconv32_16 = Conv2x(c[4], c[3], c[3], device)
        self.deconv16_8 = Conv2x(2 * c[3], c[2], c[2], device)
        if cv_scale == 8:
            self.conv8 = ConvBlock(2 * c[2], 2 * c[2], 3, 1, 1,
                                   init_mode="msra", device=device)
        else:
            self.deconv8_4 = Conv2x(2 * c[2], c[1], c[1], device)
            self.conv4 = ConvBlock(2 * c[1], 2 * c[1], 3, 1, 1,
                                   init_mode="msra", device=device)

    def forward(self, feats):
        _, x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        if self.cv_scale == 8:
            x8 = self.conv8(x8)
        else:
            x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


def _level_fold(prepare, *names):
    """A ``folded_once`` fold of the named submodules of an
    ``Aggregation3D`` (one function per level, so each keeps its memo), in
    the kernel's form for the blocks' compute dtype."""
    def fold(agg):
        mods = [getattr(agg, n) for n in names]
        return prepare(*mods, low_precision=blocks.computes_bf16(agg))
    return fold


_DOWN_LEVELS = tuple(
    (names, _level_fold(fused_hourglass.prepare_down_consts, *names))
    for names in (("conv1_0", "conv1_1"), ("conv2_0", "conv2_1"),
                  ("conv3_0", "conv3_1")))
_UP_LEVELS = tuple(
    (names, _level_fold(fused_hourglass.prepare_up_consts, *names))
    for names in (("conv3_up", "agg_0_0", "agg_0_1"),
                  ("conv2_up", "agg_1_0", "agg_1_1")))


class Aggregation3D(nn.Module):
    """Three-level 3-D hourglass over the volume (``ESMStereo.py:129-182``);
    one channel out at the input's (D, H, W).

    In eval mode ``fuse_pairs`` runs each down level (k3 s2 + k3 s1) as
    kernel G and ``fuse_up`` each up level (transposed conv, concat, 1x1x1,
    k3) as kernel H, as ``FoldedAggregation3D`` does
    (``esmstereo_tpu/models/folded_agg.py:50-53``), in their bf16 forms at
    the deploy numerics (the volume arrives in the model dtype, as
    ``folded_agg.py:93-96`` casts it); ``conv1_up`` stays a plain
    ``ConvBlock`` there and here."""

    def __init__(self, in_channels: int, add_channel: int, device=None,
                 fuse_pairs: bool = False, fuse_up: bool = False):
        super().__init__()
        self.fuse_pairs = fuse_pairs
        self.fuse_up = fuse_up
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
        approx = blocks.GELU_APPROXIMATE
        skips = []
        for names, fold in _DOWN_LEVELS:
            first, second = (getattr(self, n) for n in names)
            if self.fuse_pairs and not self.training:
                consts = folded_once(self, fold, first, second)
                x = fused_hourglass.down_pair(x, consts, approx)
            else:
                x = second(first(x))
            skips.append(x)
        conv1, conv2, x = skips
        for (names, fold), skip in zip(_UP_LEVELS, (conv2, conv1)):
            deconv, cat, conv = (getattr(self, n) for n in names)
            if self.fuse_up and not self.training:
                consts = folded_once(self, fold, deconv, cat, conv)
                x = fused_hourglass.up_pair(x, skip, consts, approx)
            else:
                up = _crop_like(deconv(x), skip)
                x = conv(cat(torch.cat([up, skip], dim=1)))
        return self.conv1_up(x)


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


def _mixer_consts(stage) -> dict:
    """Kernel I's packed weights, rounded to bf16 in the bf16 form."""
    return fused_mixer.prepare_consts(
        stage, low_precision=blocks.computes_bf16(stage))


class _UpStage(nn.Module):
    """One ESM stage of ``scale`` (2, or 4 at cv16): disparity features ->
    fuse -> (mix) -> shuffle-up by ``scale`` -> tail -> hourglass
    refinement -> bilinear-up skip by ``scale`` + residual.

    In eval mode ``fuse_mixer`` runs to_feat -> FMBlock x2 -> shuffle-up as
    kernel I, as ``PhUpStage2x`` does
    (``esmstereo_tpu/models/phased_upsample.py:489-498``)."""

    def __init__(self, fuse_ch: int, f1_ch: int, f2_ch: int, dm_ch: int,
                 spx_out: int, n_feats: int, ref_ch: int, use_mixer: bool,
                 device=None, fuse_mixer: bool = False, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.dm = DispFeatures(dm_ch, device)
        self.spx = SpxBlock(dm_ch + fuse_ch, dm_ch, spx_out, device)
        self.use_mixer = use_mixer
        self.fuse_mixer = fuse_mixer and use_mixer
        if use_mixer:
            self.to_feat = TorchConv(spx_out, n_feats, 3, 1, 1, device=device)
            self.block0 = FMBlock(n_feats, 7, 2, device)
            self.block1 = FMBlock(n_feats, 7, 2, device)
        self.up = PixelShuffleUp(n_feats if use_mixer else spx_out, n_feats,
                                 scale, device)
        self.tail = TorchConv(n_feats, 1, 3, 1, 1, use_bias=True,
                              device=device)
        self.ref = UpRefinement(ref_ch, f1_ch, f2_ch, device)

    def forward(self, disp, fuse_feat, ref_f1, ref_f2):
        x = self.spx(torch.cat([self.dm(disp), fuse_feat], dim=1))
        if self.fuse_mixer and not self.training:
            consts = folded_once(self, _mixer_consts, self.to_feat,
                                 self.block0, self.block1, self.up)
            x = fused_mixer.mixer(x, consts)
        else:
            if self.use_mixer:
                x = self.block1(self.block0(self.to_feat(x)))
            x = self.up(x)
        x = self.tail(x)
        x = self.ref(x, ref_f1, ref_f2)
        h, w = disp.shape[2] * self.scale, disp.shape[3] * self.scale
        return resize_bilinear(disp, (h, w)) + x


class Upsample4(nn.Module):
    """x4 ESM upsampler, two x2 stages (``ESMStereo.py:242-318``)."""

    def __init__(self, f1_ch: int, f2_ch: int, f4_ch: int, device=None,
                 fuse_mixer: bool = False):
        super().__init__()
        self.stage2x = _UpStage(f2_ch, f1_ch, f2_ch, 32, 32, 16, 32, True,
                                device, fuse_mixer)
        self.stage4x = _UpStage(f4_ch, f2_ch, f4_ch, 32, 16, 16, 32, False,
                                device)

    def forward(self, f1x, f2x, f4x, init_disp):
        up2 = self.stage2x(init_disp, f2x, f1x, f2x)
        up4 = self.stage4x(up2, f4x, f2x, f4x)
        return up4, up2


class Upsample8(nn.Module):
    """x8 ESM upsampler, three x2 stages (``ESMStereo.py:320-428``). The
    inputs are, as the JAX model passes them, FeatUp's x16 (``f2x``) and x8
    (``f4x``), the backbone's x4 (``f8x``) and stem_2's map; it returns the
    disparities at x8, x4 and x2 of ``init_disp``'s resolution."""

    def __init__(self, f2_ch: int, f4_ch: int, f8_ch: int, stem_ch: int,
                 device=None):
        super().__init__()
        self.stage2x = _UpStage(f4_ch, f2_ch, f4_ch, 16, 16, 8, 16, True,
                                device)
        self.stage4x = _UpStage(f8_ch, f4_ch, f8_ch, 16, 8, 8, 16, False,
                                device)
        self.stage8x = _UpStage(stem_ch, f8_ch, stem_ch, 16, 8, 8, 16, False,
                                device)

    def forward(self, f2x, f4x, f8x, stem2, init_disp):
        up2 = self.stage2x(init_disp, f4x, f2x, f4x)
        up4 = self.stage4x(up2, f8x, f4x, f8x)
        up8 = self.stage8x(up4, stem2, f8x, stem2)
        return up8, up4, up2


class Upsample16(nn.Module):
    """x16 ESM upsampler, two x4 stages (``ESMStereo.py:430-509``). The
    inputs are, as the JAX model passes them, the backbone's x8 (``f1x``),
    ``conv_f2``'s x16 map (``f2x``), the backbone's x4 (``f4x``) and
    ``conv_f0``'s x2 map (``f8x``); it returns the disparities at x16 and
    x4 of ``init_disp``'s resolution. ``PhUpsample16``, the JAX default, is
    a phase re-layout of the same function; the port computes this one."""

    def __init__(self, f1_ch: int, f2_ch: int, f4_ch: int, f8_ch: int,
                 device=None):
        super().__init__()
        self.stage2x = _UpStage(f2_ch, f2_ch, f1_ch, 16, 16, 8, 16, True,
                                device, scale=4)
        self.stage4x = _UpStage(f4_ch, f4_ch, f8_ch, 16, 8, 8, 16, False,
                                device, scale=4)

    def forward(self, f1x, f2x, f4x, f8x, init_disp):
        up2 = self.stage2x(init_disp, f2x, f2x, f1x)
        up4 = self.stage4x(up2, f4x, f4x, f8x)
        return up4, up2


def _stem_agg_consts(model) -> dict:
    """Kernel C's weights: fp32 with BN folded, or the deploy forms' (bf16
    weights, fp32 BN scale and shift) for a bf16 model or an int8
    volume."""
    low = blocks.computes_bf16(model.agg) or model.volume_int8
    return fused_agg_stem.prepare_consts(model.volume_stem, model.agg,
                                         low_precision=low)


def _stems_consts(model) -> dict:
    """Kernel F's weights: fp32, or its deploy form's (bf16) at bf16."""
    return fused_stems.prepare_consts(
        model.stem_2, model.stem_4,
        low_precision=blocks.computes_bf16(model.stem_2))


# per cv_scale: stem widths (JAX esmstereo.py:517), the pyramid level and
# stem the descriptors take (:589), the hourglass's add_channel (:612)
STEM_CHS = {4: (32, 48), 8: (32, 48, 64), 16: (16, 24, 32, 40)}
MATCH_IDX = {4: (0, 1), 8: (1, 2), 16: (3, 3)}
ADD_CHANNEL = {4: 16, 8: 8, 16: 4}
# cv16's semantic attention: semantic_0's and semantic_1's widths (:613)
SEMANTIC_CHS = {"gwc": (64, 32), "norm_correlation": (32, 8)}


def conv3d_shapes(config: ESMStereoConfig, height: int, width: int) -> list:
    """(module, ci, co, d, h, w, stride) of each conv3d k3 p1 that kernels
    C, E's agg, G and H launch on a ``height`` x ``width`` frame (multiples
    of 32) of ``config``, at batch 1: the volume's first conv
    (``group_stem``, or ``corr_stem`` on the norm-correlation volume) and
    ``agg`` on the (G, D, H/v, W/v) volume, then the k3 s2 and the k3 s1
    conv of each level of ``Aggregation3D``. H's k3 convs have the shapes
    of levels 1 and 2's s1 convs, E's agg that of ``agg``. ``module`` names
    the ``ESMStereo`` submodule that holds the conv."""
    v = config.cv_scale
    d, h, w = config.max_disp // v, height // v, width // v
    red = config.reduction
    first = (("corr_stem", 1) if config.cost_volume == "norm_correlation"
             else ("group_stem", config.num_groups))
    out = [(*first, red, d, h, w, 1), ("agg", red, red, d, h, w, 1)]
    ci = red
    for k in (1, 2, 3):
        # Aggregation3D's c1, c2, c3
        co = red + (1 << (k - 1)) * ADD_CHANNEL[v]
        out.append((f"aggregation_out.conv{k}_0", ci, co, d, h, w, 2))
        d, h, w = ((n - 1) // 2 + 1 for n in (d, h, w))
        out.append((f"aggregation_out.conv{k}_1", co, co, d, h, w, 1))
        ci = co
    return out


class ESMStereo(nn.Module):
    """ESMStereo-L, -M or -S (``ESMStereo.py:511-745``, the cv4, cv8 and
    cv16 branches). It is built in eval mode.

    ``forward(left, right)`` takes NHWC images ``(B, H, W, 3)`` (H and W
    multiples of 32) and returns ``[disparity (B, H, W)]``; in training
    mode the disparity of every scale, full resolution first (cv4: full
    and 1/2; cv8: full, 1/2, 1/4; cv16: full and 1/4), each x4. With
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
        v = config.cv_scale
        self.feature = FeaturePyramid(config.backbone, device=dev)
        if v != 16:
            # cv16 takes the raw pyramid (JAX esmstereo.py:497-514)
            self.feature_up = FeatUp(chans, v, dev)
        stem_chs = STEM_CHS[v]
        for i, (cin, cout) in enumerate(zip((3, *stem_chs), stem_chs)):
            setattr(self, f"stem_{2 ** (i + 1)}", StemBlock(cin, cout, dev))
        feat_idx, stem_idx = MATCH_IDX[v]
        # FeatUp's map at /v has twice the pyramid's channels there; cv16
        # takes the pyramid's own /16 map
        feat_ch = chans[3] if v == 16 else 2 * chans[feat_idx + 1]
        match_in = feat_ch + stem_chs[stem_idx]
        self.conv = ConvBlock(match_in, 64, 3, 1, 1, device=dev)
        # the reference descriptor is a default nn.Conv2d, i.e. with a bias
        self.desc = TorchConv(64, 64, 1, 1, 0, use_bias=True, device=dev)
        red = config.reduction
        if v == 16:
            mid, out = SEMANTIC_CHS[config.cost_volume]
            self.semantic_0 = ConvBlock(chans[3], mid, 3, 1, 1, device=dev)
            self.semantic_1 = TorchConv(mid, out, 3, 1, 1, device=dev)
        if config.cost_volume == "norm_correlation":
            self.corr_stem = ConvBlock(1, red, 3, 1, 1, dims=3, device=dev)
        else:
            self.group_stem = ConvBlock(config.num_groups, red, 3, 1, 1,
                                        dims=3, device=dev)
        self.agg = ConvBlock(red, red, 3, 1, 1, dims=3, device=dev)
        self.aggregation_out = Aggregation3D(
            red, ADD_CHANNEL[v], dev, fuse_pairs=config.fuse_hourglass,
            fuse_up=config.fuse_hourglass_up)
        if v == 16:
            self.conv_f2 = ConvBlock(chans[3], 32, 3, 1, 1, device=dev)
            self.conv_f0 = ConvBlock(chans[0], 24, 3, 1, 1, device=dev)
            self.upsample_module = Upsample16(chans[2], 32, chans[1], 24, dev)
        elif v == 8:
            self.upsample_module = Upsample8(2 * chans[3], 2 * chans[2],
                                             chans[1], stem_chs[0], dev)
        else:
            self.upsample_module = Upsample4(2 * chans[2], 2 * chans[1],
                                             stem_chs[0], dev,
                                             fuse_mixer=config.fuse_mixer)
        if dev.type != "meta":
            init_model_(self, torch.Generator().manual_seed(seed))
        blocks.set_compute_dtype(self, config.torch_dtype)
        self.eval()

    @property
    def num_bins(self) -> int:
        return self.config.max_disp // self.config.cv_scale

    @property
    def volume_groups(self) -> int:
        """The volume's channels: 1 for norm-correlation, else the groups."""
        if self.config.cost_volume == "norm_correlation":
            return 1
        return self.config.num_groups

    @property
    def volume_int8(self) -> bool:
        """Whether group_stem + agg take the int8 volume: ``volume_int8``
        where a volume is stored before kernel C (not under
        ``fuse_volume_agg`` at cv4 and cv8, nor at cv16 with the
        norm-correlation volume, whose corr_stem and agg are plain)."""
        cfg = self.config
        if cfg.cv_scale == 16:
            return cfg.volume_int8 and cfg.cost_volume == "gwc"
        return cfg.volume_int8 and not cfg.fuse_volume_agg

    def stem_agg(self, volume: torch.Tensor, approx: bool) -> torch.Tensor:
        """group_stem (corr_stem) + agg on a stored volume: kernel C, in the
        model's dtype, or in its int8 form on the quantised volume; in
        training the two plain ConvBlocks, unquantised (JAX's train mode
        runs its plain convs, ``esmstereo_tpu/models/esmstereo.py:638``)."""
        if self.training:
            return self.agg(self.volume_stem(volume))
        consts = folded_once(self, _stem_agg_consts, self.volume_stem,
                             self.agg)
        if not self.volume_int8:
            return fused_agg_stem.stem_agg(volume, consts, approx)
        q, scale = fused_agg_stem.quantize_volume(volume)
        consts = fused_agg_stem.with_input_scale(
            consts, self.volume_stem.conv.weight, scale)
        return fused_agg_stem.stem_agg(
            q, consts, approx, out_dtype=self.config.torch_dtype or
            torch.float32)

    def correlation(self, match_l: torch.Tensor, match_r: torch.Tensor,
                    groups: int, normalize: bool) -> torch.Tensor:
        """The volume: kernel B, or in training its plain version (the
        ``ops.cost_volume`` functions), as JAX's train mode builds it in jnp
        (``esmstereo_tpu/models/esmstereo.py:630``)."""
        build = (correlation.correlation_volume_plain if self.training
                 else correlation.correlation_volume)
        return build(match_l, match_r, self.num_bins, groups,
                     normalize=normalize)

    @property
    def volume_stem(self) -> ConvBlock:
        """The volume's first 3-D conv: ``corr_stem`` or ``group_stem``."""
        if self.config.cost_volume == "norm_correlation":
            return self.corr_stem
        return self.group_stem

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                capture_internals: bool = False):
        cfg = self.config
        train = self.training
        v = cfg.cv_scale
        bsz = left.shape[0]
        both = torch.cat([left, right], dim=0).permute(0, 3, 1, 2).contiguous()
        f_both = self.feature(both)
        if v != 16:
            f_both = self.feature_up(f_both)
        approx = blocks.GELU_APPROXIMATE
        if cfg.fuse_stems and not train:
            # kernel F: each conv_down map stays in shared memory; stem_8
            # (and stem_16) run plain on F's stem_4, as in JAX
            # (esmstereo.py:568-572). Its deploy form takes the fp32 image
            # and writes bf16, as JAX casts F's outputs (:563-567)
            consts = folded_once(self, _stems_consts, self.stem_2,
                                 self.stem_4)
            stems = list(fused_stems.stems(both, consts, approx))
        else:
            stems = [self.stem_2(both)]
            stems.append(self.stem_4(stems[0]))
        for i in range(2, len(STEM_CHS[v])):
            stems.append(getattr(self, f"stem_{2 ** (i + 1)}")(stems[-1]))
        feat_idx, stem_idx = MATCH_IDX[v]
        m = self.desc(self.conv(torch.cat([f_both[feat_idx], stems[stem_idx]],
                                          dim=1)))
        match_l, match_r = m[:bsz], m[bsz:]
        fl = [f[:bsz] for f in f_both]

        norm = cfg.cost_volume == "norm_correlation"
        groups = self.volume_groups
        if v == 16:
            volume = self._cv16_volume(match_l, match_r, fl[3], approx)
        elif cfg.fuse_volume_agg and not train:
            # kernel E: the volume never reaches device memory
            consts = folded_once(self, _stem_agg_consts, self.volume_stem,
                                 self.agg)
            volume = fused_agg_stem.volume_stem_agg(
                match_l, match_r, consts, self.num_bins, groups, approx,
                normalize=norm)
        else:
            volume = self.stem_agg(
                self.correlation(match_l, match_r, groups, norm), approx)
        # (B, D, H/v, W/v); regression and the disparity stream are fp32
        # whatever the compute dtype (JAX esmstereo.py:769-774)
        cost = self.aggregation_out(volume)[:, 0]
        cost = cost.to(torch.promote_types(cost.dtype, torch.float32))

        if v == 4:
            init_pred = regression_topk(cost, 2)
            outs = self.upsample_module(fl[1], fl[0], stems[0][:bsz],
                                        init_pred)
        else:
            # the reference regresses the raw cost, with no softmax
            init_pred = disparity_regression(cost, self.num_bins)
            if v == 8:
                outs = self.upsample_module(fl[2], fl[1], fl[0],
                                            stems[0][:bsz], init_pred)
            else:
                outs = self.upsample_module(fl[2], self.conv_f2(fl[3]),
                                            fl[1], self.conv_f0(fl[0]),
                                            init_pred)
        # every scale in training (JAX's train_status), the full-res one
        # at eval
        result = [o[:, 0] * 4 for o in (outs if train else outs[:1])]
        if capture_internals:
            nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
            # keys and pyramid indices as the JAX model's aux dict
            aux = {"cost": cost, "init_pred": nhwc(init_pred),
                   "match_left": nhwc(match_l), "f16": nhwc(fl[3]),
                   "f4": nhwc(fl[1]), "disp_2": outs[1][:, 0]}
            return result, aux
        return result

    def _cv16_volume(self, match_l, match_r, f16, approx):
        """cv16's volume through group_stem/corr_stem and agg, with the
        semantic attention map of the /16 features multiplied in (in the
        compute dtype, as JAX's ``_mul_att_folded``): on the 32-group gwc
        volume before group_stem (kernel B, the multiply, then kernel C,
        which quantises the product with ``volume_int8``), or on
        corr_stem's 8 channels before agg (kernel B's normalised G = 1
        form, then plain ConvBlocks: JAX runs no kernel between them
        either, esmstereo.py:643,731-739)."""
        att = self.semantic_1(self.semantic_0(f16))[:, :, None]
        if self.config.cost_volume == "norm_correlation":
            volume = self.correlation(match_l, match_r, 1, True)
            return self.agg(self.corr_stem(volume) * att)
        volume = self.correlation(match_l, match_r, self.config.num_groups,
                                  False)
        return self.stem_agg(volume * att, approx)
