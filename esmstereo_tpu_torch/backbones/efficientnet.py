"""EfficientNet-family feature pyramid (NCHW).

Counterpart of ``esmstereo_tpu/backbones/efficientnet.py``: its own copy of
the architecture tables (``:38-93``) and the timm-style blocks
(``:188-297``). Names follow timm's layout (``conv_stem``, ``bn1``,
``blocks_{stage}_{index}.conv_dw`` ...), as in the JAX package.

The stem activation is ReLU6 on both backbones (the reference swaps it
in, ``ESMStereo.py:51,60``); the blocks use the arch's activation (SiLU on
efficientnet_b2). In eval mode the stem and stage 0 run as one fused
operation (``backbones.fused``, kernel A of ``ops.kernels.fused_head``),
which takes efficientnet_b2 only; the plain modules run in training mode.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from esmstereo_tpu_torch.backbones import fused
from esmstereo_tpu_torch.nn.blocks import TorchConv, apply_act, batch_norm


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str          # 'ds' (depthwise-separable) or 'ir' (inverted residual)
    out_chs: int
    kernel: int
    stride: int
    expand: int = 6
    se_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    stem_chs: int
    act: str
    stages: tuple[tuple[BlockCfg, ...], ...]
    chans: tuple[int, ...]  # pyramid channels at /2 /4 /8 /16 /32


def _stage(cfg: BlockCfg, repeats: int) -> tuple[BlockCfg, ...]:
    return (cfg,) + tuple(dataclasses.replace(cfg, stride=1)
                          for _ in range(repeats - 1))


MOBILENETV2_100 = ArchCfg(
    stem_chs=32,
    act="relu6",
    stages=(
        _stage(BlockCfg("ds", 16, 3, 1, 1), 1),
        _stage(BlockCfg("ir", 24, 3, 2), 2),
        _stage(BlockCfg("ir", 32, 3, 2), 3),
        _stage(BlockCfg("ir", 64, 3, 2), 4),
        _stage(BlockCfg("ir", 96, 3, 1), 3),
        _stage(BlockCfg("ir", 160, 3, 2), 3),
    ),
    chans=(16, 24, 32, 96, 160),
)

EFFICIENTNET_B2 = ArchCfg(
    stem_chs=32,
    act="silu",
    stages=(
        _stage(BlockCfg("ds", 16, 3, 1, 1, se_ratio=0.25), 2),
        _stage(BlockCfg("ir", 24, 3, 2, se_ratio=0.25), 3),
        _stage(BlockCfg("ir", 48, 5, 2, se_ratio=0.25), 3),
        _stage(BlockCfg("ir", 88, 3, 2, se_ratio=0.25), 4),
        _stage(BlockCfg("ir", 120, 5, 1, se_ratio=0.25), 4),
        _stage(BlockCfg("ir", 208, 5, 2, se_ratio=0.25), 5),
    ),
    chans=(16, 24, 48, 120, 208),
)

ARCHS = {
    "mobilenetv2_100": MOBILENETV2_100,
    "efficientnet_b2": EFFICIENTNET_B2,
}


def _se_reduced(in_chs: int, ratio: float) -> int:
    return max(1, int(in_chs * ratio))


class SqueezeExcite(nn.Module):
    """Global mean -> 1x1 reduce -> act -> 1x1 expand -> sigmoid gate."""

    def __init__(self, chs: int, reduced_chs: int, act: str, device=None):
        super().__init__()
        self.act = act
        self.conv_reduce = TorchConv(chs, reduced_chs, 1, use_bias=True,
                                     init_mode="msra", device=device)
        self.conv_expand = TorchConv(reduced_chs, chs, 1, use_bias=True,
                                     init_mode="msra", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = x.mean(dim=(2, 3), keepdim=True)
        gate = apply_act(self.conv_reduce(gate), self.act)
        return x * torch.sigmoid(self.conv_expand(gate))


class DepthwiseSeparable(nn.Module):
    """timm DepthwiseSeparableConv: dw -> bn -> act [-> se] -> pw -> bn."""

    def __init__(self, cfg: BlockCfg, in_chs: int, act: str, device=None):
        super().__init__()
        self.act = act
        self.residual = cfg.stride == 1 and in_chs == cfg.out_chs
        self.conv_dw = TorchConv(in_chs, in_chs, cfg.kernel, cfg.stride,
                                 cfg.kernel // 2, groups=in_chs,
                                 init_mode="msra", device=device)
        self.bn1 = batch_norm(in_chs, device=device)
        self.se = (SqueezeExcite(in_chs, _se_reduced(in_chs, cfg.se_ratio),
                                 act, device) if cfg.se_ratio > 0 else None)
        self.conv_pw = TorchConv(in_chs, cfg.out_chs, 1, init_mode="msra",
                                 device=device)
        self.bn2 = batch_norm(cfg.out_chs, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = apply_act(self.bn1(self.conv_dw(x)), self.act)
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pw(x))
        return x + shortcut if self.residual else x


class InvertedResidual(nn.Module):
    """timm InvertedResidual: pw-expand -> dw -> [se] -> pw-linear, residual."""

    def __init__(self, cfg: BlockCfg, in_chs: int, act: str, device=None):
        super().__init__()
        self.act = act
        self.residual = cfg.stride == 1 and in_chs == cfg.out_chs
        mid = in_chs * cfg.expand
        self.conv_pw = TorchConv(in_chs, mid, 1, init_mode="msra",
                                 device=device)
        self.bn1 = batch_norm(mid, device=device)
        self.conv_dw = TorchConv(mid, mid, cfg.kernel, cfg.stride,
                                 cfg.kernel // 2, groups=mid,
                                 init_mode="msra", device=device)
        self.bn2 = batch_norm(mid, device=device)
        # SE width follows the block INPUT channels (timm's rule)
        self.se = (SqueezeExcite(mid, _se_reduced(in_chs, cfg.se_ratio),
                                 act, device) if cfg.se_ratio > 0 else None)
        self.conv_pwl = TorchConv(mid, cfg.out_chs, 1, init_mode="msra",
                                  device=device)
        self.bn3 = batch_norm(cfg.out_chs, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = apply_act(self.bn1(self.conv_pw(x)), self.act)
        x = apply_act(self.bn2(self.conv_dw(x)), self.act)
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        return x + shortcut if self.residual else x


class FeaturePyramid(nn.Module):
    """Five-level pyramid ``[x2, x4, x8, x16, x32]`` (taps after stages
    0, 1, 2, 4 and 5, as the reference's ``Feature`` module slices them)."""

    def __init__(self, arch: str = "efficientnet_b2", in_chs: int = 3,
                 device=None):
        super().__init__()
        cfg = ARCHS[arch]
        self.arch = arch
        self.cfg = cfg
        self.chans = cfg.chans
        self.conv_stem = TorchConv(in_chs, cfg.stem_chs, 3, 2, 1,
                                   init_mode="msra", device=device)
        self.bn1 = batch_norm(cfg.stem_chs, device=device)
        self.block_names: list[list[str]] = []
        cin = cfg.stem_chs
        for si, stage in enumerate(cfg.stages):
            names = []
            for bi, bcfg in enumerate(stage):
                cls = (DepthwiseSeparable if bcfg.kind == "ds"
                       else InvertedResidual)
                name = f"blocks_{si}_{bi}"
                self.add_module(name, cls(bcfg, cin, cfg.act, device))
                names.append(name)
                cin = bcfg.out_chs
            self.block_names.append(names)

    def _run_stage(self, si: int, x: torch.Tensor) -> torch.Tensor:
        for name in self.block_names[si]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.training:
            x = torch.clamp(self.bn1(self.conv_stem(x)), 0.0, 6.0)
            x = self._run_stage(0, x)
        else:
            x = fused.fused_head(self, x)
        feats = [x]
        for si in range(1, len(self.cfg.stages)):
            x = self._run_stage(si, x)
            if si in (1, 2, 4, 5):
                feats.append(x)
        return feats
