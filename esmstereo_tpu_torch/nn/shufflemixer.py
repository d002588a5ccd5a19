"""ShuffleMixer feature-mixing blocks (NCHW).

Counterpart of ``esmstereo_tpu/nn/shufflemixer.py:49-214``: channel-split
point MLPs with a g=8 channel shuffle, a bias-free channel LayerNorm,
depthwise spatial mixing, the FMBlock of the ESM upsampler and the
conv + pixel-shuffle + SiLU up-sampler. The JAX package runs
``PixelShuffleUp`` as an equivalent transposed conv for the TPU; the port
computes the plain conv and depth-to-space.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esmstereo_tpu_torch.nn.blocks import TorchConv
from esmstereo_tpu_torch.ops.sampling import pixel_shuffle


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis (dim 1): biased variance, eps 1e-5,
    weight only."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.weight.view(1, -1, 1, 1)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Rearrange channels ``(g d) -> (d g)`` (``shufflemixer.py:37``)."""
    b, c, h, w = x.shape
    return (x.view(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class SplitPointMlp(nn.Module):
    """Half-channel point MLP, then a g=8 channel shuffle."""

    def __init__(self, dim: int, mlp_ratio: int = 2, device=None):
        super().__init__()
        half = dim // 2
        self.half = half
        self.fc1 = TorchConv(half, half * mlp_ratio, 1, use_bias=True,
                             device=device)
        self.fc2 = TorchConv(half * mlp_ratio, half, 1, use_bias=True,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[:, :self.half], x[:, self.half:]
        x1 = self.fc2(F.silu(self.fc1(x1)))
        return channel_shuffle(torch.cat([x1, x2], dim=1), 8)


class SMLayer(nn.Module):
    """MLP -> depthwise k x k conv -> MLP, with pre-norms and residuals
    around the MLPs only."""

    def __init__(self, dim: int, kernel_size: int = 7, mlp_ratio: int = 2,
                 device=None):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, device)
        self.mlp1 = SplitPointMlp(dim, mlp_ratio, device)
        self.spatial = TorchConv(dim, dim, kernel_size, 1, kernel_size // 2,
                                 groups=dim, use_bias=True, device=device)
        self.norm2 = ChannelLayerNorm(dim, device)
        self.mlp2 = SplitPointMlp(dim, mlp_ratio, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlp1(self.norm1(x)) + x
        x = self.spatial(x)
        return self.mlp2(self.norm2(x)) + x


class FMBlock(nn.Module):
    """Two SMLayers and a conv-SiLU bottleneck, both residual."""

    def __init__(self, dim: int, kernel_size: int = 7, mlp_ratio: int = 2,
                 device=None):
        super().__init__()
        self.sm1 = SMLayer(dim, kernel_size, mlp_ratio, device)
        self.sm2 = SMLayer(dim, kernel_size, mlp_ratio, device)
        self.conv_expand = TorchConv(dim, dim + 16, 3, 1, 1, use_bias=True,
                                     device=device)
        self.conv_project = TorchConv(dim + 16, dim, 1, use_bias=True,
                                      device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.sm2(self.sm1(x)) + x
        return self.conv_project(F.silu(self.conv_expand(x))) + x


class PixelShuffleUp(nn.Module):
    """1x1 conv (with bias) -> PixelShuffle(r) -> SiLU."""

    def __init__(self, in_ch: int, dim: int, factor: int = 2, device=None):
        super().__init__()
        self.factor = factor
        self.conv = TorchConv(in_ch, dim * factor * factor, 1,
                              use_bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(pixel_shuffle(self.conv(x), self.factor))
