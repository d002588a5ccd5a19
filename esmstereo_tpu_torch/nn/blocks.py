"""Core building blocks (NCHW / NCDHW).

Counterpart of ``esmstereo_tpu/nn/blocks.py``: conv/deconv + BatchNorm +
GELU units, the upsample-and-fuse ``Conv2x`` and the strided ``StemBlock``.
Parameter names follow the JAX package's tree (``conv``, ``bn``,
``conv_down``, ...) so that ``models.convert_jax`` maps weights by path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esmstereo_tpu_torch.nn import init as tinit
from esmstereo_tpu_torch.ops.kernels.activations import gelu
from esmstereo_tpu_torch.ops.sampling import resize_nearest

# Global numerics switch, as in the JAX package: exact-erf GELU (the
# reference's nn.GELU()) unless set_gelu_approximate(True) selects the tanh
# form. The cost-volume kernel (ops.kernels.fused_agg_stem) reads it too.
GELU_APPROXIMATE = False


def set_gelu_approximate(enabled: bool) -> None:
    global GELU_APPROXIMATE
    GELU_APPROXIMATE = bool(enabled)


def apply_act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "gelu":
        return gelu(x, GELU_APPROXIMATE)
    if act == "relu":
        return F.relu(x)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "silu":
        return F.silu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {act!r}")


def _tuple(v, n: int) -> tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(v)
    return (v,) * n


class TorchConv(nn.Module):
    """Convolution with symmetric padding and the JAX package's init rules.

    ``init_mode``: ``'torch'`` (torch Conv default) or ``'msra'`` (the
    reference's Normal(0, sqrt(2/n_out))). Weight ``(out, in/groups, *k)``.
    """

    def __init__(self, in_ch: int, features: int, kernel_size, stride=1,
                 padding=0, dilation=1, groups: int = 1,
                 use_bias: bool = False, dims: int = 2,
                 init_mode: str = "torch", device=None):
        super().__init__()
        if dims not in (2, 3):
            raise ValueError(f"dims={dims}")
        if init_mode not in ("torch", "msra"):
            raise ValueError(f"init_mode={init_mode!r}")
        self.dims = dims
        self.stride = _tuple(stride, dims)
        self.padding = _tuple(padding, dims)
        self.dilation = _tuple(dilation, dims)
        self.groups = groups
        self.init_mode = init_mode
        ks = _tuple(kernel_size, dims)
        self.weight = nn.Parameter(torch.empty(
            (features, in_ch // groups, *ks), device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)

    def reset_parameters_from(self, gen: torch.Generator) -> None:
        if self.init_mode == "msra":
            tinit.msra_out_(self.weight, gen)
        else:
            tinit.torch_conv_(self.weight, gen)
        if self.bias is not None:
            tinit.uniform_(self.bias, tinit.conv_fan_in(self.weight), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if self.dims == 2 else F.conv3d
        return conv(x, self.weight, self.bias, self.stride, self.padding,
                    self.dilation, self.groups)


class TorchConvTranspose(nn.Module):
    """Transposed convolution with torch output arithmetic
    ``(i-1)*stride - 2*padding + kernel``; weight ``(in, out, *k)``.

    The JAX package runs it as an input-dilated conv with a spatially
    flipped kernel (``nn/blocks.py:147``); torch's transposed conv computes
    the same function from the unflipped kernel, so the bridge transposes
    the axes and flips nothing.
    """

    def __init__(self, in_ch: int, features: int, kernel_size, stride=2,
                 padding=1, use_bias: bool = False, dims: int = 2,
                 device=None):
        super().__init__()
        if dims not in (2, 3):
            raise ValueError(f"dims={dims}")
        self.dims = dims
        self.stride = _tuple(stride, dims)
        self.padding = _tuple(padding, dims)
        ks = _tuple(kernel_size, dims)
        self.weight = nn.Parameter(torch.empty((in_ch, features, *ks),
                                               device=device))
        self.bias = (nn.Parameter(torch.empty((features,), device=device))
                     if use_bias else None)

    def reset_parameters_from(self, gen: torch.Generator) -> None:
        fan_in = tinit.deconv_fan_in(self.weight)
        tinit.uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            tinit.uniform_(self.bias, fan_in, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv = F.conv_transpose2d if self.dims == 2 else F.conv_transpose3d
        return deconv(x, self.weight, self.bias, self.stride, self.padding)


def batch_norm(features: int, dims: int = 2, device=None) -> nn.Module:
    """BatchNorm with the reference's eps 1e-5 and torch momentum 0.1."""
    cls = nn.BatchNorm2d if dims == 2 else nn.BatchNorm3d
    return cls(features, eps=1e-5, momentum=0.1, device=device)


def fold_bn(weight: torch.Tensor, bn: nn.Module
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conv weight ``(O, ...)`` and an eval BatchNorm -> (the weight with the
    BN scale folded in, the per-channel offset)."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shape = (-1,) + (1,) * (weight.ndim - 1)
    return weight * inv.view(shape), bn.bias - bn.running_mean * inv


def folded_once(owner: nn.Module, fold, *sources: nn.Module):
    """``fold(owner)``: eval-mode constants derived from the parameters and
    buffers of ``sources`` (BN folded into conv weights, packed kernel
    arguments), memoised on ``owner``. They are computed again only when one
    of those tensors is replaced or changed in place (``load_state_dict``,
    ``.to``), so a frame pays for no folding. ``fold`` must be a function
    defined once (it keys the memo), not a fresh lambda."""
    tensors = [t for m in sources for t in (*m.parameters(), *m.buffers())]
    if any(t.is_inference() for t in tensors):
        return fold(owner)     # inference tensors keep no version counter
    key = tuple((id(t), t.data_ptr(), t._version) for t in tensors)
    memo = owner.__dict__.setdefault("_folded", {})
    hit = memo.get(fold)
    if hit is None or hit[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            hit = memo[fold] = (key, fold(owner))
    return hit[1]


class ConvBlock(nn.Module):
    """conv/deconv -> optional BatchNorm -> optional activation (2-D or 3-D).

    The reference ``BasicConv``: bias-free conv, BN, exact GELU.
    """

    def __init__(self, in_ch: int, features: int, kernel_size, stride=1,
                 padding=0, dilation=1, deconv: bool = False, dims: int = 2,
                 bn: bool = True, act: str | None = "gelu",
                 init_mode: str = "torch", device=None):
        super().__init__()
        if deconv:
            self.conv = TorchConvTranspose(in_ch, features, kernel_size,
                                           stride, padding, dims=dims,
                                           device=device)
        else:
            self.conv = TorchConv(in_ch, features, kernel_size, stride,
                                  padding, dilation, dims=dims,
                                  init_mode=init_mode, device=device)
        self.bn = batch_norm(features, dims, device) if bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return apply_act(x, self.act)


class Conv2x(nn.Module):
    """Upsample ``x`` by 2 with a k4 s2 deconv, align it to ``rem``,
    concatenate and convolve; ``2 * features`` channels out.

    The reference's ``Conv2x(deconv=True, concat=True)``, the only
    configuration ``FeatUp`` builds (``submodule.py:64-103``).
    """

    def __init__(self, in_ch: int, rem_ch: int, features: int, device=None):
        super().__init__()
        self.conv1 = ConvBlock(in_ch, features, 4, 2, 1, deconv=True,
                               device=device)
        self.conv2 = ConvBlock(features + rem_ch, 2 * features, 3, 1, 1,
                               init_mode="msra", device=device)

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        if x.shape[2:] != rem.shape[2:]:
            x = resize_nearest(x, (rem.shape[2], rem.shape[3]))
        return self.conv2(torch.cat([x, rem], dim=1))


class StemBlock(nn.Module):
    """Strided stem: ConvBlock(k3 s2) -> conv3x3 -> BN -> ReLU
    (the reference's ``stem_*`` sequentials, ``ESMStereo.py:529-583``)."""

    def __init__(self, in_ch: int, features: int, device=None):
        super().__init__()
        self.conv_down = ConvBlock(in_ch, features, 3, 2, 1, device=device)
        self.conv = TorchConv(features, features, 3, 1, 1, device=device)
        self.bn = batch_norm(features, 2, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_down(x)
        return F.relu(self.bn(self.conv(x)))
