"""Core building blocks (NCHW / NCDHW).

Counterpart of ``esmstereo_tpu/nn/blocks.py``: conv/deconv + BatchNorm +
GELU units, the upsample-and-fuse ``Conv2x`` and the strided ``StemBlock``.
Parameter names follow the JAX package's tree (``conv``, ``bn``,
``conv_down``, ...) so that ``models.convert_jax`` maps weights by path.

Compute dtype (``set_compute_dtype``), after flax's ``dtype=bfloat16``
with fp32 ``param_dtype``: parameters and BN statistics stay fp32; each
``TorchConv`` / ``TorchConvTranspose`` casts its input, weight and bias to
the compute dtype, cuDNN accumulates in fp32 and returns that dtype, and
the bias is added after, in that dtype, as ``flax.linen.Conv`` adds it
(two roundings, not one).
BatchNorm follows flax 0.12.3's ``linen/normalization.py::_normalize``:
``y = x - mean`` promotes the bf16 input to the fp32 statistics, then
``y *= rsqrt(var + eps) * scale`` and ``y += bias`` run in fp32, and only
the result is cast to the compute dtype. torch's eval BatchNorm on a bf16
input with fp32 parameters computes the same in fp32 and returns bf16, so
the module needs no cast of its own. Activations (``gelu``, ``silu``,
``sigmoid``, ``softmax``) run on the tensor they get, in torch's
functions, which evaluate a bf16 tensor in fp32 and round once (as XLA's
fusions may with their default excess precision). With
``set_bf16_per_op(True)`` a bf16 tensor's activation follows ``jax.nn``'s
formula instead, rounding after every op as the JAX reference compiled
with ``xla_allow_excess_precision=False`` does, in one launch of
``ops.kernels.activations.activation_bf16`` (its plain version on the
CPU). The served mode stays torch's: per op, L-deploy's chaotic cv4
disparity moved past its JAX test on the tests' draw (ROADMAP §3 item 1);
tests/test_torch_deploy_variants.py holds both modes against JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esmstereo_tpu_torch.nn import init as tinit
from esmstereo_tpu_torch.ops.kernels import activations
from esmstereo_tpu_torch.ops.sampling import resize_nearest

# Global numerics switch, as in the JAX package: exact-erf GELU (the
# reference's nn.GELU()) unless set_gelu_approximate(True) selects the tanh
# form. The cost-volume kernel (ops.kernels.fused_agg_stem) reads it too.
GELU_APPROXIMATE = False


def set_gelu_approximate(enabled: bool) -> None:
    global GELU_APPROXIMATE
    GELU_APPROXIMATE = bool(enabled)


# Off: bf16 activations in torch's functions, rounding once (the served
# mode); on: per op, as jax.nn compiled without excess precision.
BF16_PER_OP = False


def set_bf16_per_op(enabled: bool) -> None:
    global BF16_PER_OP
    BF16_PER_OP = bool(enabled)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None) -> None:
    """Give every module of ``model`` that has a ``compute_dtype`` (convs,
    the channel LayerNorm, the feature pyramid) the compute dtype ``dtype``;
    ``None`` is fp32 with no casts at all. Every ``folded_once`` memo is
    dropped, since folds may depend on the dtype."""
    for m in model.modules():
        m.__dict__.pop("_folded", None)
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


def computes_bf16(module: nn.Module) -> bool:
    """Whether ``module`` computes in bf16 (``set_compute_dtype``; the
    deploy numerics): the one rule by which the model picks a kernel's
    deploy form for the modules the kernel replaces."""
    return any(getattr(m, "compute_dtype", None) == torch.bfloat16
               for m in module.modules())


def _per_op(x: torch.Tensor) -> bool:
    return BF16_PER_OP and x.dtype == torch.bfloat16


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU, tanh form with ``approximate``."""
    if _per_op(x):
        return activations.activation_bf16(
            x.contiguous(), "gelu_tanh" if approximate else "gelu_erf")
    return activations.gelu(x, approximate)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU."""
    if _per_op(x):
        return activations.activation_bf16(x.contiguous(), "silu")
    return F.silu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function."""
    if _per_op(x):
        return activations.activation_bf16(x.contiguous(), "sigmoid")
    return torch.sigmoid(x)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax over ``dim``."""
    if _per_op(x):
        return activations.activation_bf16(x.contiguous(), "softmax", dim)
    return torch.softmax(x, dim=dim)


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
        return silu(x)
    if act == "sigmoid":
        return sigmoid(x)
    raise ValueError(f"unknown activation {act!r}")


def _tuple(v, n: int) -> tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(v)
    return (v,) * n


def _cast_params(conv: nn.Module):
    dt = conv.compute_dtype
    return (conv.weight.to(dt),
            None if conv.bias is None else conv.bias.to(dt))


def _cast(conv: nn.Module, x: torch.Tensor):
    """``(x, weight, bias)`` of a conv in its compute dtype: the input cast,
    the parameters' casts memoised (``folded_once``), so a frame casts no
    weight. Where autograd records (a training step) the casts are made
    afresh, so that the gradient reaches the fp32 parameters."""
    if conv.compute_dtype is None:
        return x, conv.weight, conv.bias
    if torch.is_grad_enabled() and conv.weight.requires_grad:
        w, b = _cast_params(conv)
    else:
        w, b = folded_once(conv, _cast_params, conv)
    return x.to(conv.compute_dtype), w, b


class TorchConv(nn.Module):
    """Convolution with symmetric padding and the JAX package's init rules.

    ``init_mode``: ``'torch'`` (torch Conv default) or ``'msra'`` (the
    reference's Normal(0, sqrt(2/n_out))). Weight ``(out, in/groups, *k)``.
    """

    compute_dtype = None

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
        x, w, b = _cast(self, x)
        if self.compute_dtype is None:
            return conv(x, w, b, self.stride, self.padding, self.dilation,
                        self.groups)
        y = conv(x, w, None, self.stride, self.padding, self.dilation,
                 self.groups)
        return y if b is None else y + b.view(-1, *(1,) * self.dims)


class TorchConvTranspose(nn.Module):
    """Transposed convolution with torch output arithmetic
    ``(i-1)*stride - 2*padding + kernel``; weight ``(in, out, *k)``.

    The JAX package runs it as an input-dilated conv with a spatially
    flipped kernel (``nn/blocks.py:147``); torch's transposed conv computes
    the same function from the unflipped kernel, so the bridge transposes
    the axes and flips nothing.
    """

    compute_dtype = None

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
        x, w, b = _cast(self, x)
        if self.compute_dtype is None:
            return deconv(x, w, b, self.stride, self.padding)
        y = deconv(x, w, None, self.stride, self.padding)
        return y if b is None else y + b.view(-1, *(1,) * self.dims)


class _FlaxStatistics:
    """Training mode with flax's running-statistics rule
    (``flax/linen/normalization.py:142,404`` in flax 0.12.3): the batch is
    normalised with its biased variance, as torch does, and the running
    variance also moves towards the biased one, where torch's moves towards
    the unbiased one (n/(n-1) larger: 6% with 16 values per channel).
    Eval mode is torch's BatchNorm as it is. torch's momentum 0.1 is flax's
    0.9."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        n = x.numel() // x.shape[1]
        # torch's update goes to copies (autograd keeps them for the
        # backward pass, so they are not changed after it)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            # torch added momentum * unbiased var; flax adds the biased one
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStatistics, nn.BatchNorm3d):
    pass


def batch_norm(features: int, dims: int = 2, device=None) -> nn.Module:
    """BatchNorm with the reference's eps 1e-5 and torch momentum 0.1, and
    flax's running variance in training (``_FlaxStatistics``)."""
    cls = BatchNorm2d if dims == 2 else BatchNorm3d
    return cls(features, eps=1e-5, momentum=0.1, device=device)


def fold_bn(weight: torch.Tensor, bn: nn.Module, axis: int = 0
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conv weight with its output channels on ``axis`` (0 for a conv's
    ``(O, I, ...)``, 1 for a transposed conv's ``(I, O, ...)``) and an eval
    BatchNorm -> (the weight with the BN scale folded in, the per-channel
    offset)."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shape = [1] * weight.ndim
    shape[axis] = -1
    return weight * inv.view(shape), bn.bias - bn.running_mean * inv


def bn_scale_shift(bn: nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """An eval BatchNorm as ``y = x * scale + shift``, in JAX's order
    (``esmstereo_tpu/ops/pallas/fused_agg_stem.py:42-48``): the deploy
    forms of the kernels apply it after their fp32 sums."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return inv, bn.bias - bn.running_mean * inv


def folded_once(owner: nn.Module, fold, *sources: nn.Module):
    """``fold(owner)``: eval-mode constants derived from the parameters and
    buffers of ``sources`` (BN folded into conv weights, packed kernel
    arguments), memoised on ``owner``. They are computed again only when one
    of those tensors is replaced or changed in place (``load_state_dict``,
    ``.to``), so a frame pays for no folding. ``fold`` must be a function
    defined once (it keys the memo), not a fresh lambda. While a graph is
    traced (``torch.export``, ``torch.compile``) the fold is computed
    without the memo, as part of the graph: a traced tensor has no storage
    whose address could key it."""
    if torch.compiler.is_compiling():
        return fold(owner)
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
