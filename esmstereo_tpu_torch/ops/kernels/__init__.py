"""Hand-written CUDA kernels of the eval paths of ESMStereo-L, -M and -S
(gwc and norm-correlation volumes) and the confidence model, and of the
backbone stages after stage 0, each beside its plain PyTorch version, with
the forms each wrapper takes:

  * ``fused_head.fused_stage0``         kernel A, backbone stem + stage 0, in
    two layouts (``fused_head.FORMS``): efficientnet_b2's (two blocks with
    SqueezeExcite, SiLU; one cooperative launch with grid barriers at the
    SE means) and mobilenetv2_100's (one block, no SE, ReLU6; one launch);
    fp32 inside, fp32 or bf16 out; laid out by ``fused_head.stage0_plan``
  * ``correlation.correlation_volume``  kernels B and D, the correlation
    volume (gwc, gwc_norm, norm-correlation) from 64-channel descriptors,
    any number of bins; fp32, and each form on bf16 descriptors in B's
    rounding (products rounded to bf16, the model's deploy forms) or in
    D's (one rounding at the store)
  * ``fused_agg_stem.stem_agg``         kernel C, group_stem (corr_stem) + agg
    3-D convs, G = 32 or 1 volume channels, any depth; fp32, and on a bf16
    or int8 volume with bf16 operands (the deploy forms)
  * ``fused_agg_stem.volume_stem_agg``  kernel E, B + C with the volume built
    inside group_stem (``fuse_volume_agg``; cv4 and cv8 only); fp32, and
    on bf16 descriptors as B's bf16 form followed by C's
  * ``fused_hourglass.down_pair``       kernel G, one hourglass down level
    (``fuse_hourglass``), any number of output channels (tiled by 8, the
    last tile masked: L's 24/40/72, M's 16/24/40, S's 12/16/24); fp32 and
    bf16
  * ``fused_hourglass.up_pair``         kernel H, one hourglass up level
    (``fuse_hourglass_up``): fp32 by the same channel rule, at most 128;
    bf16 at the up levels' widths of L, M and S (``up_plan``)
  * ``fused_stems.stems``               kernel F, stem_2 + stem_4
    (``fuse_stems``), at the widths ``fused_stems.WIDTHS``: (32, 48) for L
    and M, (16, 24) for S; fp32, and the deploy form (bf16 operands, bf16
    out)
  * ``fused_mixer.mixer``               kernel I, the cv4 upsampler's
    ShuffleMixer section (``fuse_mixer``; L only); fp32 and bf16; one
    cooperative launch of seven phases, laid out by
    ``fused_mixer.mixer_plan``
  * ``fused_stage.fused_stage``         kernel J, one whole backbone stage
    >= 1 (expand, k3 or k5 depthwise at stride 1 or 2, SqueezeExcite or
    none, project, residual) of either backbone; fp32. No model path runs
    it: ``backbones.fused_stage.run_stage`` drives it stage by stage, as
    the JAX package drives its kernel
  * ``activations.activation_bf16``     no TPU kernel: a bf16 tensor's
    GELU (tanh, erf), SiLU, sigmoid or softmax as ``jax.nn`` writes it,
    rounding after every op (XLA's roundings without excess precision), in
    one launch; the model takes it under ``nn.blocks.set_bf16_per_op(True)``
    (forms by activation name)

Each deploy form rounds its operands to bf16 where the TPU kernel does,
sums in fp32 and applies BN after the fp32 sum.

Kernels C, E, G and H share one conv3d k3 p1 (``fused_hourglass.
conv3d_bn_gelu`` in fp32, ``conv3d_bn_gelu_bf16`` in the deploy forms; C
calls them on both devices, E, G and H on CUDA tensors only, taking their
own plain versions on the CPU), laid out per shape by
``fused_hourglass.conv_plan``; its wrappers (``conv_wrappers``) count
their launches too, by form and by shape.

Kernel A, kernel B and the shared conv are PyTorch operators
(``torch_ops.py``: ``esmstereo::fused_stage0``, ``::correlation_volume``,
``::conv3d_bn_gelu``, ``::conv3d_bn_gelu_bf16``), which their wrappers
call on both devices: the CPU kernel of each is the plain version, the
CUDA kernel launches the hand kernel, so that ``torch.export`` holds the
launches of an eval frame (``export/program.py``). The other kernels
launch through ``ctypes``. Kernel
H's deploy form launches two kernels a call, ``fused_hourglass.up_cat_bf16``
(its transposed and 1x1x1 convs, on CUDA tensors only) and then the shared
conv; ``step_wrappers`` counts the first. Kernel E's normalised form
launches ``correlation.l2_normalize_pair`` before its kernel, which
``step_wrappers`` counts too; kernels B and D normalise inside their one
launch.

A wrapper runs the plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device, raising on anything the
kernel does not take (a dtype outside the wrapper's list among them); it
never falls back. The kernels are eval-only, as the Pallas kernels are
(``pallas_call`` has no AD rule): a kernel's output has no ``grad_fn``, so
a wrapper about to launch one raises when grad mode is on and any of its
inputs requires grad (``refuse_autograd``), where a training forward would
otherwise detach silently. The model's training mode takes the plain
modules at every kernel site; eval runs under ``torch.inference_mode()``
or ``torch.no_grad()``. ``wrapper.launches`` counts the calls that launched the
kernel, and ``wrapper.form_launches`` the same by form (``"fp32"``,
``"bf16"``, ``"int8"``; kernel B's ``correlation.volume_form`` names).

Kernels launch on the current stream and allocate nothing; the wrappers
allocate outputs and scratch with ``torch.empty``. Scratch that goes out of
scope right after a launch is safe to free, because PyTorch's caching
allocator hands the memory out again only in that stream's order.
"""

from __future__ import annotations

import torch


def wrappers() -> dict:
    """``{kernel name: wrapper}`` for the port's kernels."""
    from esmstereo_tpu_torch.ops.kernels import activations
    from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem
    from esmstereo_tpu_torch.ops.kernels import fused_head, fused_hourglass
    from esmstereo_tpu_torch.ops.kernels import fused_mixer, fused_stage
    from esmstereo_tpu_torch.ops.kernels import fused_stems

    return {"fused_stage0": fused_head.fused_stage0,
            "correlation_volume": correlation.correlation_volume,
            "stem_agg": fused_agg_stem.stem_agg,
            "volume_stem_agg": fused_agg_stem.volume_stem_agg,
            "down_pair": fused_hourglass.down_pair,
            "up_pair": fused_hourglass.up_pair,
            "stems": fused_stems.stems,
            "mixer": fused_mixer.mixer,
            "fused_stage": fused_stage.fused_stage,
            "activation_bf16": activations.activation_bf16}


def conv_wrappers() -> dict:
    """``{name: wrapper}`` of the hourglass conv3d k3 p1 that kernels C,
    E, G and H launch (``fused_hourglass``): each counts its launches, by
    form, and by shape in ``shape_launches``."""
    from esmstereo_tpu_torch.ops.kernels import fused_hourglass

    return {"conv3d": fused_hourglass.conv3d_bn_gelu,
            "conv3d_bf16": fused_hourglass.conv3d_bn_gelu_bf16}


def step_wrappers() -> dict:
    """``{name: wrapper}`` of the launches inside another wrapper's call
    that count on their own: kernel H's fused transposed + 1x1x1 conv in
    its deploy form, one a bf16 ``up_pair`` call; the normalisation of
    kernel E's normalised form, one a normalised ``volume_stem_agg``
    call."""
    from esmstereo_tpu_torch.ops.kernels import correlation, fused_hourglass

    return {"up_cat_bf16": fused_hourglass.up_cat_bf16,
            "l2_normalize_pair": correlation.l2_normalize_pair}


def on_cuda(what: str, *tensors: torch.Tensor,
            dtypes: tuple = (torch.float32,)) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a dtype
    outside the wrapper's ``dtypes``, mixed devices or another device
    type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: takes {dtypes}, got {t.dtype}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda":
        refuse_autograd(what, *tensors)
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{what}: CUDA kernel needs contiguous inputs")
    return dev.type == "cuda"


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any of ``tensors``
    requires grad: the kernel's output would carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel is eval-only and its output has no "
            f"gradient; run it under torch.no_grad() or "
            f"torch.inference_mode(), or train the model, whose training "
            f"mode takes the plain modules")


def count_launch(wrapper, form: str) -> None:
    """One launch of ``wrapper``'s kernel in ``form``."""
    wrapper.launches += 1
    wrapper.form_launches[form] = wrapper.form_launches.get(form, 0) + 1


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for fn in wrappers().values():
        fn.launches = 0
        fn.form_launches = {}
    for fn in conv_wrappers().values():
        fn.launches = 0
        fn.form_launches = {}
        fn.shape_launches = {}
    for fn in step_wrappers().values():
        fn.launches = 0
        fn.form_launches = {}


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
