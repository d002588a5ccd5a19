"""ESMStereo in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``esmstereo_tpu`` (JAX/Flax on TPU). It covers the eval path of
the L and M variants (cv_scale 4 and 8, efficientnet_b2), the S variant
(cv_scale 16, mobilenetv2_100) and the confidence model on S, each with the
group-wise or norm-correlation volume, in fp32; and L at the deploy
numerics (bf16 compute, tanh GELU, optionally an int8 volume). Public
layouts follow the JAX package: NHWC images in, ``(B, H, W)`` disparity
(and confidence) out; inside, tensors are NCHW / NCDHW.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The kernels of the paths (``ops.kernels``) launch on CUDA tensors; on CPU
tensors their plain PyTorch versions run instead.

Importing this package imports nothing else: the submodules are imported
where they are used.
"""

from esmstereo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
