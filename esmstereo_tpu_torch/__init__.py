"""ESMStereo in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``esmstereo_tpu`` (JAX/Flax on TPU). This first slice covers the
eval path of the L variant (cv_scale 4, efficientnet_b2, group-wise
correlation, fp32). Public layouts follow the JAX package: NHWC images in,
``(B, H, W)`` disparity out; inside, tensors are NCHW / NCDHW.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The three kernels of the path (``ops.kernels``) launch on CUDA tensors; on
CPU tensors their plain PyTorch versions run instead.

Importing this package imports nothing else: the submodules are imported
where they are used.
"""

from esmstereo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
