"""The fused backbone head: stem + stage 0 as one operation (kernel A).

Counterpart of ``esmstereo_tpu/backbones/fused.py``. ``FeaturePyramid``
takes this path whenever it is in eval mode. The wrapper
``ops.kernels.fused_head.fused_stage0`` then launches the CUDA kernel on a
CUDA tensor (any even height and width) and runs its plain version on a
CPU tensor. The folded weights are computed once per set of weights, not
per frame. Stages 1-5 stay plain modules.
"""

from __future__ import annotations

import torch

from esmstereo_tpu_torch.nn.blocks import fold_bn, folded_once
from esmstereo_tpu_torch.ops.kernels.fused_head import fused_stage0, pack_params


def prepare_consts(pyramid) -> dict:
    """BN-folded stem and stage-0 weights of ``pyramid`` (eval statistics),
    and the same packed in the kernel's order (``packed``). Only
    efficientnet_b2's stage 0 (two blocks with SqueezeExcite) is in this
    slice; mobilenetv2's single block without SE raises."""
    if pyramid.arch != "efficientnet_b2":
        raise NotImplementedError(
            f"the fused head takes efficientnet_b2 only, not {pyramid.arch}")
    stem_w, stem_b = fold_bn(pyramid.conv_stem.weight, pyramid.bn1)
    blocks = []
    for name in pyramid.block_names[0]:
        blk = getattr(pyramid, name)
        dw_w, dw_b = fold_bn(blk.conv_dw.weight, blk.bn1)
        pw_w, pw_b = fold_bn(blk.conv_pw.weight, blk.bn2)
        se = blk.se
        blocks.append({
            "dw_w": dw_w[:, 0], "dw_b": dw_b,
            "se_w1": se.conv_reduce.weight[:, :, 0, 0],
            "se_b1": se.conv_reduce.bias,
            "se_w2": se.conv_expand.weight[:, :, 0, 0],
            "se_b2": se.conv_expand.bias,
            "pw_w": pw_w[:, :, 0, 0], "pw_b": pw_b,
            "residual": blk.residual,
        })
    consts = {"stem_w": stem_w, "stem_b": stem_b, "blocks": blocks}
    consts["packed"] = pack_params(consts)
    return consts


def fused_head(pyramid, x: torch.Tensor) -> torch.Tensor:
    stage0 = [getattr(pyramid, n) for n in pyramid.block_names[0]]
    consts = folded_once(pyramid, prepare_consts, pyramid.conv_stem,
                         pyramid.bn1, *stage0)
    return fused_stage0(x, consts)
