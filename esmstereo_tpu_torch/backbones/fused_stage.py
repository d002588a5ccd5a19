"""One backbone stage >= 1 as one operation (kernel J).

Counterpart of the Python surface of ``esmstereo_tpu/attic/fused_stage.py``:
``stage_supported`` (``:158``), ``prepare_stage_consts`` (``:182``) and a
stage run through the kernel (``fused_stage_apply``, ``:270``). As in the
JAX package no model configuration reaches it: ``FeaturePyramid.forward``
runs stages 1-5 as its plain modules, and ``run_stage`` drives one stage of
a pyramid through the wrapper ``ops.kernels.fused_stage.fused_stage``,
stage by stage, as the JAX package drives its kernel.

``stage_supported`` keeps the function's constraints and drops the TPU's
lane constraints (every flat width ``W * C`` a multiple of 128 there), so
it accepts every stage 1-5 of both backbones at any even frame size --
among them efficientnet_b2's stage 3 at 544x992, which the JAX version
rejects (88 channels x 62 columns).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from esmstereo_tpu_torch.nn.blocks import fold_bn, folded_once
from esmstereo_tpu_torch.ops.kernels.fused_stage import (fused_stage,
                                                        unsupported)


def stage_supported(stage: Sequence, cin: int, h_in: int, w_in: int) -> bool:
    """True when the kernel takes ``stage`` (a tuple of ``BlockCfg``) on a
    ``cin``-channel input of ``h_in`` x ``w_in``, by the kernel's rule
    (``ops.kernels.fused_stage.unsupported``): blocks ``ds`` or ``ir``
    with a k3 or k5 depthwise conv, stride 2 only on the first block and
    then on an even input size, and SqueezeExcite on every block or on
    none."""
    if cin < 1 or h_in < 1 or w_in < 1:
        return False
    return unsupported([(b.kind, b.kernel, b.stride, b.se_ratio > 0)
                        for b in stage], h_in, w_in) is None


def _fold_stage(pyramid, si: int) -> dict:
    blocks = []
    for name in pyramid.block_names[si]:
        blk = getattr(pyramid, name)
        ir = hasattr(blk, "conv_pwl")
        dw = blk.conv_dw
        k, s = dw.weight.shape[-1], dw.stride[0]
        wd, bd = fold_bn(dw.weight, blk.bn2 if ir else blk.bn1)
        proj, bn = (blk.conv_pwl, blk.bn3) if ir else (blk.conv_pw, blk.bn2)
        wp, bp = fold_bn(proj.weight, bn)
        wp = wp[:, :, 0, 0]
        block = {"kind": "ir" if ir else "ds", "k": k, "stride": s,
                 "cin": (blk.conv_pw.weight.shape[1] if ir
                         else wd.shape[0]),
                 "mid": wd.shape[0], "cout": wp.shape[0],
                 "residual": blk.residual, "wd": wd[:, 0].contiguous(),
                 "bd": bd, "wp": wp, "bp": bp, "wp_t": wp.t().contiguous()}
        if ir:
            we, be = fold_bn(blk.conv_pw.weight, blk.bn1)
            we = we[:, :, 0, 0]
            block.update({"we": we, "be": be, "we_t": we.t().contiguous()})
        if blk.se is not None:
            se = blk.se
            block.update({"se_w1": se.conv_reduce.weight[:, :, 0, 0],
                          "se_b1": se.conv_reduce.bias,
                          "se_w2": se.conv_expand.weight[:, :, 0, 0],
                          "se_b2": se.conv_expand.bias})
        blocks.append({k_: v.contiguous() if torch.is_tensor(v) else v
                       for k_, v in block.items()})
    return {"blocks": blocks, "act": pyramid.cfg.act}


@functools.cache
def _fold(si: int):
    """Stage ``si``'s fold function, made once: ``folded_once`` keys on it."""
    return functools.partial(_fold_stage, si=si)


def prepare_stage_consts(pyramid, si: int) -> dict:
    """BN-folded weights of stage ``si`` of ``pyramid`` (eval statistics),
    in the layout ``ops.kernels.fused_stage`` documents, computed again only
    when the stage's weights change (``nn.blocks.folded_once``)."""
    blocks = [getattr(pyramid, n) for n in pyramid.block_names[si]]
    return folded_once(pyramid, _fold(si), *blocks)


def run_stage(pyramid, si: int, x: torch.Tensor) -> torch.Tensor:
    """Stage ``si`` of ``pyramid`` on ``x`` through kernel J: the kernel on
    a CUDA tensor, its plain version on a CPU tensor."""
    return fused_stage(x, prepare_stage_consts(pyramid, si))
