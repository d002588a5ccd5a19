"""PyTorch port: the deploy numerics (bf16 compute, tanh GELU) with the
``fuse_*`` switches, as ``bench.py``'s ``BENCH_FUSE_*`` settings run them,
against the JAX package.

The bf16 forms of kernels E, F, G, H and I first. G's and H's plain forms
against ``fused_down_pair_apply`` and ``fused_up_pair_apply`` in interpret
mode on bf16 inputs; E's (gwc G = 32 and normalised G = 1) against B's and
C's plain bf16 forms bit for bit, and against
``folded_volume_stem_agg_apply`` in interpret mode on bf16 descriptors;
F's against ``reference_stem_eval`` at the deploy numerics (fp32 convs,
the stems cast to bf16, as the JAX model casts them) and I's against
``mixer_reference`` (fp32, and the JAX deploy path's bf16 run). Interpret
mode and those references run fp32 operands where the TPU kernels round
them to bf16 (``mm_dt = float32`` or ``bf16 = not interpret``), so each
form is held within ``DEPLOY_ULPS`` bf16 ulps of max|reference|, and the
same function on fp32 operands (its unrounded twin) is held to the
reference bit for bit on all but ``NEAR`` of the outputs; the deploy form
moves more than 10 times that share: the comparison sees the operand
rounding.

The whole models with the switches at the deploy numerics are cases over
the fixtures of the deploy tests: L-deploy-all and each switch alone at
L-deploy in tests/test_torch_deploy.py, M-norm-deploy-all and
S-deploy-all in tests/test_torch_deploy_variants.py.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each form
against its plain version there); on CPU tensors the wrappers run their
plain versions, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.attic import fused_hourglass as jfh  # noqa: E402
from esmstereo_tpu.backbones.fused import reference_stem_eval  # noqa: E402
from esmstereo_tpu.models.phased_upsample import PhUpStage2x  # noqa: E402
from esmstereo_tpu.nn import blocks as jblocks  # noqa: E402
from esmstereo_tpu.nn.mixer import mixer_reference  # noqa: E402
from esmstereo_tpu.nn.phasefold import interleave_indices  # noqa: E402
from esmstereo_tpu.ops.pallas import fused_agg_stem as jfas  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import convert_tree  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig, _UpStage)
from esmstereo_tpu_torch.nn.blocks import StemBlock  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import correlation  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_agg_stem  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_hourglass  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_mixer  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_stems  # noqa: E402
from test_torch_deploy import LITERAL_BF16, SWITCHES, _ulp  # noqa: E402
from test_torch_fused_aggregation import (_block_tree, _fold,  # noqa: E402
                                          _jax_args, _port_block, _unfold)
from test_torch_fused_stems_mixer import _pixel_shuffled  # noqa: E402
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

BF16 = torch.bfloat16
EVERY = dict.fromkeys(SWITCHES, True)
# Each deploy form against its fp32-operand reference, in bf16 ulps of
# max|reference|: measured 1.0 at most (G, H, E, F) and 1.06 (I against the
# fp32 mixer_reference), the bound C's forms are held to
# (tests/test_torch_deploy.py::C_ULPS).
DEPLOY_ULPS = 2.0
# The unrounded twin (fp32 operands, the output rounded to bf16) may differ
# from the reference on at most this share of the outputs: both compute the
# same fp32 function in other orders, which can move a rounding to bf16
# (measured 0 to 0.3%). The deploy forms move 17 to 92% of them.
NEAR = 0.01


def _as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def check_deploy_form(name: str, got, want, unrounded,
                      ulps: float = DEPLOY_ULPS) -> None:
    """``got`` (a deploy form, bf16) within ``ulps`` bf16 ulps of
    max|``want``| (the reference rounded to bf16); ``unrounded`` (the same
    function on fp32 operands, rounded to bf16) equal to ``want`` on all
    but ``NEAR`` of the outputs, and ``got`` unequal on more than 10 times
    that: the operand rounding moves the result past the criterion that
    the unrounded function meets."""
    g, w, u = _as_np(got), _as_np(want), _as_np(unrounded)
    assert g.shape == w.shape == u.shape, (name, g.shape, w.shape, u.shape)
    err = float(np.abs(g - w).max())
    assert err <= ulps * _ulp(float(np.abs(w).max())), (name, err)
    near, moved = float((u != w).mean()), float((g != w).mean())
    assert near <= NEAR, (name, near)
    assert moved > 10 * NEAR, (name, moved)


def _bf16_np(rng, shape) -> np.ndarray:
    """Unit-normal values rounded to bf16, as fp32 numpy."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(BF16).float().numpy()


# --- G and H: the hourglass levels -------------------------------------------

def test_down_pair_bf16_plain_matches_pallas(rng):
    """L's level 1 (8 -> 24 channels) at 8 bins, an odd 5-row output, on a
    bf16 input, tanh GELU: the plain bf16 form against
    ``fused_down_pair_apply(..., interpret=True)`` on the same bf16 input,
    as ``check_deploy_form`` holds it."""
    ci, co, d, h, w = 8, 24, 8, 10, 8
    trees = [_block_tree(rng, 3, ci, co), _block_tree(rng, 3, co, co)]
    x = _bf16_np(rng, (1, ci, d, h, w))
    jc = jfh.prepare_pair_consts(*_jax_args(trees[0]), *_jax_args(trees[1]),
                                 depth=d, gelu_approximate=True)
    want = jfh.fused_down_pair_apply(jnp.asarray(_fold(x), jnp.bfloat16), jc,
                                     interpret=True)
    assert want.dtype == jnp.bfloat16
    first = _port_block(trees[0], ci, co, 3, 2, 1)
    second = _port_block(trees[1], co, co, 3, 1, 1)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        low = fused_hourglass.prepare_down_consts(first, second,
                                                  low_precision=True)
        got = fused_hourglass.down_pair(tx.to(BF16), low, True)
        unrounded = fused_hourglass.down_pair(
            tx, fused_hourglass.prepare_down_consts(first, second), True)
    assert got.dtype == BF16
    check_deploy_form("down_pair", got, _unfold(_as_np(want), co),
                      unrounded.to(BF16))


def test_up_pair_bf16_plain_matches_pallas(rng):
    """L's level 2 -> 1 (40 -> 24 channels) at 4 -> 8 bins on bf16 src and
    skip, tanh GELU: the plain bf16 form against
    ``fused_up_pair_apply(..., interpret=True)``, as ``check_deploy_form``
    holds it."""
    ci_u, co, d_s, d2, hs, ws = 40, 24, 4, 8, 3, 4
    trees = [_block_tree(rng, 4, ci_u, co, deconv=True),
             _block_tree(rng, 1, 2 * co, co), _block_tree(rng, 3, co, co)]
    src = _bf16_np(rng, (1, ci_u, d_s, hs, ws))
    skip = _bf16_np(rng, (1, co, d2, 2 * hs, 2 * ws))
    jc = jfh.prepare_up_consts(
        *_jax_args(trees[0]), *_jax_args(trees[1]), *_jax_args(trees[2]),
        depth_in=d_s, depth_out=d2, in_perm=interleave_indices(d2, [co, co]),
        gelu_approximate=True)
    want = jfh.fused_up_pair_apply(jnp.asarray(_fold(src), jnp.bfloat16),
                                   jnp.asarray(_fold(skip), jnp.bfloat16), jc,
                                   interpret=True)
    assert want.dtype == jnp.bfloat16
    mods = (_port_block(trees[0], ci_u, co, 4, 2, 1, deconv=True),
            _port_block(trees[1], 2 * co, co, 1, 1, 0),
            _port_block(trees[2], co, co, 3, 1, 1))
    s, k = torch.from_numpy(src), torch.from_numpy(skip)
    with torch.no_grad():
        low = fused_hourglass.prepare_up_consts(*mods, low_precision=True)
        got = fused_hourglass.up_pair(s.to(BF16), k.to(BF16), low, True)
        unrounded = fused_hourglass.up_pair(
            s, k, fused_hourglass.prepare_up_consts(*mods), True)
    assert got.dtype == BF16
    check_deploy_form("up_pair", got, _unfold(_as_np(want), co),
                      unrounded.to(BF16))


# --- E: the volume built inside group_stem -----------------------------------

@pytest.mark.parametrize("groups,normalize", [(32, False), (1, True)],
                         ids=["gwc", "norm"])
def test_volume_stem_agg_bf16_is_b_then_c(rng, groups, normalize):
    """bf16 descriptors (64 channels, 8 bins, an unaligned 13-column
    width), tanh GELU, L's gwc form and M-norm's normalised G = 1 form
    (corr_stem's weights x64: the normalised volume is at most 1/64). The
    plain bf16 form equals kernel B's plain bf16 volume followed by C's
    plain bf16 form bit for bit, and the same pair with D's rounding of
    the volume (the products unrounded) differs on more than ``NEAR`` of
    the outputs. Against ``folded_volume_stem_agg_apply(...,
    interpret=True)`` on the bf16 descriptors (fp32 products, volume and
    operands), as ``check_deploy_form`` holds it."""
    c, d, h, w = 64, 8, 4, 13
    trees = [_block_tree(rng, 3, groups, 8), _block_tree(rng, 3, 8, 8)]
    if normalize:
        trees[0]["params"]["conv"]["Conv_0"]["kernel"] *= 64.0
    ref = _bf16_np(rng, (1, c, h, w))
    tgt = _bf16_np(rng, (1, c, h, w))
    jc = jfas.prepare_consts(*_jax_args(trees[0]), *_jax_args(trees[1]),
                             depth=d, gelu_approximate=True)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1),  # noqa: E731
                                 jnp.bfloat16)
    want = jfas.folded_volume_stem_agg_apply(
        nhwc(ref), nhwc(tgt), jc, num_groups=groups, normalize=normalize,
        interpret=True)
    assert want.dtype == jnp.bfloat16
    stem = _port_block(trees[0], groups, 8, 3, 1, 1)
    agg = _port_block(trees[1], 8, 8, 3, 1, 1)
    tr, tt = torch.from_numpy(ref), torch.from_numpy(tgt)
    br, bt = tr.to(BF16), tt.to(BF16)
    with torch.no_grad():
        low = fused_agg_stem.prepare_consts(stem, agg, low_precision=True)
        got = fused_agg_stem.volume_stem_agg(br, bt, low, d, groups, True,
                                             normalize=normalize)

        def b_then_c(round_products):
            vol = correlation.correlation_volume(br, bt, d, groups,
                                                 normalize, round_products)
            return fused_agg_stem.stem_agg(vol, low, True)

        unrounded = fused_agg_stem.volume_stem_agg(
            tr, tt, fused_agg_stem.prepare_consts(stem, agg), d, groups,
            True, normalize=normalize)
        d_rounding = b_then_c(False)
    assert got.dtype == BF16 and got.shape == (1, 8, d, h, w)
    assert torch.equal(got, b_then_c(True))
    assert float((d_rounding != got).float().mean()) > NEAR
    check_deploy_form("volume_stem_agg", got, _unfold(_as_np(want), 8),
                      unrounded.to(BF16))


# --- F: stem_2 + stem_4 ------------------------------------------------------

@pytest.mark.parametrize("widths", [(32, 48), (16, 24)], ids=["L", "S"])
def test_stems_deploy_matches_reference(rng, widths):
    """Two JAX ``StemBlock``s at L's or S's widths on seeded variables, run
    as the JAX model runs ``fuse_stems`` at the deploy numerics on the CPU
    (``reference_stem_eval`` in fp32 under tanh GELU, each stem cast to
    bf16, ``esmstereo_tpu/models/esmstereo.py:549-567``), against the plain
    deploy form (the fp32 image in, bf16 stems out), as
    ``check_deploy_form`` holds it."""
    img = rng.standard_normal((2, 3, 16, 32)).astype(np.float32)
    x = jnp.asarray(img.transpose(0, 2, 3, 1))
    variables, want = [], []
    jblocks.set_gelu_approximate(True)
    try:
        for co in widths:
            stem = jblocks.StemBlock(co)
            v = random_variables(jax.eval_shape(
                lambda a, stem=stem: stem.init(jax.random.key(0), a,
                                               train=False), x), rng)
            x = reference_stem_eval(x, v["params"], v["batch_stats"])
            variables.append(v)
            want.append(_as_np(x.astype(jnp.bfloat16)).transpose(0, 3, 1, 2))
    finally:
        jblocks.set_gelu_approximate(False)
    c2, c4 = widths
    stem_2 = StemBlock(3, c2, device="cpu").eval()
    stem_4 = StemBlock(c2, c4, device="cpu").eval()
    stem_2.load_state_dict(convert_tree(variables[0]))
    stem_4.load_state_dict(convert_tree(variables[1]))
    timg = torch.from_numpy(img)
    with torch.no_grad():
        low = fused_stems.prepare_consts(stem_2, stem_4, low_precision=True)
        got = fused_stems.stems(timg, low, True)
        unrounded = fused_stems.stems(
            timg, fused_stems.prepare_consts(stem_2, stem_4), True)
    for name, g, wnt, u in zip(("stem_2", "stem_4"), got, want, unrounded):
        assert g.dtype == BF16
        check_deploy_form(name, g, wnt, u.to(BF16))


# --- I: the ShuffleMixer section ---------------------------------------------

def test_mixer_bf16_matches_reference(rng):
    """The mixer subtree of a seeded JAX ``PhUpStage2x`` run as
    ``mixer_reference`` on a bf16 spx map: the plain bf16 form against its
    fp32 run cast to bf16, as ``check_deploy_form`` holds it; and within
    ``4`` bf16 ulps of max|JAX| of its bf16 run (``dtype=bfloat16``, the
    JAX model's deploy path on the CPU, whose residual stream is bf16 where
    the TPU kernel's and the port's stay fp32: measured 2.0)."""
    b, h, w = 1, 8, 16
    x = _bf16_np(rng, (b, 32, h, w))
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    stage = PhUpStage2x()
    variables = random_variables(jax.eval_shape(
        lambda f1, f2, d: stage.init(jax.random.key(0), f1, f2, d,
                                     train=False),
        sds(b, h // 2, w // 2, 96), sds(b, h, w, 48), sds(b, h, w, 1)), rng)
    mix = {k: variables["params"][k]
           for k in ("to_feat", "block0", "block1", "up")}
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    # one program for both runs, rounding where each op says (as eager
    # execution does)
    want, want_bf16 = (_pixel_shuffled(_as_np(r)) for r in jax.jit(
        lambda a, m: (mixer_reference(a, m).astype(jnp.bfloat16),
                      mixer_reference(a.astype(jnp.bfloat16), m,
                                      dtype=jnp.bfloat16)),
        compiler_options=LITERAL_BF16)(jx, mix))
    port = _UpStage(48, 96, 48, 32, 32, 16, 32, True, device="cpu").eval()
    port.load_state_dict(convert_tree(variables))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = fused_mixer.mixer(tx.to(BF16), fused_mixer.prepare_consts(
            port, low_precision=True))
        unrounded = fused_mixer.mixer(tx, fused_mixer.prepare_consts(port))
    assert got.dtype == BF16 and got.shape == (b, 16, 2 * h, 2 * w)
    check_deploy_form("mixer", got, want, unrounded.to(BF16))
    err = float(np.abs(_as_np(got) - want_bf16).max())
    assert err <= 4 * _ulp(float(np.abs(want_bf16).max())), err


def test_deploy_forms_guard():
    """A bf16 input with fp32 weights, or an fp32 input with the deploy
    form's, raises in E, G and H; F takes the fp32 image in both forms; I's
    form follows its input (its packed weights are fp32 in both forms) and
    a dtype it does not take raises."""
    model = ESMStereo(ESMStereoConfig(**EVERY), device="cpu", seed=3)
    agg = model.aggregation_out
    down = [fused_hourglass.prepare_down_consts(agg.conv1_0, agg.conv1_1,
                                                low_precision=low)
            for low in (False, True)]
    up = [fused_hourglass.prepare_up_consts(agg.conv2_up, agg.agg_1_0,
                                            agg.agg_1_1, low_precision=low)
          for low in (False, True)]
    vol = [fused_agg_stem.prepare_consts(model.group_stem, model.agg,
                                         low_precision=low)
           for low in (False, True)]
    stage = model.upsample_module.stage2x
    mix = fused_mixer.prepare_consts(stage, low_precision=True)
    x = torch.zeros(1, 8, 4, 4, 8)
    src, skip = torch.zeros(1, 40, 2, 2, 4), torch.zeros(1, 24, 4, 4, 8)
    desc = torch.zeros(1, 64, 2, 8)
    spx = torch.zeros(1, 32, 3, 5)
    for form, other in ((0, BF16), (1, torch.float32)):
        with pytest.raises(TypeError):
            fused_hourglass.down_pair(x.to(other), down[form], True)
        with pytest.raises(TypeError):
            fused_hourglass.up_pair(src.to(other), skip.to(other), up[form],
                                    True)
        with pytest.raises(TypeError):
            fused_agg_stem.volume_stem_agg(desc.to(other), desc.to(other),
                                           vol[form], 4, 32, True)
    with pytest.raises(TypeError):
        fused_hourglass.up_pair(src.to(BF16), skip, up[1], True)
    sc = fused_stems.prepare_consts(model.stem_2, model.stem_4,
                                    low_precision=True)
    img = torch.zeros(1, 3, 8, 16)
    with pytest.raises(TypeError):
        fused_stems.stems(img.to(BF16), sc, True)
    with pytest.raises(TypeError):
        fused_stems.stems(img, dict(sc, td2=sc["td2"].to(BF16)), True)
    s2, s4 = fused_stems.stems(img, sc, True)
    assert s2.dtype == s4.dtype == BF16
    assert fused_hourglass.down_pair(x.to(BF16), down[1], True).dtype == BF16
    for dtype in (BF16, torch.float32):
        assert fused_mixer.mixer(spx.to(dtype), mix).dtype == dtype
    with pytest.raises(TypeError):
        fused_mixer.mixer(spx.to(torch.float16), mix)
