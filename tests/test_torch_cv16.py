"""PyTorch port: ESMStereo-S (cv16, mobilenetv2_100) and the forms of its
kernels against the JAX package.

Kernel F's plain version at S's stem widths (3 -> 16 -> 24) against
``reference_stem_eval`` (the JAX function ``tests/test_fused_stems.py``
holds its Pallas kernel equal to; that kernel takes minutes in interpret
mode), and G's and H's plain versions at S's 12-channel hourglass level
against the Pallas kernels in interpret mode. Then S-gwc against the JAX
default config, and S-gwc with every ``fuse_*`` switch against the
all-switch JAX model, at 64x128, with the weights through
``state_dict_from_jax(variables, config)``; and S-gwc's parameter count.
S-norm (its parity and its count) is held against the JAX model inside the
confidence model's run, in ``test_torch_confidence.py``; kernel A's
mobilenetv2 form is in ``test_torch_kernels.py``.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each form
against its plain version there); on CPU tensors the wrappers run their
plain versions, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.attic import fused_hourglass as jfh  # noqa: E402
from esmstereo_tpu.backbones.fused import reference_stem_eval  # noqa: E402
from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.nn import blocks as jblocks  # noqa: E402
from esmstereo_tpu.nn.phasefold import interleave_indices  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import (  # noqa: E402
    convert_tree, state_dict_from_jax)
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.nn.blocks import StemBlock  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import (fused_hourglass,  # noqa: E402
                                             fused_stems, wrappers)
from test_torch_fused_aggregation import (  # noqa: E402
    _block_tree, _fold, _jax_args, _port_block, _unfold)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

H, W = 64, 128
S = dict(cv_scale=16, backbone="mobilenetv2_100")
ALL = dict(fuse_stems=True, fuse_volume_agg=True, fuse_hourglass=True,
           fuse_hourglass_up=True, fuse_mixer=True)
S_PARAMS = 1_772_986           # ACCURACY.json's S row
# XLA's CPU compile options for the JAX references: skipping LLVM's
# expensive passes halves the compile and leaves the results' bits alone
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def _rel(got, want) -> np.ndarray:
    want = np.asarray(want)
    return (np.abs(np.asarray(got) - want)
            / max(1.0, float(np.abs(want).max())))


# --- kernel F at S's widths --------------------------------------------------

@pytest.mark.parametrize("shape,approximate", [
    ((2, 3, 32, 64), False),
    ((1, 3, 44, 100), True),      # /4 sizes 11 x 25: ragged everywhere
])
def test_stems_s_widths_plain_matches_jax(rng, shape, approximate):
    """Two JAX ``StemBlock``s at S's widths (3 -> 16 -> 24) on seeded
    variables, run as ``reference_stem_eval``, against ``fused_stems.stems``
    (its ``(16, 24)`` form). Tolerance 1e-5, the bound of
    tests/test_fused_stems.py. The port's ``StemBlock`` modules agree."""
    img = rng.standard_normal(shape).astype(np.float32)
    variables, want = [], []
    x = jnp.asarray(img.transpose(0, 2, 3, 1))
    jblocks.set_gelu_approximate(approximate)
    try:
        for co in (16, 24):
            stem = jblocks.StemBlock(co)
            v = random_variables(jax.eval_shape(
                lambda a, stem=stem: stem.init(jax.random.key(0), a,
                                               train=False), x), rng)
            x = reference_stem_eval(x, v["params"], v["batch_stats"])
            variables.append(v)
            want.append(np.asarray(x).transpose(0, 3, 1, 2))
    finally:
        jblocks.set_gelu_approximate(False)

    stem_2 = StemBlock(3, 16, device="cpu").eval()
    stem_4 = StemBlock(16, 24, device="cpu").eval()
    stem_2.load_state_dict(convert_tree(variables[0]))
    stem_4.load_state_dict(convert_tree(variables[1]))
    timg = torch.from_numpy(img)
    with torch.no_grad():
        consts = fused_stems.prepare_consts(stem_2, stem_4)
        assert fused_stems.widths(consts) == (16, 24)
        got = fused_stems.stems(timg, consts, approximate)
    b, _, h, w = shape
    assert got[0].shape == (b, 16, h // 2, w // 2)
    assert got[1].shape == (b, 24, h // 4, w // 4)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-5, atol=1e-5)
    if not approximate:
        with torch.no_grad():
            s2 = stem_2(timg)
            np.testing.assert_allclose(got[1].numpy(), stem_4(s2).numpy(),
                                       rtol=1e-5, atol=1e-5)


# --- kernels G and H at S's 12-channel level ---------------------------------

@pytest.mark.parametrize("ci,co,d,h,w", [
    (8, 12, 12, 4, 8),        # S level 1 at 64 x 128
    (12, 16, 6, 2, 4),        # S level 2, from the 12 channels
])
def test_down_pair_s_levels_plain_matches_pallas(rng, ci, co, d, h, w):
    """Against ``fused_down_pair_apply`` (interpret mode). Tolerance 1e-4,
    as tests/test_fused_hourglass.py."""
    trees = [_block_tree(rng, 3, ci, co), _block_tree(rng, 3, co, co)]
    x = rng.standard_normal((1, ci, d, h, w)).astype(np.float32)
    jconsts = jfh.prepare_pair_consts(*_jax_args(trees[0]),
                                      *_jax_args(trees[1]), depth=d,
                                      gelu_approximate=False)
    want = _unfold(jfh.fused_down_pair_apply(jnp.asarray(_fold(x)), jconsts,
                                             interpret=True), co)
    first = _port_block(trees[0], ci, co, 3, 2, 1)
    second = _port_block(trees[1], co, co, 3, 1, 1)
    with torch.no_grad():
        consts = fused_hourglass.prepare_down_consts(first, second)
        got = fused_hourglass.down_pair(torch.from_numpy(x), consts,
                                        False).numpy()
    assert got.shape == want.shape == (1, co, (d + 1) // 2, (h + 1) // 2,
                                       (w + 1) // 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_up_pair_s_level_plain_matches_pallas(rng):
    """S's up level 2 -> 1 (16 -> 12 channels, src (6, 1, 2), skip (12, 2,
    4)) against ``fused_up_pair_apply`` (interpret mode). Tolerance 1e-4, as
    tests/test_fused_hourglass.py."""
    ci_u, co, d_s, d2, hs, ws = 16, 12, 6, 12, 1, 2
    trees = [_block_tree(rng, 4, ci_u, co, deconv=True),
             _block_tree(rng, 1, 2 * co, co), _block_tree(rng, 3, co, co)]
    src = rng.standard_normal((1, ci_u, d_s, hs, ws)).astype(np.float32)
    skip = rng.standard_normal((1, co, d2, 2 * hs, 2 * ws)).astype(np.float32)
    jconsts = jfh.prepare_up_consts(
        *_jax_args(trees[0]), *_jax_args(trees[1]), *_jax_args(trees[2]),
        depth_in=d_s, depth_out=d2, in_perm=interleave_indices(d2, [co, co]),
        gelu_approximate=False)
    want = _unfold(jfh.fused_up_pair_apply(
        jnp.asarray(_fold(src)), jnp.asarray(_fold(skip)), jconsts,
        interpret=True), co)
    deconv = _port_block(trees[0], ci_u, co, 4, 2, 1, deconv=True)
    cat = _port_block(trees[1], 2 * co, co, 1, 1, 0)
    conv = _port_block(trees[2], co, co, 3, 1, 1)
    with torch.no_grad():
        consts = fused_hourglass.prepare_up_consts(deconv, cat, conv)
        got = fused_hourglass.up_pair(torch.from_numpy(src),
                                      torch.from_numpy(skip), consts,
                                      False).numpy()
    assert got.shape == want.shape == skip.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- ESMStereo-S against the JAX model ---------------------------------------

@functools.cache
def _jax_variables():
    """Seeded variables on the JAX S-gwc model's ``eval_shape`` tree (the
    switches leave the tree as it is) and one input pair."""
    rng = np.random.default_rng(16)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    model = JaxESMStereo(JaxConfig(**S))
    small = np.zeros((1, 32, 64, 3), np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), small, small), rng)
    return variables, left, right


@functools.cache
def _jax_runs():
    """The JAX S-gwc model, default and with the five switches, on the same
    pair and variables, compiled as one program (the two share their
    pyramid, which then compiles once)."""
    variables, left, right = _jax_variables()
    models = [JaxESMStereo(JaxConfig(**S, **switches))
              for switches in ({}, ALL)]
    return jax.jit(lambda v, l, r: tuple(
        m.apply(v, l, r, capture_internals=True) for m in models),
        compiler_options=FAST_COMPILE)(variables, left, right)


def _compare(switches: dict):
    """The port's S-gwc and the JAX S-gwc, both with ``switches`` (none or
    all five), on one pair: match_left, f16, f4, cost, init_pred and disp_2
    within 1e-4 relative (of max(1, max|JAX|)), and the disparity on every
    pixel (cv16's regression of the raw cost is continuous). Returns the
    port model."""
    variables, left, right = _jax_variables()
    want, want_aux = _jax_runs()[1 if switches else 0]

    config = ESMStereoConfig(**S, **switches)
    port = ESMStereo(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)
    for key in ("match_left", "f16", "f4", "cost", "init_pred", "disp_2"):
        assert got_aux[key].shape == want_aux[key].shape, key
        assert _rel(got_aux[key], want_aux[key]).max() < 1e-4, key
    assert want_aux["cost"].shape == (1, 12, H // 16, W // 16)
    disp = got[0].numpy()
    assert disp.shape == (1, H, W) and np.isfinite(disp).all()
    assert _rel(disp, want[0]).max() < 1e-4
    return port


def test_s_parameter_count():
    variables, _, _ = _jax_variables()
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree.leaves(variables["params"]))
    n_port = sum(p.numel() for p in ESMStereo(
        ESMStereoConfig(**S), device="meta").parameters())
    assert n_jax == n_port == S_PARAMS


def test_s_matches_jax():
    """S-gwc against the JAX default config, 64x128, fp32 on the CPU
    (bounds in ``_compare``). The weights are seeded random values, so the
    attention map multiplies the 32-group volume before group_stem, where
    it must, or the cost disagrees."""
    port = _compare({})
    assert not hasattr(port, "feature_up")          # the raw pyramid
    assert len(port.aggregation_out.conv1_0.conv.weight) == 12


def test_s_all_switch_matches_jax():
    """S-gwc with all five switches against the all-switch JAX model (its
    CPU path runs ``reference_stem_eval`` and the plain hourglass). F at
    (16, 24), G and H at 12, 16 and 24 channels; ``fuse_volume_agg`` and
    ``fuse_mixer`` change nothing at cv16, as in JAX. Bounds in
    ``_compare``."""
    port = _compare(ALL)
    assert len(port._folded) == 2                   # stems, group_stem+agg
    assert not port.upsample_module.stage2x.fuse_mixer


def test_s_guards():
    """cv16 is S: mobilenetv2_100 in either volume, with any switch, in
    fp32 and in bf16 (S-deploy-all: tests/test_torch_deploy_switches.py);
    cv16 with efficientnet_b2 raises ``ValueError`` (the JAX rule);
    mobilenetv2_100 at cv4 is not ported. The S forms of the wrappers run
    their plain versions on CPU tensors and launch nothing."""
    for volume in ("gwc", "norm_correlation"):
        ESMStereoConfig(**S, cost_volume=volume, **ALL)
    with pytest.raises(ValueError):
        ESMStereoConfig(cv_scale=16, **ALL)
    with pytest.raises(NotImplementedError):
        ESMStereoConfig(backbone="mobilenetv2_100")
    ESMStereoConfig(**S, dtype="bfloat16")
    ESMStereoConfig(**S, dtype="bfloat16", **ALL)
    model = ESMStereo(ESMStereoConfig(**S, **ALL), device="cpu", seed=6)
    sc = fused_stems.prepare_consts(model.stem_2, model.stem_4)
    with pytest.raises(ValueError):            # a width set with no instance
        fused_stems.stems(torch.zeros(1, 3, 8, 16), dict(
            sc, wd4=sc["wd4"][..., :20], td4=sc["td4"][:20],
            wc4=sc["wc4"][:20, :, :, :20], tc4=sc["tc4"][:20]), False)
    agg = model.aggregation_out
    down = fused_hourglass.prepare_down_consts(agg.conv1_0, agg.conv1_1)
    up = fused_hourglass.prepare_up_consts(agg.conv2_up, agg.agg_1_0,
                                           agg.agg_1_1)
    with torch.no_grad():
        s2, s4 = fused_stems.stems(torch.zeros(1, 3, 8, 16), sc, False)
        assert s2.shape == (1, 16, 4, 8) and s4.shape == (1, 24, 2, 4)
        y = fused_hourglass.down_pair(torch.zeros(1, 8, 12, 4, 8), down,
                                      False)
        assert y.shape == (1, 12, 6, 2, 4)
        assert fused_hourglass.up_pair(torch.zeros(1, 16, 3, 1, 2), y, up,
                                       False).shape == y.shape
    assert all(fn.launches == 0 for fn in wrappers().values())
