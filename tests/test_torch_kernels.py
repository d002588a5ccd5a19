"""PyTorch port: the plain versions of the three CUDA kernels against the
Pallas kernels they replace (interpret mode on the CPU) and the JAX ops.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); on CPU tensors every wrapper runs
its plain version, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from esmstereo_tpu import ops as jops  # noqa: E402
from esmstereo_tpu.backbones import FeaturePyramid as JaxPyramid  # noqa: E402
from esmstereo_tpu.ops.pallas import correlation as jcorr  # noqa: E402
from esmstereo_tpu.ops.pallas import fused_agg_stem as jfas  # noqa: E402
from esmstereo_tpu.ops.pallas import fused_head as jfh  # noqa: E402
from esmstereo_tpu_torch.backbones import fused  # noqa: E402
from esmstereo_tpu_torch.backbones.efficientnet import FeaturePyramid  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import convert_tree  # noqa: E402
from esmstereo_tpu_torch.nn.blocks import ConvBlock  # noqa: E402
from esmstereo_tpu_torch.nn.init import init_model_  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_head, wrappers  # noqa: E402

torch.set_num_threads(2)


def random_variables(shapes: dict, rng) -> dict:
    """Seeded numpy values for a flax ``{"params", "batch_stats"}`` shape
    tree (from ``jax.eval_shape`` of ``init``, which is far cheaper on the
    CPU than an eager ``init``): fan-in scaled normal kernels, BN scales and
    layer-norm weights in [0.75, 1.25), small biases and means, variances
    in [0.5, 1.5), so that every BN fold is exercised."""

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            v = rng.standard_normal(shape) * np.sqrt(
                2.0 / np.prod(shape[:-1]))
        elif name.endswith(("['scale']", "['weight']")):
            v = 0.75 + 0.5 * rng.random(shape)
        elif name.endswith(("['bias']", "['mean']")):
            v = 0.1 * rng.standard_normal(shape)
        elif name.endswith("['var']"):
            v = 0.5 + rng.random(shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# --- kernel A: stem + stage 0 ---------------------------------------------

@pytest.mark.parametrize("arch", ["efficientnet_b2", "mobilenetv2_100"])
def test_fused_stage0_plain_matches_pallas(rng, arch):
    """32x64 images, tile_rows 8 (as tests/test_fused_head.py), in both of
    the kernel's forms: efficientnet_b2's two SE blocks with SiLU and
    mobilenetv2_100's one block with ReLU6. Tolerance 1e-5, the bound of
    the JAX package's own kernel test."""
    img = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    jp = JaxPyramid(arch=arch)
    v = random_variables(jax.eval_shape(
        lambda x: jp.init(jax.random.key(0), x, train=False), img), rng)
    act = {"efficientnet_b2": "silu", "mobilenetv2_100": "relu6"}[arch]
    consts = jfh.prepare_consts(v["params"], v["batch_stats"], act=act,
                                width=img.shape[2] // 2)
    want = np.asarray(jfh.fused_stage0_apply(jnp.asarray(img), consts,
                                             tile_rows=8, interpret=True))

    pyr = FeaturePyramid(arch, device="cpu").eval()
    pyr.load_state_dict(convert_tree(v))
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        tconsts = fused.prepare_consts(pyr)
        got = fused_head.fused_stage0(x, tconsts)
        feats = pyr(x)
    assert fused_head.kernel_form(tconsts) == arch
    assert tconsts["packed"].numel() == {"efficientnet_b2": 2876,
                                         "mobilenetv2_100": 1744}[arch]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-5, atol=1e-5)
    # in eval mode the pyramid takes the fused head
    np.testing.assert_array_equal(feats[0].numpy(), got.numpy())


def test_fused_head_raises_on_mobilenetv2(rng):
    """The eval-mode mobilenetv2_100 pyramid takes kernel A's ReLU6 form
    and matches the JAX pyramid (5 levels, 32x64, seeded variables) within
    1e-4 relative to max(1, max|JAX|); kernel A raises on a mobilenetv2
    stage 0 in a layout it lacks (SiLU in place of ReLU6, or an SE gate),
    and the training-mode pyramid runs the plain modules."""
    img = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    jp = JaxPyramid(arch="mobilenetv2_100")
    v = random_variables(jax.eval_shape(
        lambda x: jp.init(jax.random.key(0), x, train=False), img), rng)
    want = jax.jit(lambda v, x: jp.apply(v, x, train=False))(
        v, jnp.asarray(img))

    pyr = FeaturePyramid("mobilenetv2_100", device="cpu").eval()
    pyr.load_state_dict(convert_tree(v))
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        consts = fused.prepare_consts(pyr)
        feats = pyr(x)
        head = fused_head.fused_stage0(x, consts)
    np.testing.assert_array_equal(feats[0].numpy(), head.numpy())
    assert len(feats) == len(want) == 5
    for g, w in zip(feats, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() < 1e-4 * max(1.0, np.abs(w).max())
    with pytest.raises(NotImplementedError):
        fused_head.kernel_form(dict(consts, act="silu"))
    se = {"se_w1": torch.zeros(8, 32), "se_b1": torch.zeros(8),
          "se_w2": torch.zeros(32, 8), "se_b2": torch.zeros(32)}
    with pytest.raises(NotImplementedError):
        fused_head.kernel_form(dict(consts, blocks=[
            dict(consts["blocks"][0], **se)]))
    assert len(pyr.train()(torch.zeros(1, 3, 32, 64))) == 5


def test_folded_consts_are_computed_once_per_weights():
    """The fused head folds its weights once, and again only after they
    change (in place, or through ``load_state_dict``)."""
    pyr = FeaturePyramid("efficientnet_b2", device="cpu").eval()
    init_model_(pyr, torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 3, 16, 32)).astype(np.float32))
    with torch.inference_mode():
        first = pyr(x)[0]
        memo = dict(pyr._folded)
        assert torch.equal(pyr(x)[0], first)
    assert dict(pyr._folded) == memo              # the same consts object
    with torch.no_grad():
        pyr.bn1.running_var.mul_(4.0)
    with torch.inference_mode():
        changed = pyr(x)[0]
    assert dict(pyr._folded) != memo
    state = {k: v.clone() for k, v in pyr.state_dict().items()}
    state["bn1.running_var"].div_(4.0)
    pyr.load_state_dict(state)
    with torch.inference_mode():
        again = pyr(x)[0]
    assert not torch.equal(changed, first)
    torch.testing.assert_close(again, first, rtol=1e-6, atol=1e-6)
    # weights made under inference_mode have no version counter: no memo
    with torch.inference_mode():
        fresh = FeaturePyramid("efficientnet_b2", device="cpu").eval()
        fresh.load_state_dict(pyr.state_dict())
        torch.testing.assert_close(fresh(x)[0], first, rtol=1e-6, atol=1e-6)
    assert "_folded" not in fresh.__dict__


# --- kernel B: group-wise correlation volume --------------------------------

def test_gwc_volume_plain_matches_jax(rng):
    """(B, C, H, W) = (2, 64, 8, 32), 12 bins, 32 groups: the gwc form of
    ``correlation_volume`` against ``ops.build_gwc_volume`` and the folded
    Pallas kernel (interpret mode), un-folded. Tolerance 1e-5 (fp32
    products and group means). The normalised forms are in
    test_torch_variants.py."""
    b, c, h, w, d, g = 2, 64, 8, 32, 12, 32
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    tgt = rng.standard_normal((b, h, w, c)).astype(np.float32)
    got = correlation.correlation_volume(
        torch.from_numpy(np.ascontiguousarray(ref.transpose(0, 3, 1, 2))),
        torch.from_numpy(np.ascontiguousarray(tgt.transpose(0, 3, 1, 2))),
        d, g).numpy()                                   # (B, G, D, H, W)
    assert got.shape == (b, g, d, h, w)

    plain = np.asarray(jops.build_gwc_volume(jnp.asarray(ref),
                                             jnp.asarray(tgt), d, g))
    np.testing.assert_allclose(got, plain.transpose(0, 4, 1, 2, 3),
                               rtol=1e-5, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        folded = np.asarray(jcorr.correlation_volume_folded(
            jnp.asarray(ref), jnp.asarray(tgt), d, g, interpret=True))
    unfolded = folded.reshape(b, h, w, d, g).transpose(0, 4, 3, 1, 2)
    np.testing.assert_allclose(got, unfolded, rtol=1e-5, atol=1e-5)


# --- kernel C: group_stem + agg ---------------------------------------------

def _conv_bn_tree(rng, ci, co):
    k = (rng.standard_normal((3, 3, 3, ci, co)) / np.sqrt(27 * ci))
    return {"params": {"conv": {"Conv_0": {"kernel": k.astype(np.float32)}},
                       "bn": {"scale": (0.75 + 0.5 * rng.random(co)),
                              "bias": 0.1 * rng.standard_normal(co)}},
            "batch_stats": {"bn": {"mean": 0.1 * rng.standard_normal(co),
                                   "var": 0.5 + rng.random(co)}}}


@pytest.mark.parametrize("approximate", [False, True])
def test_stem_agg_plain_matches_pallas(rng, approximate):
    """32 -> 8 -> 8 channels over (D, H, W) = (16, 8, 16), both GELU forms,
    against ``folded_stem_agg_apply`` (interpret mode) with consts from its
    ``prepare_consts``. Tolerance 1e-4, as tests/test_fused_agg_stem.py."""
    d, h, w = 16, 8, 16
    trees = [jax.tree.map(lambda a: np.asarray(a, np.float32),
                          _conv_bn_tree(rng, ci, 8)) for ci in (32, 8)]
    vol = rng.standard_normal((1, 32, d, h, w)).astype(np.float32)

    jconsts = jfas.prepare_consts(
        trees[0]["params"]["conv"]["Conv_0"]["kernel"],
        (trees[0]["params"]["bn"], trees[0]["batch_stats"]["bn"]),
        trees[1]["params"]["conv"]["Conv_0"]["kernel"],
        (trees[1]["params"]["bn"], trees[1]["batch_stats"]["bn"]),
        depth=d, gelu_approximate=approximate)
    folded = vol.transpose(0, 3, 4, 2, 1).reshape(1, h, w, d * 32)
    want = np.asarray(jfas.folded_stem_agg_apply(jnp.asarray(folded), jconsts,
                                                 interpret=True))
    want = want.reshape(1, h, w, d, 8).transpose(0, 4, 3, 1, 2)

    stem = ConvBlock(32, 8, 3, 1, 1, dims=3, device="cpu").eval()
    agg = ConvBlock(8, 8, 3, 1, 1, dims=3, device="cpu").eval()
    stem.load_state_dict(convert_tree(trees[0]))
    agg.load_state_dict(convert_tree(trees[1]))
    with torch.no_grad():
        consts = fused_agg_stem.prepare_consts(stem, agg)
        got = fused_agg_stem.stem_agg(torch.from_numpy(vol), consts,
                                      approximate).numpy()
        # the folded consts are the two ConvBlocks in eval mode
        blocks_out = agg(stem(torch.from_numpy(vol))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if not approximate:
        np.testing.assert_allclose(got, blocks_out, rtol=1e-5, atol=1e-5)


# --- the wrappers' checks ---------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 64, 4, 8)
    with pytest.raises(TypeError):
        correlation.correlation_volume(x.double(), x.double(), 4, 32)
    with pytest.raises(ValueError):
        correlation.correlation_volume(x, x[..., :4], 4, 32)
    with pytest.raises(NotImplementedError):    # the kernel's (C, G) forms
        correlation.check_kernel_form("correlation_volume", 64, 8)
    with pytest.raises(ValueError):
        fused_agg_stem.stem_agg(x, {}, False)
    with pytest.raises(ValueError):
        fused_head.fused_stage0(torch.zeros(1, 3, 5, 8), {})
    assert set(wrappers()) == {"fused_stage0", "correlation_volume",
                               "stem_agg",
                               "volume_stem_agg", "down_pair", "up_pair",
                               "stems", "mixer", "fused_stage",
                               "activation_bf16"}
    # CPU calls run the plain versions and launch nothing, in any form:
    # every wrapper counts its launches by form too ("fp32", "bf16", ...)
    correlation.correlation_volume(x, x, 4, 32)
    correlation.correlation_volume(x, x, 4, 1, normalize=True)
    correlation.correlation_volume(x.bfloat16(), x.bfloat16(), 4, 32)
    assert all(fn.launches == 0 for fn in wrappers().values())
    assert all(fn.form_launches == {} for fn in wrappers().values())
