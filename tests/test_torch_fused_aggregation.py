"""PyTorch port: the fused cost-volume section (kernels E, G and H).

Kernel E's plain version against the Pallas kernel it replaces,
``folded_volume_stem_agg_apply``, run in interpret mode on the CPU (G's and
H's are in ``test_torch_fused_hourglass.py``, which shares this file's
helpers). Then the port with ``fuse_volume_agg``, ``fuse_hourglass`` and
``fuse_hourglass_up`` set against the JAX model with the same switches,
and the wrappers' guards.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each against
its plain version there); on CPU tensors the wrappers run their plain
versions, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance. JAX
layouts are folded ``(B, H, W, D*C)``, depth-major; the port's are
``(B, C, D, H, W)``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.ops.pallas import fused_agg_stem as jfas  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import (  # noqa: E402
    convert_tree, state_dict_from_jax)
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.nn.blocks import ConvBlock  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_agg_stem  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_hourglass  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import wrappers  # noqa: E402
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

FUSED = dict(fuse_volume_agg=True, fuse_hourglass=True,
             fuse_hourglass_up=True)


def _block_tree(rng, k: int, ci: int, co: int, deconv: bool = False) -> dict:
    """Seeded variables of one ``ConvBlock(dims=3)`` with BN, in the JAX
    tree's names: a conv kernel ``(k, k, k, ci, co)`` under ``conv/Conv_0``
    (a transposed conv's directly under ``conv``)."""
    kern = (rng.standard_normal((k, k, k, ci, co))
            / np.sqrt(k ** 3 * ci)).astype(np.float32)
    conv = {"kernel": kern} if deconv else {"Conv_0": {"kernel": kern}}
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"params": {"conv": conv,
                       "bn": {"scale": f32(0.75 + 0.5 * rng.random(co)),
                              "bias": f32(0.1 * rng.standard_normal(co))}},
            "batch_stats": {"bn": {"mean": f32(0.1 * rng.standard_normal(co)),
                                   "var": f32(0.5 + rng.random(co))}}}


def _jax_args(tree: dict) -> tuple:
    """(kernel, (bn params, bn stats)) as the JAX ``prepare_*`` take them."""
    conv = tree["params"]["conv"]
    kern = conv["kernel"] if "kernel" in conv else conv["Conv_0"]["kernel"]
    return kern, (tree["params"]["bn"], tree["batch_stats"]["bn"])


def _port_block(tree: dict, ci: int, co: int, k: int, s: int, p: int,
                deconv: bool = False) -> ConvBlock:
    block = ConvBlock(ci, co, k, s, p, deconv=deconv, dims=3,
                      device="cpu").eval()
    block.load_state_dict(convert_tree(tree))
    return block


def _fold(x: np.ndarray) -> np.ndarray:
    """(B, C, D, H, W) -> the JAX folded (B, H, W, D*C)."""
    b, c, d, h, w = x.shape
    return np.ascontiguousarray(x.transpose(0, 3, 4, 2, 1)).reshape(
        b, h, w, d * c)


def _unfold(x, c: int) -> np.ndarray:
    """The JAX folded (B, H, W, D*C) -> (B, C, D, H, W)."""
    x = np.asarray(x)
    b, h, w, dc = x.shape
    return x.reshape(b, h, w, dc // c, c).transpose(0, 4, 3, 1, 2)


# --- kernel E: the volume built inside group_stem --------------------------

@pytest.mark.parametrize("w", [16, 13])
def test_volume_stem_agg_plain_matches_pallas(rng, w):
    """64 channels, 32 groups, 12 bins at 8 x w (13: an unaligned width),
    against ``folded_volume_stem_agg_apply`` (interpret mode) with consts
    from its ``prepare_consts``. Tolerance 1e-4, as
    tests/test_fused_agg_stem.py."""
    c, g, d, h = 64, 32, 12, 8
    trees = [_block_tree(rng, 3, g, 8), _block_tree(rng, 3, 8, 8)]
    ref = rng.standard_normal((1, h, w, c)).astype(np.float32)
    tgt = rng.standard_normal((1, h, w, c)).astype(np.float32)
    jconsts = jfas.prepare_consts(*_jax_args(trees[0]), *_jax_args(trees[1]),
                                  depth=d, gelu_approximate=False)
    want = _unfold(jfas.folded_volume_stem_agg_apply(
        jnp.asarray(ref), jnp.asarray(tgt), jconsts, num_groups=g,
        interpret=True), 8)

    stem = _port_block(trees[0], g, 8, 3, 1, 1)
    agg = _port_block(trees[1], 8, 8, 3, 1, 1)
    nchw = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        consts = fused_agg_stem.prepare_consts(stem, agg)
        got = fused_agg_stem.volume_stem_agg(nchw(ref), nchw(tgt), consts, d,
                                             g, False).numpy()
    assert got.shape == want.shape == (1, 8, d, h, w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- the slice: the flagged model against the flagged JAX model ------------

def test_fused_slice_matches_jax():
    """The port with the three switches against the JAX model with the same
    switches, 64x128, fp32 on the CPU (the JAX model takes its plain path
    there; tests/test_fused_hourglass.py and tests/test_fused_integration.py
    hold that path equal to its kernels). The flagged JAX variables load
    through the bridge. Bounds of test_torch_model.py::
    test_slice_matches_jax: match_left, f4 and cost within 1e-4 relative;
    disparity within 1e-4 relative on at least 99% of pixels
    (``conv1_up`` x30 sharpens the top-2 peaks, as there)."""
    rng = np.random.default_rng(0)
    h, w = 64, 128
    left = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    right = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    model = JaxESMStereo(JaxConfig(**FUSED))
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), left, right), rng)
    variables["params"]["aggregation_out"]["conv1_up"]["conv"]["kernel"] *= 30
    want, want_aux = jax.jit(lambda v, l, r: model.apply(
        v, l, r, capture_internals=True))(variables, left, right)

    port = ESMStereo(ESMStereoConfig(**FUSED), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)

    def rel(a, b):
        b = np.asarray(b)
        return np.abs(np.asarray(a) - b) / max(1.0, float(np.abs(b).max()))

    for key in ("match_left", "f4", "cost"):
        assert got_aux[key].shape == want_aux[key].shape, key
        assert rel(got_aux[key], want_aux[key]).max() < 1e-4, key
    disp = got[0].numpy()
    assert disp.shape == (1, h, w) and np.isfinite(disp).all()
    assert (rel(disp, want[0]) < 1e-4).mean() >= 0.99


# --- guards -----------------------------------------------------------------

def test_fused_wrappers_guard_and_launch_nothing_on_cpu():
    assert set(wrappers()) == {"fused_stage0", "correlation_volume",
                               "stem_agg",
                               "volume_stem_agg", "down_pair", "up_pair",
                               "stems", "mixer", "fused_stage",
                               "activation_bf16"}
    # cv16 (S) takes the switches; fuse_volume_agg reaches nothing there
    ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100", **FUSED)
    with pytest.raises(ValueError):
        ESMStereoConfig(cv_scale=16, **FUSED)
    with pytest.raises(NotImplementedError):
        ESMStereoConfig(backbone="mobilenetv2_100", **FUSED)
    model = ESMStereo(ESMStereoConfig(**FUSED), device="cpu", seed=4)
    agg = model.aggregation_out
    stem = fused_agg_stem.prepare_consts(model.group_stem, model.agg)
    down = fused_hourglass.prepare_down_consts(agg.conv1_0, agg.conv1_1)
    up = fused_hourglass.prepare_up_consts(agg.conv2_up, agg.agg_1_0,
                                           agg.agg_1_1)
    desc = torch.zeros(1, 64, 4, 8)
    vol = torch.zeros(1, 8, 6, 4, 8)
    with pytest.raises(ValueError):     # group_stem weights for 32 groups
        fused_agg_stem.volume_stem_agg(desc, desc, stem, 6, 1, False,
                                       normalize=True)
    # fp32 only, one device only
    with pytest.raises(TypeError):
        fused_agg_stem.volume_stem_agg(desc.double(), desc.double(), stem, 6,
                                       32, False)
    with pytest.raises(TypeError):
        fused_hourglass.down_pair(vol.half(), down, False)
    with pytest.raises(ValueError):
        fused_hourglass.down_pair(vol.to("meta"), down, False)
    skip = torch.zeros(1, 24, 6, 4, 8)
    with pytest.raises(ValueError):
        fused_hourglass.up_pair(torch.zeros(1, 40, 3, 2, 4), skip.to("meta"),
                                up, False)
    with pytest.raises(ValueError):     # skip larger than twice src
        fused_hourglass.up_pair(torch.zeros(1, 40, 2, 2, 4), skip, up, False)
    # CPU calls run the plain versions and launch nothing
    with torch.no_grad():
        out = fused_agg_stem.volume_stem_agg(desc, desc, stem, 6, 32, False)
        assert out.shape == (1, 8, 6, 4, 8)
        out = fused_agg_stem.volume_stem_agg(desc, desc, stem, 6, 32, False,
                                             normalize=True)
        assert out.shape == (1, 8, 6, 4, 8)
        assert fused_hourglass.down_pair(vol, down, False).shape == (
            1, 24, 3, 2, 4)
        assert fused_hourglass.up_pair(torch.zeros(1, 40, 3, 2, 4), skip, up,
                                       False).shape == skip.shape
    assert all(fn.launches == 0 for fn in wrappers().values())
