"""PyTorch port: kernels F (stem_2 + stem_4) and I (the cv4 upsampler's
ShuffleMixer section), and the model with every ``fuse_*`` switch set.

F's plain version is held against the JAX package's ``reference_stem_eval``
and I's against ``nn/mixer.py::mixer_reference``: the JAX functions that
the Pallas kernels ``fused_stems_apply`` and ``fused_mixer_apply`` are held
equal to by the JAX package's own tests (``tests/test_fused_stems.py``,
``tests/test_fused_mixer.py``). Neither Pallas kernel runs here: in
interpret mode they take minutes on the CPU. Then the port with all five
switches against the JAX model with the same switches, and the wrappers'
guards.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each against
its plain version there); on CPU tensors the wrappers run their plain
versions, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.backbones.fused import reference_stem_eval  # noqa: E402
from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.models.phased_upsample import PhUpStage2x  # noqa: E402
from esmstereo_tpu.nn import blocks as jblocks  # noqa: E402
from esmstereo_tpu.nn.mixer import mixer_reference  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import (  # noqa: E402
    convert_tree, state_dict_from_jax)
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig, _UpStage)
from esmstereo_tpu_torch.nn import blocks  # noqa: E402
from esmstereo_tpu_torch.nn.blocks import StemBlock  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import (fused_mixer,  # noqa: E402
                                             fused_stems, wrappers)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

ALL = dict(fuse_stems=True, fuse_volume_agg=True, fuse_hourglass=True,
           fuse_hourglass_up=True, fuse_mixer=True)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# --- kernel F: stem_2 + stem_4 ----------------------------------------------

@pytest.mark.parametrize("shape,approximate", [
    ((2, 3, 32, 64), False),
    ((1, 3, 44, 100), False),     # /4 sizes 11 x 25: ragged everywhere
    ((2, 3, 32, 64), True),
])
def test_stems_plain_matches_jax(rng, shape, approximate):
    """Two JAX ``StemBlock``s (3 -> 32 -> 48) on seeded variables, run as
    ``reference_stem_eval``, against ``fused_stems.stems`` with consts from
    ``prepare_consts``. Tolerance 1e-5 absolute and relative, the bound of
    tests/test_fused_stems.py (fp32 convs on both sides). The port's own
    ``StemBlock`` modules (separate BatchNorm) give the same maps."""
    img = rng.standard_normal(shape).astype(np.float32)
    b, _, h, w = shape
    variables, want = [], []
    x = jnp.asarray(img.transpose(0, 2, 3, 1))
    jblocks.set_gelu_approximate(approximate)
    try:
        for co, (hh, ww) in ((32, (h // 2, w // 2)), (48, (h // 4, w // 4))):
            stem = jblocks.StemBlock(co)
            v = random_variables(jax.eval_shape(
                lambda a, stem=stem: stem.init(jax.random.key(0), a,
                                               train=False), x), rng)
            x = reference_stem_eval(x, v["params"], v["batch_stats"])
            assert x.shape == (b, hh, ww, co)
            variables.append(v)
            want.append(np.asarray(x).transpose(0, 3, 1, 2))
    finally:
        jblocks.set_gelu_approximate(False)

    stem_2 = StemBlock(3, 32, device="cpu").eval()
    stem_4 = StemBlock(32, 48, device="cpu").eval()
    stem_2.load_state_dict(convert_tree(variables[0]))
    stem_4.load_state_dict(convert_tree(variables[1]))
    timg = torch.from_numpy(img)
    with torch.no_grad():
        consts = fused_stems.prepare_consts(stem_2, stem_4)
        got = fused_stems.stems(timg, consts, approximate)
        blocks.set_gelu_approximate(approximate)
        try:
            s2 = stem_2(timg)
            modules = (s2, stem_4(s2))
        finally:
            blocks.set_gelu_approximate(False)
    for g, wnt, mod in zip(got, want, modules):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), mod.numpy(), rtol=1e-5,
                                   atol=1e-5)


# --- kernel I: the ShuffleMixer section ---------------------------------------

def _pixel_shuffled(phase_major: np.ndarray) -> np.ndarray:
    """JAX's phase-major (B, H, W, (2i + j) * 16 + c) -> the port's
    (B, 16, 2H, 2W), out[c, 2h + i, 2w + j]."""
    b, h, w, _ = phase_major.shape
    return (phase_major.reshape(b, h, w, 2, 2, 16)
            .transpose(0, 5, 1, 3, 2, 4).reshape(b, 16, 2 * h, 2 * w))


@pytest.mark.parametrize("shape", [(1, 32, 12, 24), (2, 32, 8, 16)])
def test_mixer_plain_matches_jax(rng, shape):
    """The mixer subtree of a seeded JAX ``PhUpStage2x`` run as
    ``mixer_reference`` (to_feat -> FMBlock x2 -> up, phase-major) against
    ``fused_mixer.mixer`` with consts packed from the port's ``_UpStage``
    holding the same variables. Tolerance 1e-4, the bound of
    tests/test_fused_mixer.py for its kernel (fp32 through 18 chained
    convs and MLPs). The port's own modules give the same map within
    1e-5."""
    b, _, h, w = shape
    x = rng.standard_normal(shape).astype(np.float32)
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    stage = PhUpStage2x()
    variables = random_variables(jax.eval_shape(
        lambda f1, f2, d: stage.init(jax.random.key(0), f1, f2, d,
                                     train=False),
        sds(b, h // 2, w // 2, 96), sds(b, h, w, 48), sds(b, h, w, 1)), rng)
    mix = {k: variables["params"][k]
           for k in ("to_feat", "block0", "block1", "up")}
    want = _pixel_shuffled(np.asarray(mixer_reference(
        jnp.asarray(x.transpose(0, 2, 3, 1)), mix)))

    port = _UpStage(48, 96, 48, 32, 32, 16, 32, True, device="cpu").eval()
    port.load_state_dict(convert_tree(variables))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = fused_mixer.mixer(tx, fused_mixer.prepare_consts(port)).numpy()
        modules = port.up(port.block1(port.block0(port.to_feat(tx)))).numpy()
    assert got.shape == want.shape == (b, 16, 2 * h, 2 * w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, modules, rtol=1e-5, atol=1e-5)


# --- the slice: every switch against the JAX model ------------------------------

def test_all_switch_slice_matches_jax():
    """The port with the five switches against the JAX model with the same
    switches, 64x128, fp32 on the CPU (the JAX model runs
    ``reference_stem_eval`` and ``mixer_reference`` there; its own tests
    hold those equal to kernels F and I). The all-switch JAX variables load
    through the bridge. Bounds of test_torch_fused_aggregation.py::
    test_fused_slice_matches_jax: match_left, f4 and cost within 1e-4
    relative; disp_2 (the stage2x output that kernel I feeds) and the
    disparity within 1e-4 relative on at least 99% of pixels (``conv1_up``
    x30 sharpens the top-2 peaks)."""
    rng = np.random.default_rng(1)
    h, w = 64, 128
    left = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    right = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    model = JaxESMStereo(JaxConfig(**ALL))
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), left, right), rng)
    variables["params"]["aggregation_out"]["conv1_up"]["conv"]["kernel"] *= 30
    want, want_aux = jax.jit(lambda v, l, r: model.apply(
        v, l, r, capture_internals=True))(variables, left, right)

    port = ESMStereo(ESMStereoConfig(**ALL), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables))
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)
    # each switch's consts were folded once, on the module that owns them
    assert len(port._folded) == 2                     # stems, group_stem+agg
    assert len(port.upsample_module.stage2x._folded) == 1

    def rel(a, b):
        b = np.asarray(b)
        return np.abs(np.asarray(a) - b) / max(1.0, float(np.abs(b).max()))

    for key in ("match_left", "f4", "cost"):
        assert got_aux[key].shape == want_aux[key].shape, key
        assert rel(got_aux[key], want_aux[key]).max() < 1e-4, key
    assert got_aux["disp_2"].shape == want_aux["disp_2"].shape == (1, 32, 64)
    assert (rel(got_aux["disp_2"], want_aux["disp_2"]) < 1e-4).mean() >= 0.99
    disp = got[0].numpy()
    assert disp.shape == (1, h, w) and np.isfinite(disp).all()
    assert (rel(disp, want[0]) < 1e-4).mean() >= 0.99


# --- guards -------------------------------------------------------------------

def test_stems_mixer_wrappers_guard_and_launch_nothing_on_cpu():
    model = ESMStereo(ESMStereoConfig(**ALL), device="cpu", seed=5)
    assert model.upsample_module.stage2x.fuse_mixer
    assert not model.upsample_module.stage4x.fuse_mixer      # no mixer there
    sc = fused_stems.prepare_consts(model.stem_2, model.stem_4)
    mc = fused_mixer.prepare_consts(model.upsample_module.stage2x)
    img = torch.zeros(1, 3, 8, 16)
    x = torch.zeros(1, 32, 3, 5)
    # fp32 only
    with pytest.raises(TypeError):
        fused_stems.stems(img.double(), sc, False)
    with pytest.raises(TypeError):
        fused_mixer.mixer(x.double(), mc)
    # one device, and not a meta tensor
    with pytest.raises(ValueError):
        fused_stems.stems(img.to("meta"), sc, False)
    with pytest.raises(ValueError):
        fused_mixer.mixer(x.to("meta"), {"packed": mc["packed"].to("meta")})
    # F takes 3 channels in, H and W multiples of 4, its own widths
    with pytest.raises(ValueError):
        fused_stems.stems(torch.zeros(1, 4, 8, 16), sc, False)
    with pytest.raises(ValueError):
        fused_stems.stems(torch.zeros(1, 3, 6, 16), sc, False)
    with pytest.raises(ValueError):
        fused_stems.stems(torch.zeros(1, 3, 8, 18), sc, False)
    with pytest.raises(ValueError):
        fused_stems.stems(img, dict(sc, wc4=sc["wc4"][..., :32]), False)
    # I takes 32 channels in and the 16-wide section
    with pytest.raises(ValueError):
        fused_mixer.mixer(torch.zeros(1, 16, 3, 5), mc)
    with pytest.raises(ValueError):
        fused_mixer.mixer(x, {"packed": mc["packed"][:-16]})
    # CPU calls run the plain versions and launch nothing
    with torch.no_grad():
        s2, s4 = fused_stems.stems(img, sc, False)
        assert s2.shape == (1, 32, 4, 8) and s4.shape == (1, 48, 2, 4)
        assert fused_mixer.mixer(x, mc).shape == (1, 16, 6, 10)
    assert set(wrappers()) == {"fused_stage0", "correlation_volume",
                               "stem_agg",
                               "volume_stem_agg", "down_pair", "up_pair",
                               "stems", "mixer", "fused_stage",
                               "activation_bf16"}
    assert all(fn.launches == 0 for fn in wrappers().values())
