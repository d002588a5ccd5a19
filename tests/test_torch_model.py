"""PyTorch port: ESMStereo-L against the JAX package's default-config model.

The JAX model's variables (seeded numpy values on its ``eval_shape`` tree)
cross to the port through ``models.convert_jax.state_dict_from_jax``; both
models then run one 64x128 pair in fp32 on the CPU, also at a ``max_disp``
that is not a multiple of ``cv_scale`` (L and M). Also the weight bridge's
refusals, the inference runner (padding, and the TF32 flags it sets around
a forward), and the slice's guards.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.data.io import normalize_image as jax_normalize  # noqa: E402
from esmstereo_tpu.eval.runner import pad_to_next_multiple as jax_pad  # noqa: E402
from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu_torch.data.io import normalize_image  # noqa: E402
from esmstereo_tpu_torch.device import resolve_device  # noqa: E402
from esmstereo_tpu_torch.eval.runner import (InferenceRunner,  # noqa: E402
                                             pad_to_next_multiple)
from esmstereo_tpu_torch.models.convert_jax import state_dict_from_jax  # noqa: E402
from esmstereo_tpu_torch.models.confidence import ESMStereoConfidence  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

H, W = 64, 128
L_PARAMS = 6_796_056          # ACCURACY.json, the L row


@functools.cache
def _l_shapes():
    """The JAX L model's ``eval_shape`` variables, built once for the
    module: ``max_disp`` changes no parameter, so L at 190 shares them."""
    x = np.zeros((1, H, W, 3), np.float32)
    return jax.eval_shape(JaxESMStereo(JaxConfig()).init, jax.random.key(0),
                          x, x)


@pytest.fixture(scope="module")
def jax_l():
    """The JAX default-config model, its variables and one input pair.
    ``aggregation_out/conv1_up`` is scaled x30 so that the cost volume has
    clear top-2 peaks: regression then rarely meets a near-tie, where an
    fp32 rounding difference would swap bins."""
    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    model = JaxESMStereo(JaxConfig())
    variables = random_variables(_l_shapes(), rng)
    variables["params"]["aggregation_out"]["conv1_up"]["conv"]["kernel"] *= 30
    return model, variables, left, right


def test_parameter_count(jax_l):
    _, variables, _, _ = jax_l
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree.leaves(variables["params"]))
    n_port = sum(p.numel() for p in ESMStereo(device="meta").parameters())
    assert n_jax == n_port == L_PARAMS


def test_slice_matches_jax(jax_l):
    """Intermediates within 1e-4 relative (of max(1, max|JAX|)); the final
    disparity within 1e-4 relative on at least 99% of pixels, the JAX
    package's bound (tests/test_reference_parity.py:144-146) with the
    exemption it gives top-2 regression's knife-edge pixels."""
    model, variables, left, right = jax_l
    fwd = jax.jit(lambda v, l, r: model.apply(v, l, r,
                                              capture_internals=True))
    want, want_aux = fwd(variables, left, right)

    port = ESMStereo(device="cpu")
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
    assert disp.shape == (1, H, W) and np.isfinite(disp).all()
    assert (rel(disp, want[0]) < 1e-4).mean() >= 0.99


def test_bridge_raises_on_missing_and_extra_keys(jax_l):
    _, variables, _, _ = jax_l
    missing = jax.tree.map(lambda x: x, variables)
    del missing["params"]["desc"]["Conv_0"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(missing)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["desc"]["extra"] = {"Conv_0": {"bias": np.zeros(64)}}
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax(extra)
    unmapped = jax.tree.map(lambda x: x, variables)
    unmapped["batch_stats"]["conv"]["bn"]["count"] = np.zeros(64)
    with pytest.raises(KeyError, match="no mapping"):
        state_dict_from_jax(unmapped)


def _rel(got, want) -> np.ndarray:
    want = np.asarray(want)
    return (np.abs(np.asarray(got) - want)
            / max(1.0, float(np.abs(want).max())))


def test_max_disp_not_a_multiple_of_cv_scale_matches_jax():
    """``max_disp=190`` at cv4: both packages floor to 47 bins (the
    hourglass's transposed convs return 48, as in JAX), and the port
    matches the JAX model as ``test_slice_matches_jax`` holds it: cost and
    match_left within 1e-4 relative, the disparity on at least 99% of
    pixels."""
    rng = np.random.default_rng(3)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    model = JaxESMStereo(JaxConfig(max_disp=190))
    variables = random_variables(_l_shapes(), rng)
    variables["params"]["aggregation_out"]["conv1_up"]["conv"]["kernel"] *= 30
    want, want_aux = jax.jit(lambda v, l, r: model.apply(
        v, l, r, capture_internals=True), compiler_options={
            "xla_llvm_disable_expensive_passes": True})(variables, left,
                                                         right)
    config = ESMStereoConfig(max_disp=190)
    port = ESMStereo(config, device="cpu")
    assert port.num_bins == 47
    port.load_state_dict(state_dict_from_jax(variables, config))
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)
    assert got_aux["cost"].shape == want_aux["cost"].shape == (1, 48, 16, 32)

    for key in ("match_left", "cost"):
        assert _rel(got_aux[key], want_aux[key]).max() < 1e-4, key
    assert (_rel(got[0].numpy(), want[0]) < 1e-4).mean() >= 0.99


def test_m_max_disp_not_a_multiple_of_cv_scale():
    """cv8 floors ``max_disp`` as JAX does. At 196 both packages build 24
    bins, the default's: the JAX model's program at 196 is the default
    M's (their jaxprs are equal), and the port at 196 gives the default
    port M's outputs bit for bit on the same weights, which
    tests/test_torch_variants.py::test_variant_matches_jax holds against
    that one JAX M program by the cv8 rule (cost within 1e-4 relative of
    max(1, max|JAX|), the disparity on every pixel). At 190 both floor to
    23 bins, which the hourglass's transposed convs return as 24, and both
    refuse the cv8 regression of 24 bins against 23: JAX asserts
    (``esmstereo_tpu/ops/regression.py:33``), the port raises
    ``ValueError``."""
    rng = np.random.default_rng(8)
    # the programs' shapes follow the input's; 32x64 traces cheapest
    left = rng.standard_normal((1, H // 2, W // 2, 3)).astype(np.float32)
    right = rng.standard_normal((1, H // 2, W // 2, 3)).astype(np.float32)
    m196, m192 = (JaxESMStereo(JaxConfig(cv_scale=8, max_disp=d))
                  for d in (196, 192))
    shapes = jax.eval_shape(m196.init, jax.random.key(0), left, right)
    programs = [str(jax.make_jaxpr(lambda v, l, r, m=m: m.apply(
        v, l, r, capture_internals=True))(shapes, left, right))
        for m in (m196, m192)]
    assert programs[0] == programs[1]

    default = ESMStereo(ESMStereoConfig(cv_scale=8), device="cpu", seed=8)
    config = ESMStereoConfig(cv_scale=8, max_disp=196)
    port = ESMStereo(config, device="cpu")
    assert port.num_bins == default.num_bins == 24
    port.load_state_dict(default.state_dict())
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)
        want, want_aux = default(torch.from_numpy(left),
                                 torch.from_numpy(right),
                                 capture_internals=True)
    assert got_aux["cost"].shape == (1, 24, 4, 8)
    assert torch.equal(got_aux["cost"], want_aux["cost"])
    assert torch.equal(got[0], want[0])

    m190 = JaxESMStereo(JaxConfig(cv_scale=8, max_disp=190))
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda v: m190.apply(v, left, right), shapes)
    config = ESMStereoConfig(cv_scale=8, max_disp=190)
    port = ESMStereo(config, device="cpu")
    assert port.num_bins == 23
    port.load_state_dict(default.state_dict())
    with torch.inference_mode(), pytest.raises(ValueError):
        port(torch.from_numpy(left), torch.from_numpy(right))


class _FlagProbe(torch.nn.Module):
    """A stub model that records the TF32 flags its forward sees."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.seen = []

    def forward(self, left, right):
        self.seen.append((torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32))
        return [left[..., 0] + self.w]


@pytest.mark.parametrize("flags", [(True, True), (True, False),
                                   (False, True)])
def test_runner_runs_with_tf32_off_and_restores(flags):
    """Inside ``InferenceRunner``'s forward TF32 is off for cuDNN and for
    matmuls, whatever the caller set; afterwards the caller's flags are
    back, also when the forward raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    img = np.zeros((30, 40, 3), np.uint8)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = flags
        probe = _FlagProbe()
        disp, _ = InferenceRunner(probe)(img, img)
        assert disp.shape == (30, 40)
        assert probe.seen == [(False, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == flags

        def boom(left, right):
            raise RuntimeError("forward failed")
        probe.forward = boom
        with pytest.raises(RuntimeError):
            InferenceRunner(probe)(img, img)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == flags
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_runner_pads_and_crops_as_jax():
    rng = np.random.default_rng(1)
    left = rng.integers(0, 256, (60, 100, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (60, 100, 3), dtype=np.uint8)
    norm = normalize_image(left)
    np.testing.assert_array_equal(norm, jax_normalize(left))
    np.testing.assert_array_equal(pad_to_next_multiple(norm), jax_pad(norm))
    assert pad_to_next_multiple(np.zeros((64, 96, 3))).shape == (96, 128, 3)

    model = ESMStereo(device="cpu", seed=3)
    disp, secs = InferenceRunner(model)(left, right)
    assert disp.shape == (60, 100) and secs > 0
    with torch.inference_mode():
        full = model(torch.from_numpy(pad_to_next_multiple(norm)[None]),
                     torch.from_numpy(pad_to_next_multiple(
                         normalize_image(right))[None]))[0]
    np.testing.assert_array_equal(disp, full[0, 4:, 28:].numpy())


def test_slice_guards(monkeypatch):
    # mobilenetv2 at cv4 is not ported; bf16 with a fuse_* switch is
    # (tests/test_torch_deploy.py, tests/test_torch_deploy_switches.py)
    with pytest.raises(NotImplementedError):
        ESMStereoConfig(backbone="mobilenetv2_100")
    for kw in ({"cv_scale": 8, "dtype": "bfloat16", "fuse_hourglass": True},
               {"cv_scale": 16, "backbone": "mobilenetv2_100",
                "dtype": "bfloat16", "fuse_stems": True}):
        ESMStereoConfig(**kw)
    # the JAX config's variant/backbone constraints
    for kw in ({"cv_scale": 8, "backbone": "mobilenetv2_100"},
               {"cv_scale": 16}, {"cost_volume": "concat"}):
        with pytest.raises(ValueError):
            ESMStereoConfig(**kw)
    for cv, backbone in ((4, "efficientnet_b2"), (8, "efficientnet_b2"),
                         (16, "mobilenetv2_100")):
        for volume in ("gwc", "norm_correlation"):
            ESMStereoConfig(cv_scale=cv, backbone=backbone,
                            cost_volume=volume)
    # training mode runs (tests/test_torch_train_model.py holds it against
    # JAX) and returns every scale; the confidence model does not train yet
    model = ESMStereo(device="cpu")
    x = torch.randn(1, 32, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = model.train()(x, x)
    assert [tuple(o.shape) for o in outs] == [(1, 32, 64), (1, 16, 32)]
    with pytest.raises(NotImplementedError):
        ESMStereoConfidence(device="cpu").train()(x, x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        ESMStereo()
    assert resolve_device("cpu") == torch.device("cpu")
