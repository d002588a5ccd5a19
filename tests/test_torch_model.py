"""PyTorch port: ESMStereo-L against the JAX package's default-config model.

The JAX model's variables (seeded numpy values on its ``eval_shape`` tree)
cross to the port through ``models.convert_jax.state_dict_from_jax``; both
models then run one 64x128 pair in fp32 on the CPU. Also the weight
bridge's refusals, the inference runner, and the slice's guards.
"""

from __future__ import annotations

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
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

H, W = 64, 128
L_PARAMS = 6_796_056          # ACCURACY.json, the L row


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
    shapes = jax.eval_shape(model.init, jax.random.key(0), left, right)
    variables = random_variables(shapes, rng)
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
    for kw in ({"cv_scale": 8}, {"backbone": "mobilenetv2_100"},
               {"cost_volume": "norm_correlation"}, {"dtype": "bfloat16"}):
        with pytest.raises(NotImplementedError):
            ESMStereoConfig(**kw)
    model = ESMStereo(device="cpu")
    x = torch.zeros(1, 32, 64, 3)
    with pytest.raises(NotImplementedError):
        model.train()(x, x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        ESMStereo()
    assert resolve_device("cpu") == torch.device("cpu")
