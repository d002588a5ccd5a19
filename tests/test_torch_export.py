"""The port's export and native-serving path (``esmstereo_tpu_torch/
export``, ``ops/kernels/torch_ops.py``, ``eval/serve_e2e.py``), on the CPU.

  * C (the confidence model on S-norm) exported at 64x96, saved and loaded
    (``torch.export.save``/``load``), given seeded values on the JAX
    model's ``eval_shape`` tree (``state_dict_from_jax``), held against
    JAX's ``model.apply(..., train=False)`` at 1e-4 of max|JAX| on every
    element of both maps;
  * L and L-deploy (bf16, tanh GELU) exported at 64x96: each graph calls
    ``esmstereo::fused_stage0`` once, ``::correlation_volume`` once and
    the shared conv's operator of its form twice, and gives eager's output
    exactly;
  * each operator's fake kernel gives its CPU kernel's (the plain
    version's) shape and dtype in every form (``torch.library.opcheck``);
  * the schema table, the generated definitions source, the operators'
    CUDA registrations and the entry points they declare agree;
  * the numpy pre- and post-processing of ``eval/serve_e2e.py`` equal
    ``serving/src/stereo_pipeline.cc`` compiled here, bit for bit, and the
    5x5 median equals ``scipy.ndimage.median_filter(mode="nearest")``.

AOTInductor packaging and the C++ runner are CUDA-side: ``chip_smoke.py``
[8] runs them on the card. Exports are shared through module-scoped
fixtures.
"""

from __future__ import annotations

import concurrent.futures
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.models import confidence as jconf  # noqa: E402
from esmstereo_tpu_torch.eval import serve_e2e  # noqa: E402
from esmstereo_tpu_torch.export.program import (export_program,  # noqa: E402
                                                specs)
from esmstereo_tpu_torch.models.confidence import (  # noqa: E402
    ESMStereoConfidence)
from esmstereo_tpu_torch.models.convert_jax import state_dict_from_jax  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.nn import blocks  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import torch_ops  # noqa: E402
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import (  # noqa: E402
    conv_plan)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "esmstereo_tpu_torch" / "csrc"
H, W = 64, 96
S_NORM = dict(cv_scale=16, backbone="mobilenetv2_100",
              cost_volume="norm_correlation")
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def op_calls(ep) -> dict:
    """``{operator: calls}`` of the ``esmstereo::`` operators in ``ep``'s
    graph."""
    calls: dict = {}
    for node in ep.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("esmstereo."):
            name = target.split(".")[1]
            calls[name] = calls.get(name, 0) + 1
    return calls


def _pair(seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, H, W, 3)).astype(np.float32)
                 for _ in range(2))


def _jax_confidence(left: np.ndarray, right: np.ndarray):
    """The JAX confidence model with seeded values on its ``eval_shape``
    tree, and its two maps on the pair."""
    rng = np.random.default_rng(23)
    model = jconf.ESMStereoConfidence(JaxConfig(**S_NORM))
    small = np.zeros((1, 32, 64, 3), np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), small, small), rng)
    out = jax.jit(lambda v, l, r: model.apply(v, l, r, train=False),
                  compiler_options=FAST_COMPILE)(variables, left, right)
    return variables, [np.asarray(m) for m in out]


@pytest.fixture(scope="module")
def confidence_export(tmp_path_factory):
    """C exported at its seeded init weights, saved and loaded, then given
    the JAX tree's weights (``state_dict_from_jax``): the program, JAX's
    maps and the loaded program's. The loaded program computes with the
    weights it is given, so no weight is baked into the graph at export."""
    left, right = _pair(24)
    config = ESMStereoConfig(**S_NORM)
    # XLA compiles the JAX model while the port's is exported
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        reference = pool.submit(_jax_confidence, left, right)
        ep = export_program(ESMStereoConfidence(config, device="cpu"), H, W,
                            confidence=True)
        path = tmp_path_factory.mktemp("export") / "C.exported.pt2"
        torch.export.save(ep, path)
        loaded = torch.export.load(path).module()
        variables, want = reference.result()
    loaded.load_state_dict({f"model.{k}": v for k, v in state_dict_from_jax(
        variables, config).items()})
    with torch.no_grad():
        got = loaded(torch.from_numpy(left), torch.from_numpy(right))
    return ep, want, [g.numpy() for g in got]


def test_confidence_export_matches_jax(confidence_export):
    """Both maps of the loaded program within 1e-4 of max|JAX| on every
    element; the program's specs are JAX's (NHWC float32 in, two (1, H, W)
    maps out); A and B once each, the head plain."""
    ep, want, got = confidence_export
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, H, W)
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() < 1e-4 * np.abs(w).max()
    assert specs(ep) == ([((1, H, W, 3), torch.float32)] * 2,
                         [((1, H, W), torch.float32)] * 2)
    assert op_calls(ep) == {"fused_stage0": 1, "correlation_volume": 1}


@pytest.fixture(scope="module", params=["L", "L-deploy"])
def l_export(request):
    """L (fp32, exact GELU) or L-deploy (bf16, tanh GELU) at seeded init
    weights: its program, its output and eager's on one pair."""
    deploy = request.param == "L-deploy"
    config = ESMStereoConfig(dtype="bfloat16" if deploy else "float32")
    model = ESMStereo(config, device="cpu", seed=5)
    left, right = (torch.from_numpy(x) for x in _pair(6))
    before = blocks.GELU_APPROXIMATE
    blocks.set_gelu_approximate(deploy)
    try:
        ep = export_program(model, H, W)
        with torch.no_grad():
            got = ep.module()(left, right)
            want = model(left, right)[0]
    finally:
        blocks.set_gelu_approximate(before)
    return request.param, ep, got, want


def test_l_export_calls_each_kernel_and_equals_eager(l_export):
    name, ep, got, want = l_export
    conv = "conv3d_bn_gelu_bf16" if name == "L-deploy" else "conv3d_bn_gelu"
    assert op_calls(ep) == {"fused_stage0": 1, "correlation_volume": 1,
                            conv: 2}
    assert got.shape == want.shape == (1, H, W)
    assert torch.equal(got, want)


# --- the operators -----------------------------------------------------------

def _opcheck(name: str, *args) -> None:
    """The op's fake kernel against its CPU kernel on ``args``: shapes,
    dtypes, strides (``test_faketensor``), and the schema's mutation and
    alias annotations (``test_schema``)."""
    torch.library.opcheck(torch_ops.op(name).default, args,
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("form, out_dtype", [
    ("efficientnet_b2", torch.float32), ("efficientnet_b2", torch.bfloat16),
    ("mobilenetv2_100", torch.float32), ("mobilenetv2_100", torch.bfloat16)])
def test_fused_stage0_fake(form, out_dtype):
    from esmstereo_tpu_torch.ops.kernels import fused_head
    code, _, _ = fused_head.FORMS[form]
    size = {"efficientnet_b2": 2876, "mobilenetv2_100": 1744}[form]
    params = 0.1 * torch.randn(size, generator=torch.Generator()
                               .manual_seed(1))
    img = torch.randn(2, 3, 10, 14)
    _opcheck("fused_stage0", img, params, code,
             out_dtype == torch.bfloat16, [])


@pytest.mark.parametrize("dtype, groups, normalize, round_products", [
    (torch.float32, 32, False, True), (torch.float32, 1, True, True),
    (torch.bfloat16, 32, False, True), (torch.bfloat16, 1, True, True),
    (torch.bfloat16, 32, False, False), (torch.bfloat16, 32, True, False)])
def test_correlation_volume_fake(dtype, groups, normalize, round_products):
    ref, tgt = torch.randn(2, 1, 64, 3, 9).to(dtype).unbind(0)
    _opcheck("correlation_volume", ref, tgt, 5, groups, normalize,
             round_products, [])


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_fake(stride):
    x = torch.randn(1, 8, 5, 6, 7)
    w = torch.randn(4, 8, 3, 3, 3)
    _opcheck("conv3d_bn_gelu", x, w, torch.randn(4), stride, False, [])


@pytest.mark.parametrize("in_dtype, out_dtype, stride", [
    (torch.bfloat16, torch.bfloat16, 1), (torch.bfloat16, torch.bfloat16, 2),
    (torch.bfloat16, torch.float32, 1), (torch.int8, torch.bfloat16, 1),
    (torch.int8, torch.float32, 1)])
def test_conv3d_bf16_fake(in_dtype, out_dtype, stride):
    """The deploy forms, C's int8 volume among them; the fake kernel
    refuses an input the kernel does not take."""
    x = (torch.randn(1, 8, 5, 6, 7) * 20).to(in_dtype)
    w = torch.randn(8, 8, 3, 3, 3).to(torch.bfloat16)
    scale, shift = torch.rand(8) + 0.5, torch.randn(8)
    _opcheck("conv3d_bn_gelu_bf16", x, w, scale, shift,
             out_dtype == torch.float32, stride, True, [])
    xf = x.float()
    with pytest.raises(TypeError):
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            torch_ops.op("conv3d_bn_gelu_bf16")(
                mode.from_tensor(xf), mode.from_tensor(w),
                mode.from_tensor(scale), mode.from_tensor(shift), False,
                stride, True, [])


def test_schemas_and_definitions_agree():
    """The generated definitions source defines the table's schemas, in
    order, under one ``TORCH_LIBRARY``; the dispatcher holds those schemas;
    ``csrc/torch_ops.cpp`` registers a CUDA kernel for each, and counts
    them in the table's order."""
    src = torch_ops.defs_source()
    assert src.count("TORCH_LIBRARY(") == 1
    assert re.findall(r'm\.def\("([^"]*)"\);', src) == list(
        torch_ops.SCHEMAS.values())
    for name, schema in torch_ops.SCHEMAS.items():
        registered = torch_ops.op(name).default._schema
        assert str(registered) == f"esmstereo::{schema}"
    ops = (CSRC / "torch_ops.cpp").read_text()
    assert re.findall(r'm\.impl\("(\w+)"', ops) == list(torch_ops.SCHEMAS)
    names = re.search(r"kNames\[kOps\] = \{([^}]*)\}", ops).group(1)
    assert re.findall(r'"(\w+)"', names) == list(torch_ops.SCHEMAS)
    assert "TORCH_LIBRARY(" not in ops


def _c_params(src: str, fn: str) -> list:
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
    assert m, fn
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


@pytest.mark.parametrize("source, fn", [
    ("fused_head.cu", "stage0_params_size"), ("fused_head.cu", "fused_stage0"),
    ("correlation.cu", "correlation_volume"),
    ("fused_hourglass.cu", "conv3d_k3_bn_gelu"),
    ("fused_hourglass.cu", "conv3d_k3_bn_gelu_bf16")])
def test_ops_declare_the_entry_points(source, fn):
    """Each C entry point ``csrc/torch_ops.cpp`` calls has the parameter
    types of its definition (``extern "C"`` names carry no types, so a
    mismatch would link and then misread its arguments)."""
    ops = (CSRC / "torch_ops.cpp").read_text()
    assert _c_params(ops, fn) == _c_params((CSRC / source).read_text(), fn)


def test_conv_plan_ints_fit_the_op():
    """The plan the conv wrappers pass is the 16 ints the CUDA kernel
    checks against the call: B, CI, CO, D, H, W, stride, the dtype codes,
    and the GELU form at index 14."""
    ints = list(conv_plan("bf16", 32, 8, 12, 34, 62, 1).ints(1, True))
    assert len(ints) == 16
    assert ints[:9] == [1, 32, 8, 12, 34, 62, 1, 0, 0] and ints[14] == 1


# --- the serving pre- and post-processing -------------------------------------

def test_median5x5_matches_scipy(rng):
    x = rng.standard_normal((23, 37)).astype(np.float32)
    x[3:6, 4:9] = 0.5            # ties
    np.testing.assert_array_equal(
        serve_e2e.median5x5(x),
        scipy.ndimage.median_filter(x, size=5, mode="nearest"))


def test_pnm_round_trip(tmp_path, rng):
    u16 = rng.integers(0, 65536, (7, 11), dtype=np.uint16)
    serve_e2e.write_pgm16(str(tmp_path / "a.pgm"), u16)
    np.testing.assert_array_equal(serve_e2e.read_pgm16(
        str(tmp_path / "a.pgm")), u16)


_PIPELINE_MAIN = r"""
#include <cstdio>
#include <vector>
#include "stereo_pipeline.h"
// stdin: h w H W, h*w*3 uint8, H*W float disparity, H*W float confidence;
// stdout: the preprocessed image, the uint16 disparity, conf-masked, floats
int main() {
  int h, w, ph, pw;
  if (std::fread(&h, 4, 1, stdin) != 1 || std::fread(&w, 4, 1, stdin) != 1 ||
      std::fread(&ph, 4, 1, stdin) != 1 || std::fread(&pw, 4, 1, stdin) != 1)
    return 1;
  std::vector<unsigned char> rgb(h * w * 3);
  std::vector<float> disp(ph * pw), conf(ph * pw);
  if (std::fread(rgb.data(), 1, rgb.size(), stdin) != rgb.size() ||
      std::fread(disp.data(), 4, disp.size(), stdin) != disp.size() ||
      std::fread(conf.data(), 4, conf.size(), stdin) != conf.size())
    return 1;
  esmstereo::PreprocessConfig pre;
  pre.target = {ph, pw};
  std::vector<float> img;
  if (!esmstereo::PreprocessImage(rgb.data(), h, w, pre, &img)) return 1;
  esmstereo::PostprocessConfig post;
  post.padded = {ph, pw};
  post.original = {h, w};
  std::vector<uint16_t> d, dc;
  std::vector<float> c;
  esmstereo::PostprocessDisparity(disp.data(), post, &d);
  esmstereo::PostprocessDisparityConf(disp.data(), conf.data(), 0.5f, post,
                                      &dc, &c);
  std::fwrite(img.data(), 4, img.size(), stdout);
  std::fwrite(d.data(), 2, d.size(), stdout);
  std::fwrite(dc.data(), 2, dc.size(), stdout);
  std::fwrite(c.data(), 4, c.size(), stdout);
  return 0;
}
"""


def test_pre_and_post_processing_match_the_pipeline(tmp_path, rng):
    """``preprocess``, ``postprocess`` (with and without the confidence
    mask) and the cropped confidence against ``serving/src/
    stereo_pipeline.cc`` compiled with ``g++``, bit for bit, on a padded
    frame whose disparity crosses 0 and max_disp."""
    main = tmp_path / "main.cc"
    main.write_text(_PIPELINE_MAIN)
    binary = tmp_path / "pipeline"
    subprocess.run(["g++", "-std=c++17", "-O2", "-I",
                    str(ROOT / "serving" / "include"), str(main),
                    str(ROOT / "serving" / "src" / "stereo_pipeline.cc"),
                    "-o", str(binary)], check=True, timeout=120)
    h, w, ph, pw = 29, 45, 32, 64
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    disp = rng.uniform(-20, 220, (ph, pw)).astype(np.float32)
    disp[:16, :12] = -3.0            # below 0 and above max_disp (192)
    disp[16:, 40:] = 200.0
    conf = rng.random((ph, pw)).astype(np.float32)
    stdin = (np.array([h, w, ph, pw], np.int32).tobytes() + rgb.tobytes()
             + disp.tobytes() + conf.tobytes())
    out = subprocess.run([str(binary)], input=stdin, capture_output=True,
                         check=True, timeout=60).stdout
    sizes = [ph * pw * 3 * 4, h * w * 2, h * w * 2, h * w * 4]
    parts = np.split(np.frombuffer(out, np.uint8), np.cumsum(sizes)[:-1])
    img = parts[0].view(np.float32).reshape(1, ph, pw, 3)
    d, dc = (p.view(np.uint16).reshape(h, w) for p in parts[1:3])
    c = parts[3].view(np.float32).reshape(h, w)
    np.testing.assert_array_equal(serve_e2e.preprocess(rgb, ph, pw), img)
    np.testing.assert_array_equal(serve_e2e.postprocess(disp, (h, w)), d)
    got_dc, got_c = serve_e2e.postprocess(disp, (h, w), conf=conf)
    np.testing.assert_array_equal(got_dc, dc)
    np.testing.assert_array_equal(got_c, c)
    assert 0 < (d > 0).sum() < d.size and (dc > 0).sum() < (d > 0).sum()
