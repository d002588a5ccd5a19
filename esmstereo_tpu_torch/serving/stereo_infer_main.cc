// stereo_infer: serve an AOTInductor package of the stereo model on an image
// pair, on one CUDA card, with no Python.
//
// Counterpart of serving/src/stereo_infer_main.cc (the PJRT runner):
//   .stablehlo.mlir + PJRT Execute  ->  .pt2 + AOTIModelPackageLoader.
// Its pre- and post-processing are that runner's, serving/src/
// stereo_pipeline.cc, and its evaluation serving/src/stereo_eval.cc, both
// compiled in by path (esmstereo_tpu_torch/serving/build.py). There is no
// OpenCV: images are binary PPM (P6), or raw uint8 RGB of --image_height x
// --image_width; the disparity (uint16, x256) and the confidence map
// (uint16, x65535) are written as 16-bit PGM (P5) to a path ending in .pgm,
// else as raw little-endian uint16.
//
// Usage:
//   stereo_infer --model StereoModel.pt2 --left l.ppm --right r.ppm
//       --out disp.pgm [--height 384 --width 1248] [--max_disp 192]
//       [--image_height H --image_width W]          (raw uint8 RGB inputs)
//       [--conf_out conf.pgm --conf_threshold 0.5]  (2-output packages)
//       [--gt gt.pgm]                               (uint16 x256, 0 invalid)
//       [--frames 50 --warmup 3]                    (steady-state timing)
//
// Prints one JSON line on stdout: the runs of the package, each operator's
// CUDA launches, the steady-state ms a frame with --frames, EPE and D1 with
// --gt. Everything else goes to stderr. Exit code 0 on success, 1 on a
// failure, 2 on bad arguments.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <exception>
#include <fstream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "aoti_runner.h"
#include "stereo_eval.h"
#include "stereo_pipeline.h"

#ifndef ESMSTEREO_DEFS_LIB
#error "build with -DESMSTEREO_DEFS_LIB=<path> (esmstereo_tpu_torch/serving/build.py)"
#endif
#ifndef ESMSTEREO_OPS_LIB
#error "build with -DESMSTEREO_OPS_LIB=<path> (esmstereo_tpu_torch/serving/build.py)"
#endif

namespace {

struct Options {
  std::string model, left, right, out, conf_out, gt;
  int height = 384, width = 1248;
  int image_height = 0, image_width = 0;  // raw inputs; 0: the engine's
  float max_disp = 192.0f;
  float conf_threshold = 0.5f;
  int frames = 0, warmup = 3;
};

bool ParseArgs(int argc, char** argv, Options* o) {
  if (argc % 2 == 0) return false;
  for (int i = 1; i + 1 < argc; i += 2) {
    const std::string k = argv[i], v = argv[i + 1];
    if (k == "--model") o->model = v;
    else if (k == "--left") o->left = v;
    else if (k == "--right") o->right = v;
    else if (k == "--out") o->out = v;
    else if (k == "--conf_out") o->conf_out = v;
    else if (k == "--conf_threshold") o->conf_threshold = std::stof(v);
    else if (k == "--gt") o->gt = v;
    else if (k == "--frames") o->frames = std::stoi(v);
    else if (k == "--warmup") o->warmup = std::stoi(v);
    else if (k == "--height") o->height = std::stoi(v);
    else if (k == "--width") o->width = std::stoi(v);
    else if (k == "--image_height") o->image_height = std::stoi(v);
    else if (k == "--image_width") o->image_width = std::stoi(v);
    else if (k == "--max_disp") o->max_disp = std::stof(v);
    else { std::fprintf(stderr, "unknown flag %s\n", k.c_str()); return false; }
  }
  return !o->model.empty() && !o->left.empty() && !o->right.empty() &&
         !o->out.empty();
}

bool EndsWith(const std::string& s, const std::string& suffix) {
  return s.size() >= suffix.size() &&
         s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot read " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// A binary PNM header (P5 or P6): magic, width, height, maxval, one
// whitespace byte; comments skipped. Returns the offset of the pixels.
size_t PnmHeader(const std::string& data, const char* magic, int* w, int* h,
                 int* maxval) {
  if (data.compare(0, 2, magic) != 0)
    throw std::runtime_error(std::string("not a ") + magic + " file");
  size_t pos = 2;
  int* fields[3] = {w, h, maxval};
  for (int* field : fields) {
    while (pos < data.size() && (std::isspace(static_cast<unsigned char>(
                                     data[pos])) || data[pos] == '#')) {
      if (data[pos] == '#') pos = data.find('\n', pos);
      else ++pos;
    }
    size_t end = pos;
    while (end < data.size() && std::isdigit(static_cast<unsigned char>(
                                    data[end])))
      ++end;
    if (end == pos) throw std::runtime_error("bad PNM header");
    *field = std::stoi(data.substr(pos, end - pos));
    pos = end;
  }
  return pos + 1;
}

// uint8 RGB, HWC.
std::vector<uint8_t> ReadRgb(const std::string& path, const Options& o,
                             int* h, int* w) {
  const std::string data = ReadFile(path);
  size_t offset = 0;
  if (EndsWith(path, ".ppm")) {
    int maxval = 0;
    offset = PnmHeader(data, "P6", w, h, &maxval);
    if (maxval != 255) throw std::runtime_error(path + ": maxval not 255");
  } else {
    *h = o.image_height > 0 ? o.image_height : o.height;
    *w = o.image_width > 0 ? o.image_width : o.width;
  }
  const size_t n = static_cast<size_t>(*h) * *w * 3;
  if (data.size() - offset != n)
    throw std::runtime_error(path + ": " + std::to_string(data.size() - offset)
                             + " bytes of pixels, not " + std::to_string(n));
  return std::vector<uint8_t>(data.begin() + offset, data.end());
}

// uint16 map, row-major: 16-bit PGM (big-endian) or raw little-endian.
std::vector<uint16_t> ReadU16(const std::string& path, int h, int w) {
  const std::string data = ReadFile(path);
  const bool pgm = EndsWith(path, ".pgm");
  size_t offset = 0;
  if (pgm) {
    int pw = 0, ph = 0, maxval = 0;
    offset = PnmHeader(data, "P5", &pw, &ph, &maxval);
    if (pw != w || ph != h || maxval != 65535)
      throw std::runtime_error(path + ": not a 16-bit PGM of the image size");
  }
  const size_t n = static_cast<size_t>(h) * w;
  if (data.size() - offset != 2 * n)
    throw std::runtime_error(path + ": wrong size");
  std::vector<uint16_t> out(n);
  const auto* p = reinterpret_cast<const uint8_t*>(data.data() + offset);
  for (size_t i = 0; i < n; ++i)
    out[i] = static_cast<uint16_t>(pgm ? (p[2 * i] << 8) | p[2 * i + 1]
                                       : p[2 * i] | (p[2 * i + 1] << 8));
  return out;
}

void WriteU16(const std::string& path, const std::vector<uint16_t>& v, int h,
              int w) {
  std::ofstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot write " + path);
  const bool pgm = EndsWith(path, ".pgm");
  if (pgm) f << "P5\n" << w << " " << h << "\n65535\n";
  std::vector<uint8_t> bytes(2 * v.size());
  for (size_t i = 0; i < v.size(); ++i) {
    const uint8_t hi = v[i] >> 8, lo = v[i] & 0xff;
    bytes[2 * i] = pgm ? hi : lo;
    bytes[2 * i + 1] = pgm ? lo : hi;
  }
  f.write(reinterpret_cast<const char*>(bytes.data()), bytes.size());
  if (!f) throw std::runtime_error("cannot write " + path);
}

int Serve(const Options& opt) {
  int lh = 0, lw = 0, rh = 0, rw = 0;
  const std::vector<uint8_t> left = ReadRgb(opt.left, opt, &lh, &lw);
  const std::vector<uint8_t> right = ReadRgb(opt.right, opt, &rh, &rw);
  if (lh != rh || lw != rw) {
    std::fprintf(stderr, "left %dx%d and right %dx%d differ\n", lh, lw, rh,
                 rw);
    return 1;
  }
  esmstereo::PreprocessConfig pre;
  pre.target = {opt.height, opt.width};
  std::vector<esmstereo::AotiRunner::Tensor> inputs(2);
  if (!esmstereo::PreprocessImage(left.data(), lh, lw, pre, &inputs[0].data) ||
      !esmstereo::PreprocessImage(right.data(), rh, rw, pre,
                                  &inputs[1].data)) {
    std::fprintf(stderr, "image %dx%d larger than the package's %dx%d\n", lh,
                 lw, opt.height, opt.width);
    return 1;
  }
  for (auto& t : inputs) t.dims = {1, opt.height, opt.width, 3};

  esmstereo::AotiRunner runner(ESMSTEREO_DEFS_LIB, ESMSTEREO_OPS_LIB,
                               opt.model);
  std::fprintf(stderr, "precision: %s\n", runner.Precision().c_str());

  std::ostringstream json;
  std::vector<esmstereo::AotiRunner::Tensor> outputs;
  if (opt.frames > 0) {
    const auto st = runner.TimedRun(inputs, opt.warmup, opt.frames, &outputs);
    char buf[256];
    std::snprintf(buf, sizeof(buf),
                  "\"frames\": %d, \"warmup\": %d, \"host_ms_mean\": %.4f, "
                  "\"host_ms_median\": %.4f, \"device_ms_mean\": %.4f, "
                  "\"device_ms_median\": %.4f, ",
                  st.frames, opt.warmup, st.host_ms_mean, st.host_ms_median,
                  st.device_ms_mean, st.device_ms_median);
    json << buf;
  } else {
    outputs = runner.Execute(inputs);
  }
  const size_t pixels = static_cast<size_t>(opt.height) * opt.width;
  for (const auto& t : outputs) {
    if (t.data.size() != pixels) {
      std::fprintf(stderr, "an output of %zu values, not %dx%d\n",
                   t.data.size(), opt.height, opt.width);
      return 1;
    }
  }

  esmstereo::PostprocessConfig post;
  post.padded = {opt.height, opt.width};
  post.original = {lh, lw};
  post.max_disp = opt.max_disp;
  std::vector<uint16_t> disp;
  std::vector<float> conf;
  const bool has_conf = outputs.size() >= 2;
  if (has_conf) {
    esmstereo::PostprocessDisparityConf(outputs[0].data.data(),
                                        outputs[1].data.data(),
                                        opt.conf_threshold, post, &disp,
                                        &conf);
  } else {
    esmstereo::PostprocessDisparity(outputs[0].data.data(), post, &disp);
  }
  WriteU16(opt.out, disp, lh, lw);
  std::fprintf(stderr, "wrote %s\n", opt.out.c_str());
  if (has_conf && !opt.conf_out.empty()) {
    std::vector<uint16_t> conf16(conf.size());
    for (size_t i = 0; i < conf.size(); ++i)
      conf16[i] = static_cast<uint16_t>(
          std::min(std::max(conf[i], 0.0f), 1.0f) * 65535.0f);
    WriteU16(opt.conf_out, conf16, lh, lw);
    std::fprintf(stderr, "wrote %s (confidence x65535, threshold %.2f)\n",
                 opt.conf_out.c_str(), opt.conf_threshold);
  }
  if (!opt.gt.empty()) {
    const std::vector<uint16_t> gt16 = ReadU16(opt.gt, lh, lw);
    std::vector<float> est(disp.size()), gt(disp.size());
    for (size_t i = 0; i < disp.size(); ++i) {
      est[i] = disp[i] / 256.0f;
      gt[i] = gt16[i] / 256.0f;
    }
    const auto r = esmstereo::EvaluateDisparity(est.data(), gt.data(), lh, lw,
                                                opt.max_disp);
    char buf[160];
    std::snprintf(buf, sizeof(buf),
                  "\"epe\": %.6f, \"d1\": %.6f, \"bad3\": %.6f, "
                  "\"valid_pixels\": %d, ",
                  r.epe, r.d1, r.bad3, r.valid_pixels);
    json << buf;
  }
  json << "\"runs\": " << runner.runs() << ", \"launches\": {";
  const auto launches = runner.Launches();
  for (size_t i = 0; i < launches.size(); ++i)
    json << (i ? ", " : "") << "\"" << launches[i].first
         << "\": " << launches[i].second;
  json << "}";
  std::printf("{%s}\n", json.str().c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  Options opt;
  if (!ParseArgs(argc, argv, &opt)) {
    std::fprintf(stderr, "required: --model --left --right --out\n");
    return 2;
  }
  try {
    return Serve(opt);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "stereo_infer: %s\n", e.what());
    return 1;
  }
}
