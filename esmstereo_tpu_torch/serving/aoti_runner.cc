#include "aoti_runner.h"

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <numeric>
#include <stdexcept>

#include <ATen/Context.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/from_blob.h>
#include <c10/core/Event.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

namespace esmstereo {

namespace {

void* Open(const std::string& path) {
  // RTLD_GLOBAL: the ops library's kernels and counters stay reachable
  void* handle = dlopen(path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (handle == nullptr)
    throw std::runtime_error("cannot load " + path + ": " + dlerror());
  return handle;
}

template <typename Fn>
Fn Symbol(void* lib, const char* name) {
  void* sym = dlsym(lib, name);
  if (sym == nullptr)
    throw std::runtime_error(std::string("the ops library lacks ") + name);
  return reinterpret_cast<Fn>(sym);
}

double Median(std::vector<double> v) {
  std::sort(v.begin(), v.end());
  const size_t n = v.size();
  return n % 2 ? v[n / 2] : 0.5 * (v[n / 2 - 1] + v[n / 2]);
}

double Mean(const std::vector<double>& v) {
  return std::accumulate(v.begin(), v.end(), 0.0) / v.size();
}

}  // namespace

AotiRunner::AotiRunner(const std::string& defs_lib, const std::string& ops_lib,
                       const std::string& package) {
  // The eager path's numerics: fp32 convolutions and matmuls without TF32
  // (Inductor's extern convolutions read these at run time), and cuDNN's
  // deterministic algorithms.
  at::globalContext().setAllowTF32CuDNN(false);
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setDeterministicCuDNN(true);
  // the schemas before their kernels, both before the package resolves
  // its operator calls
  defs_ = Open(defs_lib);
  ops_ = Open(ops_lib);
  Symbol<void (*)()>(ops_, "esmstereo_reset_op_launches")();
  loader_ = std::make_unique<torch::inductor::AOTIModelPackageLoader>(package);
}

AotiRunner::~AotiRunner() {
  loader_.reset();
  // the libraries stay loaded: the dispatcher holds their registrations
}

std::vector<at::Tensor> AotiRunner::Upload(const std::vector<Tensor>& inputs) {
  std::vector<at::Tensor> out;
  for (const Tensor& t : inputs) {
    at::Tensor host = at::from_blob(const_cast<float*>(t.data.data()),
                                    t.dims, at::kFloat);
    out.push_back(host.to(at::kCUDA));
  }
  c10::cuda::device_synchronize();
  return out;
}

std::vector<at::Tensor> AotiRunner::Run(const std::vector<at::Tensor>& inputs) {
  ++runs_;
  return loader_->run(inputs, c10::cuda::getCurrentCUDAStream().stream());
}

std::vector<AotiRunner::Tensor> AotiRunner::Read(
    const std::vector<at::Tensor>& outputs) {
  std::vector<Tensor> out;
  for (const at::Tensor& t : outputs) {
    at::Tensor host = t.to(at::kCPU, at::kFloat).contiguous();
    Tensor h;
    h.dims.assign(host.sizes().begin(), host.sizes().end());
    h.data.assign(host.data_ptr<float>(), host.data_ptr<float>() + host.numel());
    out.push_back(std::move(h));
  }
  return out;
}

std::vector<AotiRunner::Tensor> AotiRunner::Execute(
    const std::vector<Tensor>& inputs) {
  return Read(Run(Upload(inputs)));
}

AotiRunner::TimedStats AotiRunner::TimedRun(const std::vector<Tensor>& inputs,
                                            int warmup, int frames,
                                            std::vector<Tensor>* last_outputs) {
  const std::vector<at::Tensor> dev = Upload(inputs);
  for (int i = 0; i < warmup; ++i) Read(Run(dev));
  const c10::Stream stream = c10::cuda::getCurrentCUDAStream();
  std::vector<double> host_ms, device_ms;
  for (int i = 0; i < frames; ++i) {
    c10::Event start(c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT);
    c10::Event end(c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT);
    const auto t0 = std::chrono::steady_clock::now();
    start.record(stream);
    std::vector<at::Tensor> out = Run(dev);
    end.record(stream);
    std::vector<Tensor> host = Read(out);
    const auto t1 = std::chrono::steady_clock::now();
    end.synchronize();
    host_ms.push_back(std::chrono::duration<double, std::milli>(t1 - t0)
                          .count());
    device_ms.push_back(start.elapsedTime(end));
    if (last_outputs != nullptr && i == frames - 1)
      *last_outputs = std::move(host);
  }
  TimedStats st;
  st.frames = frames;
  if (frames > 0) {
    st.host_ms_mean = Mean(host_ms);
    st.host_ms_median = Median(host_ms);
    st.device_ms_mean = Mean(device_ms);
    st.device_ms_median = Median(device_ms);
  }
  return st;
}

std::vector<std::pair<std::string, long long>> AotiRunner::Launches() const {
  const auto count = Symbol<int (*)()>(ops_, "esmstereo_ops_count");
  const auto name = Symbol<const char* (*)(int)>(ops_, "esmstereo_op_name");
  const auto launches =
      Symbol<long long (*)(int)>(ops_, "esmstereo_op_launches");
  std::vector<std::pair<std::string, long long>> out;
  for (int i = 0; i < count(); ++i) out.emplace_back(name(i), launches(i));
  return out;
}

std::string AotiRunner::Precision() const {
  auto& ctx = at::globalContext();
  return std::string("TF32 ") + (ctx.allowTF32CuDNN() ? "on" : "off") +
         " for cuDNN, " + (ctx.allowTF32CuBLAS() ? "on" : "off") +
         " for cuBLAS; cuDNN deterministic " +
         (ctx.deterministicCuDNN() ? "on" : "off");
}

}  // namespace esmstereo
