// Native serving of the stereo model on one CUDA card: an AOTInductor
// package (esmstereo_tpu_torch/cli/export.py) run from C++, with no Python.
//
// Counterpart of serving/include/pjrt_runner.h: where the JAX package hands
// a StableHLO module to a PJRT plugin, the port opens the package that
// torch._inductor.aoti_compile_and_package wrote. The package calls the
// hand kernels as esmstereo:: operators through the dispatcher, so the
// runner first loads the definitions library (their schemas) and then the
// ops library (their CUDA kernels, esmstereo_tpu_torch/csrc/torch_ops.cpp);
// an operator the package calls and these libraries lack fails the load or
// the run, loudly. It serves at the eager path's numerics: TF32 off for
// cuDNN and cuBLAS (esmstereo_tpu_torch/eval/runner.py::fp32_precision), and
// cuDNN's deterministic algorithms, so that a frame repeats bit for bit.

#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <utility>
#include <vector>

#include <ATen/Tensor.h>

namespace torch::inductor {
class AOTIModelPackageLoader;
}

namespace esmstereo {

class AotiRunner {
 public:
  // defs_lib, ops_lib: the two shared libraries (esmstereo_tpu_torch/ops/
  // kernels/_build.py); package: a .pt2 AOTInductor package for CUDA.
  // Throws std::runtime_error (or c10::Error) on any failure.
  AotiRunner(const std::string& defs_lib, const std::string& ops_lib,
             const std::string& package);
  ~AotiRunner();

  AotiRunner(const AotiRunner&) = delete;
  AotiRunner& operator=(const AotiRunner&) = delete;

  // A float32 host tensor: (dims, data).
  struct Tensor {
    std::vector<int64_t> dims;
    std::vector<float> data;
  };

  // One frame: upload, run, read back.
  std::vector<Tensor> Execute(const std::vector<Tensor>& inputs);

  // --- the steady-state pieces ---------------------------------------------
  // Host tensors -> device tensors (blocks until copied).
  std::vector<at::Tensor> Upload(const std::vector<Tensor>& inputs);
  // One run on device tensors, on the current stream; does not wait.
  std::vector<at::Tensor> Run(const std::vector<at::Tensor>& inputs);
  // Device tensors -> float32 host tensors (waits for the device).
  std::vector<Tensor> Read(const std::vector<at::Tensor>& outputs);

  // Steady-state frame time. The inputs upload once; `warmup` frames are
  // discarded, then each of `frames` runs and reads its outputs back, timed
  // by the host clock around the run and the read, and by CUDA events
  // around the run on its stream. `last_outputs` gets the last frame's.
  struct TimedStats {
    int frames = 0;
    double host_ms_mean = 0.0, host_ms_median = 0.0;
    double device_ms_mean = 0.0, device_ms_median = 0.0;
  };
  TimedStats TimedRun(const std::vector<Tensor>& inputs, int warmup,
                      int frames, std::vector<Tensor>* last_outputs);

  // Runs of the package since the runner opened it.
  int runs() const { return runs_; }
  // (operator name, CUDA launches) counted by the ops library.
  std::vector<std::pair<std::string, long long>> Launches() const;
  // The settings the runner serves at, in words.
  std::string Precision() const;

 private:
  void* defs_ = nullptr;
  void* ops_ = nullptr;
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader_;
  int runs_ = 0;
};

}  // namespace esmstereo
