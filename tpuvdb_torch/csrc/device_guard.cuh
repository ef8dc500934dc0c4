// The launchers' switch to the tensors' card (csrc/scan.cu, ivf_probe.cu,
// pq_probe.cu). A launch makes `device` current for its own calls and gives
// the calling thread back the device it had on every return path: on a
// mesh, a search thread launches on each slot's card in turn, and a device
// left behind by one launch would take every later allocation of the
// caller that names no device.

#pragma once

#include <cuda_runtime.h>

namespace {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device) {
      status_ = cudaSetDevice(device);
      restore_ = status_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t status() const { return status_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t status_;
};

}  // namespace
