// Host code shared by the port's CUDA sources: the error string every
// library exports for chamjax_torch/utils/cuda_lib.py, and the launch
// plumbing of the hand-written attention kernels (decode_attend.cu,
// latent_attend.cu, encode_attend.cu).  No device code.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* chamjax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace chamjax {

// A grid of (chunks, b) CTAs of `threads` threads, one cluster of `chunks`
// CTAs a row; `cluster` holds the attribute the config points to, so it
// lives as long as the config.
inline cudaLaunchConfig_t row_clusters(int b, int chunks, int threads,
                                       size_t smem,
                                       cudaLaunchAttribute* cluster,
                                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = chunks;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// The most CTAs a row (max_chunks, halved down to 2; else 1) at which all
// b rows' clusters of `kernel` are resident at once on the current device:
// one wave (a second wave of clusters doubles the time of the few it
// holds).
template <typename Kernel>
cudaError_t resident_chunks(Kernel kernel, int b, int max_chunks,
                            int threads, size_t smem, int* chunks) {
  for (int c = max_chunks; c > 1; c /= 2) {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg =
        row_clusters(b, c, threads, smem, &cluster, nullptr);
    int resident = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (resident >= b) {
      *chunks = c;
      return cudaSuccess;
    }
  }
  *chunks = 1;
  return cudaSuccess;
}

// Above 48 KB of shared memory a kernel has to ask for it: once a device
// for each kernel, so that no launch inside a graph capture asks again.
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

}  // namespace chamjax
