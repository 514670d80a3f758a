// Tiled ADC scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chamjax/ops/scan_seg_block.py::adc_scan_tiles
// (body _adc_block_kernel).  For every window w:
//
//   dist[w, r] = sum_j LUT[lut_idx[w]][j, codes_tiled[tile_idx[w]][j, r]]
//
// for r < lens[w], +inf beyond.  LUT rows are (m, 256) f32, or packed bf16
// pairs (m, 128) int32 (entry 2c in the low half, 2c+1 in the high half).
// Outputs: (bW, seg) f32, (bW, seg) bf16 (dist_bf16), or (bW, 2, 128) f32
// (lane_l1: per-lane min over the window's seg/128 row groups, then the
// winning group index as int32 bits).
//
// Bound on an H100 SXM (3.35 TB/s HBM; the adds are negligible next to the
// bytes): at the flagship shape (m=16, seg=512, bW=4096, packed LUTs) the
// kernel must read codes 4096*16*512 = 33.6 MB and LUT rows 4096*8 KB =
// 33.6 MB (67 MB with f32 LUTs) and write 4096*512*4 = 8.4 MB of f32
// distances: ~75.5 MB, ~22.5 us.  It is bound by bytes.
//
// This first design is the simple one: one CTA of 128 threads per window.
// The CTA stages its window's LUT row in shared memory with 16-byte loads
// (8 KB packed / 16 KB f32 at m=16; above 48 KB it opts in to more dynamic
// shared memory), so every code lookup is a shared-memory gather instead of
// a global one.  Thread t owns rows t, t+128, ... (the TPU kernel's lane
// layout), reads the m code bytes of each row along the tile (neighbouring
// threads read neighbouring bytes, so loads coalesce), sums in fp32 and
// writes coalesced.  Rows at or past lens[w] read no codes; an empty
// window reads nothing.  Reusing one LUT row across a probe's consecutive
// windows, TMA staging and wider code loads are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

enum OutMode { kOutF32 = 0, kOutBF16 = 1, kOutLaneL1 = 2 };

template <bool kPacked>
__device__ __forceinline__ float lut_entry(const uint32_t* __restrict__ lut,
                                           int j, uint32_t c) {
  if (kPacked) {
    // one 32-bit word holds entries (2p, 2p+1): an odd code keeps the high
    // half in place, an even code moves the low half up (bf16 -> f32 bits)
    const uint32_t v = lut[j * 128 + (c >> 1)];
    return __uint_as_float((c & 1u) ? (v & 0xFFFF0000u) : (v << 16));
  }
  return __uint_as_float(lut[j * 256 + c]);
}

template <bool kPacked, int kOut>
__global__ void __launch_bounds__(kLanes)
adc_scan_tiles_kernel(const uint8_t* __restrict__ codes,
                      const int32_t* __restrict__ tile_idx,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ lut_idx,
                      const uint32_t* __restrict__ luts,
                      void* __restrict__ out, int m, int seg) {
  extern __shared__ uint4 smem[];
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  const int len = lens[w];
  const int groups = seg / kLanes;
  const float inf = __int_as_float(0x7f800000);

  if (len > 0) {
    constexpr int kWords = kPacked ? 128 : 256;
    const int n16 = m * kWords / 4;   // 16-byte chunks in one LUT row
    const uint4* src = reinterpret_cast<const uint4*>(
        luts + static_cast<int64_t>(lut_idx[w]) * m * kWords);
    for (int i = t; i < n16; i += kLanes) smem[i] = src[i];
    __syncthreads();
  }
  const uint8_t* tile =
      codes + static_cast<int64_t>(tile_idx[w]) * m * seg;

  float best = inf;
  int best_g = 0;
  for (int g = 0; g < groups; ++g) {
    const int r = g * kLanes + t;
    float acc = inf;
    if (r < len) {
      acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        acc += lut_entry<kPacked>(lut, j, tile[j * seg + r]);
      }
    }
    if (kOut == kOutLaneL1) {
      if (acc < best) {   // strict: the first group wins ties
        best = acc;
        best_g = g;
      }
    } else if (kOut == kOutBF16) {
      static_cast<__nv_bfloat16*>(out)[w * seg + r] = __float2bfloat16_rn(acc);
    } else {
      static_cast<float*>(out)[w * seg + r] = acc;
    }
  }
  if (kOut == kOutLaneL1) {
    float* o = static_cast<float*>(out) + w * 2 * kLanes;
    o[t] = best;
    o[kLanes + t] = __int_as_float(best_g);
  }
}

template <bool kPacked, int kOut>
cudaError_t launch(const uint8_t* codes, const int32_t* tile_idx,
                   const int32_t* lens, const int32_t* lut_idx,
                   const uint32_t* luts, void* out, int bw, int m, int seg,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * (kPacked ? 128 : 256) * 4;
  auto kernel = adc_scan_tiles_kernel<kPacked, kOut>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<bw, kLanes, smem, stream>>>(codes, tile_idx, lens, lut_idx, luts,
                                       out, m, seg);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; the launch goes on `stream` and does not synchronise.  Returns
// a cudaError_t (0 = success).
extern "C" int chamjax_adc_scan_tiles(const void* codes_tiled,
                                      const void* tile_idx, const void* lens,
                                      const void* lut_idx, const void* luts,
                                      void* out, int bw, int m, int seg,
                                      int lut_bf16, int out_mode,
                                      void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes_tiled);
  const auto* ti = static_cast<const int32_t*>(tile_idx);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* li = static_cast<const int32_t*>(lut_idx);
  const auto* lu = static_cast<const uint32_t*>(luts);
  auto s = static_cast<cudaStream_t>(stream);
  if (bw <= 0 || m <= 0 || seg <= 0 || seg % kLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  if (lut_bf16) {
    if (out_mode == kOutBF16) {
      e = launch<true, kOutBF16>(c, ti, ln, li, lu, out, bw, m, seg, s);
    } else if (out_mode == kOutLaneL1) {
      e = launch<true, kOutLaneL1>(c, ti, ln, li, lu, out, bw, m, seg, s);
    } else {
      e = launch<true, kOutF32>(c, ti, ln, li, lu, out, bw, m, seg, s);
    }
  } else {
    if (out_mode == kOutBF16) {
      e = launch<false, kOutBF16>(c, ti, ln, li, lu, out, bw, m, seg, s);
    } else if (out_mode == kOutLaneL1) {
      e = launch<false, kOutLaneL1>(c, ti, ln, li, lu, out, bw, m, seg, s);
    } else {
      e = launch<false, kOutF32>(c, ti, ln, li, lu, out, bw, m, seg, s);
    }
  }
  return static_cast<int>(e);
}

extern "C" const char* chamjax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
