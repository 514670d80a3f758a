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
//
// Two measurement bodies (debug_ablate of the TPU kernel, used by
// chamjax_torch/benchmarks/kernel_roofline.py) keep the production body's
// memory traffic, the LUT row staged and every code byte of the tile read
// once, but ignore lens and never gather: "copy" writes float(code[0, r])
// and "nogather" the integer sum over j of code[j, r].  copy's loads of rows
// 1..m-1 feed an XOR stored only when the runtime argument `never` is
// non-zero (the wrapper passes 0), so the compiler keeps them.  Checked in
// the SASS (chamjax_torch/benchmarks/sass_report.py, nvcc 12.8, sm_90a):
// both bodies keep the production body's byte code loads (15 LDG.E.U8 in
// the unrolled loop) and its 16-byte LUT-row loads and shared stores, and
// issue no shared-memory gather (no LDS).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

enum OutMode { kOutF32 = 0, kOutBF16 = 1, kOutLaneL1 = 2 };
enum Body { kBodyAdc = 0, kBodyCopy = 1, kBodyNoGather = 2 };

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

template <bool kPacked, int kOut, int kBody>
__global__ void __launch_bounds__(kLanes)
adc_scan_tiles_kernel(const uint8_t* __restrict__ codes,
                      const int32_t* __restrict__ tile_idx,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ lut_idx,
                      const uint32_t* __restrict__ luts,
                      void* __restrict__ out, int m, int seg, int never) {
  extern __shared__ uint4 smem[];
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  // the measurement bodies ignore lens: every row is read and written
  const int len = kBody == kBodyAdc ? lens[w] : seg;
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
  uint32_t sink = 0;
  for (int g = 0; g < groups; ++g) {
    const int r = g * kLanes + t;
    float acc = inf;
    if constexpr (kBody == kBodyCopy) {
      // the production loop's shape over j = 0..m-1: a row-0 load apart
      // and a loop over 1..m-1 left a remainder of loads that ran one at a
      // time, and doubled this body's time on the card
      uint32_t first = 0;
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        const uint32_t v = tile[j * seg + r];
        if (j == 0) {
          first = v;
        } else {
          sink ^= v;
        }
      }
      acc = static_cast<float>(first);
    } else if constexpr (kBody == kBodyNoGather) {
      uint32_t s = 0;
#pragma unroll 8
      for (int j = 0; j < m; ++j) s += tile[j * seg + r];
      acc = static_cast<float>(s);
    } else if (r < len) {
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
  if constexpr (kBody == kBodyCopy) {
    if (never) {
      const float x = __uint_as_float(sink);
      if (kOut == kOutBF16) {
        static_cast<__nv_bfloat16*>(out)[w * seg + t] = __float2bfloat16_rn(x);
      } else {
        static_cast<float*>(out)[w * seg + t] = x;
      }
    }
  }
}

template <bool kPacked, int kOut, int kBody>
cudaError_t launch(const uint8_t* codes, const int32_t* tile_idx,
                   const int32_t* lens, const int32_t* lut_idx,
                   const uint32_t* luts, void* out, int bw, int m, int seg,
                   int never, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * (kPacked ? 128 : 256) * 4;
  auto kernel = adc_scan_tiles_kernel<kPacked, kOut, kBody>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<bw, kLanes, smem, stream>>>(codes, tile_idx, lens, lut_idx, luts,
                                       out, m, seg, never);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const uint8_t*, const int32_t*,
                                 const int32_t*, const int32_t*,
                                 const uint32_t*, void*, int, int, int, int,
                                 cudaStream_t);

template <bool kPacked>
LaunchFn pick(int out_mode, int body) {
  const bool bf16 = out_mode == kOutBF16;
  if (body == kBodyCopy) {
    if (bf16) return &launch<kPacked, kOutBF16, kBodyCopy>;
    return &launch<kPacked, kOutF32, kBodyCopy>;
  }
  if (body == kBodyNoGather) {
    if (bf16) return &launch<kPacked, kOutBF16, kBodyNoGather>;
    return &launch<kPacked, kOutF32, kBodyNoGather>;
  }
  if (bf16) return &launch<kPacked, kOutBF16, kBodyAdc>;
  if (out_mode == kOutLaneL1) return &launch<kPacked, kOutLaneL1, kBodyAdc>;
  return &launch<kPacked, kOutF32, kBodyAdc>;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; the launch goes on `stream` and does not synchronise.  `body`
// is 0 (the scan), 1 (copy) or 2 (nogather); the measurement bodies take no
// lane_l1 output.  `never` must be 0.  Returns a cudaError_t (0 = success).
extern "C" int chamjax_adc_scan_tiles(const void* codes_tiled,
                                      const void* tile_idx, const void* lens,
                                      const void* lut_idx, const void* luts,
                                      void* out, int bw, int m, int seg,
                                      int lut_bf16, int out_mode, int body,
                                      int never, void* stream) {
  if (bw <= 0 || m <= 0 || seg <= 0 || seg % kLanes || body < 0 ||
      body > kBodyNoGather || (body != kBodyAdc && out_mode == kOutLaneL1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchFn go = lut_bf16 ? pick<true>(out_mode, body)
                         : pick<false>(out_mode, body);
  return static_cast<int>(go(
      static_cast<const uint8_t*>(codes_tiled),
      static_cast<const int32_t*>(tile_idx), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(lut_idx), static_cast<const uint32_t*>(luts),
      out, bw, m, seg, never, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* chamjax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
