// Measurement variants of the ADC scan body for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of benchmarks/kernel_variants.py:
//
//   run_variant        (body _kernel)       -> chamjax_run_variant
//   run_block_variant  (body _kernel_block) -> chamjax_run_block_variant
//
// Each variant changes one part of the production scan body of
// adc_scan_flat.cu / adc_scan_tiles.cu, so that "production minus variant"
// prices that part on the card.  Every variant stages the window's LUT row
// in shared memory (the production prologue), even where it never gathers;
// none reads `lens` (the TPU kernel never does).  For window w (one CTA of
// 128 threads), L = LUT row lut_idx[w], c[j, r] = code at column
// starts[w] + r of code row j:
//
//   f32            sum_j L[j, c[j,r]], f32 LUT (m, 256)          baseline body
//   i32codes       as f32, codes stored int32                    u8 loads/unpack
//   bf16           packed LUT, 4-op decode                       production decode
//   bf16_trim      packed LUT, 3-op decode (bit-equal to bf16)   decode op count
//   bf16_nodecode  sum_j f32 bits of the packed word c>>1        decode cost
//   bf16_trim_w4   bf16_trim, four row groups per thread at once rows per thread
//   bf16_trim_nodma  bf16_trim of code 0 on every row; no code load  code traffic
//   bf16_min       per-lane min over row groups, (bW, 128) out   output writes
//   bf16_mxu       decode into a shared (m, seg) f32 buffer, then
//                  a second pass sums over m                     decode vs reduce
//   nosum          L[0, c[0,r] & 127], the other m-1 gathers sunk  the sum
//   nogather       sum_j c[j,r] as f32 (integer adds)            the LUT gather
//   dma_only       out[w, g*128 + l] = c[0, l]; every code byte of
//                  the window is read and sunk                   code bandwidth
//   bytes_f32/_bf16     one 32-bit load = 4 codes; output permuted,
//                  out[w, b*(seg/4) + f] = dist(row 4f + b)      32-bit code loads
//   i32view_f32/_bf16   the same, codes given as an (m, n/4) int32 view
//   contig_bf16t   bf16_trim over the seg-tiled (n/seg, m, seg) layout,
//                  tile starts[w]/seg staged in shared memory by cp.async
//   block_bf16t    the same function, codes read straight from global memory
//                  as adc_scan_tiles.cu reads them           staged vs direct
//
// "Sunk" values feed an XOR that is stored only when the runtime argument
// `never` is non-zero (the wrapper passes 0), so the compiler cannot drop
// those loads.  Checked in the SASS (chamjax_torch/benchmarks/
// sass_report.py, nvcc 12.8, sm_90a): every variant that reads codes byte
// by byte keeps the production loop's 15 LDG.E.U8 (28 in w4's four-group
// loop), i32codes has 32-bit loads in their place, the word variants 32-bit
// loads, contig cp.async (LDGSTS.128) and byte LDS; nosum keeps its LDS
// gathers; bf16_trim_nodma has no code load.
//
// Bound on an H100 SXM (3.35 TB/s): the variants read m*seg code bytes per
// window (4x that for i32codes) and write 4*seg bytes; at the harness's
// default shape (bW=4096, seg=2048, m=16, random windows over a 256 MB slab)
// that is 134 MB of codes, 34 MB of output and up to 67 MB of LUT rows:
// 0.05-0.07 ms by bytes.  The adds (134M) take 2 us at 67 TFLOP/s.  Bound by
// bytes.  The design is that of the production kernels: one CTA of 128
// threads per window, thread t owning rows t, t+128, ..., the LUT row in
// shared memory; this file adds nothing to make the variants fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

enum Variant : int {
  kF32 = 0,
  kI32Codes = 1,
  kBf16 = 2,
  kBf16Trim = 3,
  kBf16NoDecode = 4,
  kBf16TrimW4 = 5,
  kBf16TrimNoDma = 6,
  kBf16Min = 7,
  kBf16Mxu = 8,
  kNoSum = 9,
  kNoGather = 10,
  kDmaOnly = 11,
  kBytesF32 = 12,
  kBytesBf16 = 13,
  kI32ViewF32 = 14,
  kI32ViewBf16 = 15,
  kContigBf16t = 16,
  kBlockBf16t = 17,
};

__host__ __device__ constexpr bool packed_lut(int v) {
  return v == kBf16 || v == kBf16Trim || v == kBf16NoDecode ||
         v == kBf16TrimW4 || v == kBf16TrimNoDma || v == kBf16Min ||
         v == kBf16Mxu || v == kBytesBf16 || v == kI32ViewBf16 ||
         v == kContigBf16t || v == kBlockBf16t;
}

__host__ __device__ constexpr bool word_loads(int v) {
  return v == kBytesF32 || v == kBytesBf16 || v == kI32ViewF32 ||
         v == kI32ViewBf16;
}

__device__ __forceinline__ float f32_entry(const uint32_t* lut, int j,
                                           uint32_t c) {
  return __uint_as_float(lut[j * 256 + c]);
}

// 3-op decode: an odd code keeps the high half in place, an even code moves
// the low half up (bf16 -> f32 bits)
__device__ __forceinline__ float trim_entry(const uint32_t* lut, int j,
                                            uint32_t c) {
  const uint32_t v = lut[j * 128 + (c >> 1)];
  return __uint_as_float((c & 1u) ? (v & 0xFFFF0000u) : (v << 16));
}

// 4-op decode of the TPU's production body: select the half, mask, shift
__device__ __forceinline__ float decode4_entry(const uint32_t* lut, int j,
                                               uint32_t c) {
  const uint32_t v = lut[j * 128 + (c >> 1)];
  return __uint_as_float((((c & 1u) ? (v >> 16) : v) & 0xFFFFu) << 16);
}

template <int V>
__device__ __forceinline__ float entry(const uint32_t* lut, int j,
                                       uint32_t c) {
  if constexpr (V == kBf16) {
    return decode4_entry(lut, j, c);
  } else if constexpr (V == kBf16NoDecode) {
    return __uint_as_float(lut[j * 128 + (c >> 1)]);
  } else if constexpr (packed_lut(V)) {
    return trim_entry(lut, j, c);
  } else {
    return f32_entry(lut, j, c);
  }
}

// The LUT row of window w into shared memory with 16-byte loads.
__device__ __forceinline__ void stage_lut(uint4* smem, const uint32_t* luts,
                                          int64_t row, int words) {
  const uint4* src = reinterpret_cast<const uint4*>(luts + row * words);
  for (int i = threadIdx.x; i < words / 4; i += kLanes) smem[i] = src[i];
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

// One row per thread per row group: every variant but the word-load and
// two-pass ones.  `stride` is the code row stride in elements (uint8, or
// int32 for i32codes); the tiled variants ignore it.
template <int V>
__global__ void __launch_bounds__(kLanes)
variant_rows_kernel(const void* __restrict__ codes, int64_t stride,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ lut_idx,
                    const uint32_t* __restrict__ luts,
                    float* __restrict__ out, int m, int seg, int never) {
  extern __shared__ uint4 smem[];
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  constexpr int kWords = packed_lut(V) ? 128 : 256;
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t start = starts[w];
  stage_lut(smem, luts, lut_idx[w], m * kWords);

  const uint8_t* c8 = static_cast<const uint8_t*>(codes) + start;
  const int32_t* c32 = static_cast<const int32_t*>(codes) + start;
  const uint8_t* tile = static_cast<const uint8_t*>(codes) +
                        (start / seg) * static_cast<int64_t>(m) * seg;
  if constexpr (V == kContigBf16t) {
    // the whole (m, seg) tile, one contiguous slab, into shared memory
    uint8_t* dst = reinterpret_cast<uint8_t*>(smem) + m * kWords * 4;
    for (int i = t; i < m * seg / 16; i += kLanes) {
      cp_async16(dst + 16 * i, tile + 16 * i);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    tile = dst;
  }
  __syncthreads();

  auto code = [&](int j, int r) -> uint32_t {
    if constexpr (V == kI32Codes) {
      return static_cast<uint32_t>(c32[j * stride + r]);
    } else if constexpr (V == kContigBf16t || V == kBlockBf16t) {
      return tile[j * seg + r];
    } else if constexpr (V == kBf16TrimNoDma) {
      // no load: code 0 on every row, from a value the compiler cannot fold
      return static_cast<uint32_t>(r * never) & 0xFFu;
    } else {
      return c8[j * stride + r];
    }
  };

  const int groups = seg / kLanes;
  float* o = out + w * seg;
  uint32_t sink = 0;
  if constexpr (V == kBf16TrimW4) {
    // four row groups per thread, four independent sums
    for (int g = 0; g < groups; g += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] += entry<V>(lut, j, code(j, (g + k) * kLanes + t));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) o[(g + k) * kLanes + t] = acc[k];
    }
    return;
  }
  float best = __int_as_float(0x7f800000);
  uint32_t c0 = 0;
  for (int g = 0; g < groups; ++g) {
    const int r = g * kLanes + t;
    float acc = 0.f;
    // the sinks keep the production loop's shape over j = 0..m-1 (see
    // adc_scan_tiles.cu's copy body)
    if constexpr (V == kNoSum) {
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        const float e = f32_entry(lut, j, code(j, r) & 127u);
        if (j == 0) {
          acc = e;
        } else {
          sink ^= __float_as_uint(e);
        }
      }
    } else if constexpr (V == kNoGather) {
      uint32_t s = 0;
#pragma unroll 8
      for (int j = 0; j < m; ++j) s += code(j, r);
      acc = static_cast<float>(s);
    } else if constexpr (V == kDmaOnly) {
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        const uint32_t v = code(j, r);
        if (j == 0 && g == 0) {
          c0 = v;
        } else {
          sink ^= v;
        }
      }
      acc = static_cast<float>(c0);
    } else {
#pragma unroll 8
      for (int j = 0; j < m; ++j) acc += entry<V>(lut, j, code(j, r));
    }
    if constexpr (V == kBf16Min) {
      best = fminf(best, acc);
    } else {
      o[r] = acc;
    }
  }
  if constexpr (V == kBf16Min) {
    out[w * kLanes + t] = best;
  }
  if constexpr (V == kNoSum || V == kDmaOnly) {
    if (never) o[t] = __uint_as_float(sink);
  }
}

// bytes_* and i32view_*: thread t loads 32-bit words f = t, t+128, ... of
// each code row (four codes a load) and keeps four sums, one per byte.
// `stride` is the code row stride in words.
template <int V>
__global__ void __launch_bounds__(kLanes)
variant_words_kernel(const void* __restrict__ codes, int64_t stride,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lut_idx,
                     const uint32_t* __restrict__ luts,
                     float* __restrict__ out, int m, int seg, int never) {
  extern __shared__ uint4 smem[];
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  constexpr int kWords = packed_lut(V) ? 128 : 256;
  const int64_t w = blockIdx.x;
  stage_lut(smem, luts, lut_idx[w], m * kWords);
  __syncthreads();
  const uint32_t* words =
      static_cast<const uint32_t*>(codes) + starts[w] / 4;
  const int q = seg / 4;
  float* o = out + w * seg;
  for (int f = threadIdx.x; f < q; f += kLanes) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const uint32_t v = words[j * stride + f];
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[b] += entry<V>(lut, j, (v >> (8 * b)) & 0xFFu);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b * q + f] = acc[b];
  }
}

// bf16_mxu: pass 1 decodes every (j, r) into a shared (m, seg) f32 buffer,
// pass 2 sums it over m.
__global__ void __launch_bounds__(kLanes)
variant_mxu_kernel(const void* __restrict__ codes, int64_t stride,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ lut_idx,
                   const uint32_t* __restrict__ luts,
                   float* __restrict__ out, int m, int seg, int never) {
  extern __shared__ uint4 smem[];
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  float* gbuf = reinterpret_cast<float*>(smem) + m * 128;
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  stage_lut(smem, luts, lut_idx[w], m * 128);
  __syncthreads();
  const uint8_t* c8 = static_cast<const uint8_t*>(codes) + starts[w];
  for (int r = t; r < seg; r += kLanes) {
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      gbuf[j * seg + r] = trim_entry(lut, j, c8[j * stride + r]);
    }
  }
  __syncthreads();
  float* o = out + w * seg;
  for (int r = t; r < seg; r += kLanes) {
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < m; ++j) acc += gbuf[j * seg + r];
    o[r] = acc;
  }
}

size_t smem_bytes(int v, int m, int seg) {
  size_t b = static_cast<size_t>(m) * (packed_lut(v) ? 128 : 256) * 4;
  if (v == kContigBf16t) b += static_cast<size_t>(m) * seg;
  if (v == kBf16Mxu) b += static_cast<size_t>(m) * seg * 4;
  return b;
}

using KernelFn = void (*)(const void*, int64_t, const int32_t*,
                          const int32_t*, const uint32_t*, float*, int, int,
                          int);

template <int V>
cudaError_t launch(const void* codes, int64_t stride, const int32_t* starts,
                   const int32_t* lut_idx, const uint32_t* luts, float* out,
                   int bw, int m, int seg, int never, cudaStream_t stream) {
  KernelFn kernel;
  if constexpr (V == kBf16Mxu) {
    kernel = variant_mxu_kernel;
  } else if constexpr (word_loads(V)) {
    kernel = variant_words_kernel<V>;
  } else {
    kernel = variant_rows_kernel<V>;
  }
  const size_t smem = smem_bytes(V, m, seg);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<bw, kLanes, smem, stream>>>(codes, stride, starts, lut_idx, luts,
                                       out, m, seg, never);
  return cudaGetLastError();
}

int run(const void* codes, long long stride, const void* starts,
        const void* lut_idx, const void* luts, void* out, int bw, int m,
        int seg, int variant, int never, void* stream) {
  if (bw <= 0 || m <= 0 || seg <= 0 || seg % kLanes ||
      ((variant == kBf16TrimW4 || word_loads(variant)) && seg % 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* li = static_cast<const int32_t*>(lut_idx);
  const auto* lu = static_cast<const uint32_t*>(luts);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (variant) {
#define CHAMJAX_VARIANT(V)                                              \
  case V:                                                               \
    e = launch<V>(codes, stride, st, li, lu, o, bw, m, seg, never, s);  \
    break;
    CHAMJAX_VARIANT(kF32)
    CHAMJAX_VARIANT(kI32Codes)
    CHAMJAX_VARIANT(kBf16)
    CHAMJAX_VARIANT(kBf16Trim)
    CHAMJAX_VARIANT(kBf16NoDecode)
    CHAMJAX_VARIANT(kBf16TrimW4)
    CHAMJAX_VARIANT(kBf16TrimNoDma)
    CHAMJAX_VARIANT(kBf16Min)
    CHAMJAX_VARIANT(kBf16Mxu)
    CHAMJAX_VARIANT(kNoSum)
    CHAMJAX_VARIANT(kNoGather)
    CHAMJAX_VARIANT(kDmaOnly)
    CHAMJAX_VARIANT(kBytesF32)
    CHAMJAX_VARIANT(kBytesBf16)
    CHAMJAX_VARIANT(kI32ViewF32)
    CHAMJAX_VARIANT(kI32ViewBf16)
    CHAMJAX_VARIANT(kContigBf16t)
    CHAMJAX_VARIANT(kBlockBf16t)
#undef CHAMJAX_VARIANT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All pointers are device
// pointers; each launch goes on `stream` and does not synchronise.  Each
// returns a cudaError_t (0 = success).  `never` must be 0.

// codes: (m, n) uint8, (m, n) int32 for i32codes, (m, n/4) int32 for
// i32view_*, (n/seg, m, seg) uint8 for contig_bf16t.  `stride` is the row
// stride of the flat layouts in elements: n, or n/4 for bytes_* and
// i32view_*, whose rows are read as 32-bit words.
extern "C" int chamjax_run_variant(const void* codes, long long stride,
                                   const void* starts, const void* lut_idx,
                                   const void* luts, void* out, int bw, int m,
                                   int seg, int variant, int never,
                                   void* stream) {
  if (variant == kBlockBf16t) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes, stride, starts, lut_idx, luts, out, bw, m, seg, variant,
             never, stream);
}

// codes_tiled: (n/seg, m, seg) uint8; starts are row starts (multiples of
// seg), tile = starts[w] / seg.
extern "C" int chamjax_run_block_variant(const void* codes_tiled,
                                         const void* starts,
                                         const void* lut_idx,
                                         const void* luts, void* out, int bw,
                                         int m, int seg, int never,
                                         void* stream) {
  return run(codes_tiled, 0, starts, lut_idx, luts, out, bw, m, seg,
             kBlockBf16t, never, stream);
}

extern "C" const char* chamjax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
