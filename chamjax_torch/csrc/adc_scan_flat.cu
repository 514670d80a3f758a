// Flat-layout ADC scans for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels that compute one function over the
// transposed flat code layout codes_t (m, n_cols) uint8:
//
//   chamjax/ops/scan_seg_multi.py::adc_scan_segments_multi (_adc_multi_kernel)
//   chamjax/ops/scan_seg.py::adc_scan_segments             (_adc_seg_kernel)
//   chamjax/ops/scan_pallas.py::adc_scan_distances         (_adc_kernel)
//
// For every window w (a (query, probe) pair for adc_scan_distances):
//
//   dist[w, r] = sum_j LUT[row(w)][j, codes_t[j, starts[w] + r]]
//
// for r < lens[w], +inf beyond; row(w) is lut_idx[w], or w itself for
// adc_scan_distances.  The window is `width` rows wide: seg (a multiple of
// 128, at most 4096) for the two segment scans, scan_len (a multiple of
// 1024) for adc_scan_distances.  LUT rows are (m, 256) f32, or packed bf16
// pairs (m, 128) int32 (entry 2c in the low half, 2c+1 in the high half).
// Outputs: (bW, width) f32, or (bW, 2, 128) f32 with lane_l1 (per-lane min
// over the window's width/128 row groups, then the winning group index as
// int32 bits; the first group wins ties).  The TPU kernels differ only in
// how their grid steps fetch windows (G windows per step, one, or chunks of
// one probe's list); on the card all three are this one kernel.
//
// Bound on an H100 SXM (3.35 TB/s HBM; the adds are negligible next to the
// bytes): with 4096 windows of seg 512 at m=16 the kernel must read up to
// 4096*16*512 = 33.6 MB of codes, 4096 LUT rows of 16 KB (f32) = 67 MB and
// write 4096*512*4 = 8.4 MB: ~109 MB, ~33 us.  adc_scan_distances at
// bp=4096, scan_len=4096 writes 67 MB of distances, most of them +inf past
// short lists, so its output bytes bound it as much as its reads.  Both are
// bound by bytes.
//
// The design is the simple one of adc_scan_tiles.cu: one CTA of 128 threads
// per window, the window's LUT row staged in shared memory with 16-byte
// loads (above 48 KB, e.g. f32 at m=64, it opts in to more dynamic shared
// memory), thread t owning rows t, t+128, ... and reading code byte
// codes_t[j*n_cols + start + r] for j = 0..m-1, so neighbouring threads read
// neighbouring bytes whatever the alignment of `start` (list starts are
// list_pad multiples, not 128- or 16-byte aligned).  Offsets are 64-bit:
// m*n_cols passes 2^31 at m=16 past ~134M rows.  Sums are fp32 in the order
// j = 0..m-1.  Rows at or past lens[w] (or past the end of codes_t) read
// nothing and write +inf; an empty window reads nothing at all.  LUT reuse
// across a probe's windows, TMA staging and wider code loads are left for
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

// Same decode as adc_scan_tiles.cu (each .cu builds into its own library).
template <bool kPacked>
__device__ __forceinline__ float lut_entry(const uint32_t* __restrict__ lut,
                                           int j, uint32_t c) {
  if (kPacked) {
    const uint32_t v = lut[j * 128 + (c >> 1)];
    return __uint_as_float((c & 1u) ? (v & 0xFFFF0000u) : (v << 16));
  }
  return __uint_as_float(lut[j * 256 + c]);
}

template <bool kPacked, bool kLaneL1>
__global__ void __launch_bounds__(kLanes)
adc_scan_flat_kernel(const uint8_t* __restrict__ codes_t, int64_t n_cols,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ lut_idx,  // null: row w
                     const uint32_t* __restrict__ luts,
                     float* __restrict__ out, int m, int width) {
  extern __shared__ uint4 smem[];
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  const int64_t w = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t start = starts[w];
  // rows this window reads: its length, cut to its width and to codes_t
  int64_t n = lens[w];
  n = n < width ? n : width;
  n = n < n_cols - start ? n : n_cols - start;
  const int len = (start < 0 || n < 0) ? 0 : static_cast<int>(n);
  const float inf = __int_as_float(0x7f800000);

  if (len > 0) {
    constexpr int kWords = kPacked ? 128 : 256;
    const int n16 = m * kWords / 4;   // 16-byte chunks in one LUT row
    const int64_t row = lut_idx ? lut_idx[w] : w;
    const uint4* src = reinterpret_cast<const uint4*>(luts + row * m * kWords);
    for (int i = t; i < n16; i += kLanes) smem[i] = src[i];
    __syncthreads();
  }
  const uint8_t* col = codes_t + start;

  float best = inf;
  int best_g = 0;
  const int groups = width / kLanes;
  for (int g = 0; g < groups; ++g) {
    const int r = g * kLanes + t;
    float acc = inf;
    if (r < len) {
      acc = 0.f;
      const uint8_t* p = col + r;
#pragma unroll 8
      for (int j = 0; j < m; ++j, p += n_cols) {
        acc += lut_entry<kPacked>(lut, j, *p);
      }
    }
    if (kLaneL1) {
      if (acc < best) {   // strict: the first group wins ties
        best = acc;
        best_g = g;
      }
    } else {
      out[w * width + r] = acc;
    }
  }
  if (kLaneL1) {
    float* o = out + w * 2 * kLanes;
    o[t] = best;
    o[kLanes + t] = __int_as_float(best_g);
  }
}

template <bool kPacked, bool kLaneL1>
cudaError_t launch(const uint8_t* codes_t, int64_t n_cols,
                   const int32_t* starts, const int32_t* lens,
                   const int32_t* lut_idx, const uint32_t* luts, float* out,
                   int bw, int m, int width, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * (kPacked ? 128 : 256) * 4;
  auto kernel = adc_scan_flat_kernel<kPacked, kLaneL1>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<bw, kLanes, smem, stream>>>(codes_t, n_cols, starts, lens, lut_idx,
                                       luts, out, m, width);
  return cudaGetLastError();
}

int run(const void* codes_t, long long n_cols, const void* starts,
        const void* lens, const void* lut_idx, const void* luts, void* out,
        int bw, int m, int width, int lut_bf16, int lane_l1, void* stream) {
  if (bw <= 0 || m <= 0 || n_cols <= 0 || width <= 0 || width % kLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const uint8_t*>(codes_t);
  const auto* st = static_cast<const int32_t*>(starts);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* li = static_cast<const int32_t*>(lut_idx);
  const auto* lu = static_cast<const uint32_t*>(luts);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = lut_bf16 ? (lane_l1 ? launch<true, true> : launch<true, false>)
                     : (lane_l1 ? launch<false, true> : launch<false, false>);
  return static_cast<int>(go(c, n_cols, st, ln, li, lu, o, bw, m, width, s));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All pointers are device
// pointers; each launch goes on `stream` and does not synchronise.  Each
// returns a cudaError_t (0 = success).

extern "C" int chamjax_adc_scan_segments_multi(
    const void* codes_t, long long n_cols, const void* starts,
    const void* lens, const void* lut_idx, const void* luts, void* out,
    int bw, int m, int seg, int lut_bf16, int lane_l1, void* stream) {
  if (seg > 4096) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes_t, n_cols, starts, lens, lut_idx, luts, out, bw, m, seg,
             lut_bf16, lane_l1, stream);
}

extern "C" int chamjax_adc_scan_segments(
    const void* codes_t, long long n_cols, const void* starts,
    const void* lens, const void* lut_idx, const void* luts, void* out,
    int bw, int m, int seg, int lut_bf16, void* stream) {
  if (seg > 4096) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes_t, n_cols, starts, lens, lut_idx, luts, out, bw, m, seg,
             lut_bf16, 0, stream);
}

extern "C" int chamjax_adc_scan_distances(
    const void* codes_t, long long n_cols, const void* starts,
    const void* lens, const void* luts, void* out, int bp, int m,
    int scan_len, void* stream) {
  if (scan_len % 1024) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes_t, n_cols, starts, lens, nullptr, luts, out, bp, m,
             scan_len, 0, 0, stream);
}

extern "C" const char* chamjax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
