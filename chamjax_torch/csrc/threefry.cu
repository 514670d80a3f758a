// threefry2x32 draws for Hopper (sm_90a): the JAX PRNG on the card.
//
// There is no Pallas kernel to replace: on the TPU, XLA generates the
// threefry2x32 hash of jax.random (jax/_src/prng.py, the partitionable
// counters of _threefry_random_bits_partitionable) and the samplers around
// it (jax/_src/random.py: _uniform, _normal_real, _gumbel).  These kernels
// are their counterpart, so chamjax_torch draws the numbers chamjax draws
// from the same key.  Two entry points:
//
// chamjax_threefry (chamjax_torch/random.py::threefry_draw; plain version
// threefry_draw_reference): n outputs of one draw.  Output i hashes the
// 64-bit counter start + i, split into its hi and lo words, under the key
// (k0, k1): 20 rounds of threefry2x32 in registers, then bits1 ^ bits2,
// written in one of these forms:
//
//   kBits32 / kBits16 / kBits8   the low 32 / 16 / 8 bits
//   kUniformF32     max(lo, fma(f, span, lo)), f in [0, 1) from the top 23
//                   bits (XLA fuses the multiply-add on the CPU)
//   kUniformBF16    f from 8 bits (bfloat16's 7-bit mantissa is shorter),
//                   every step rounded to bfloat16, no fusion
//   kNormalF32      sqrt(2) * erf_inv(u) * scale, u the float32 uniform on
//                   [nextafter(-1, 0), 1) (lo and span from the wrapper)
//   kNormalBF16     the same from the bfloat16 uniform: erf_inv in float32,
//                   rounded to bfloat16, then each multiply in bfloat16
//   kGumbelF32      -log(-log(u)), u the float32 uniform on [tiny, 1)
//
// chamjax_threefry_gumbel_argmax (random.py::gumbel_argmax; plain version
// gumbel_argmax_reference): one step of k-means++'s D^2 sampling by the
// Gumbel-max trick, argmax_j log(max(d_j, 1e-30)) + gumbel(fold_in(key,
// step), (n,))_j, the lowest j on ties, as an int64 on the card.
//
// erf_inv, log and log1p are XLA's own float32 CPU code (Giles' polynomial;
// Cephes' logf polynomial and log1p rational form), evaluated with the same
// fused multiply-adds (fmaf) and otherwise with _rn intrinsics, which nvcc
// never contracts, so a draw equals jax.random's on the CPU bit for bit.
// sqrtf and __fdiv_rn round correctly (no fast-math flags).  The argmax's
// logit is CUDA's logf, the function torch.log runs on the card.
//
// Bound on an H100 SXM: instructions, not bytes.  The hash is 41 operations
// an output that only the integer pipe runs (20 funnel shifts, 20 xors,
// bits1 ^ bits2) and 32 adds; the integer pipe has 64 lanes an SM a clock,
// so the card hashes at most ~4.1e11 outputs a second, while 3.35 TB/s
// writes ~8.4e11 floats.  A float form adds its float work, and every
// instruction takes an issue slot (4 warp-instructions an SM a clock): a
// normal or a gumbel is bound by issue, not by a pipe
// (benchmarks/bounds.py::threefry_bound; the smoke prints the kernels'
// SASS by pipe beside it, benchmarks/sass_report.py::library_pipe_counts).
//
// Design against that bound:
// - Each thread hashes a run of consecutive counters (16 raw outputs, or
//   16 bytes of a float form: 4 floats or 8 bfloat16s) and stores them 16
//   bytes at a time; the grid is sized to the card and strides over the
//   runs.
// - The 64-bit counter is split once a run: the loop adds to the low word
//   only, and a run that crosses 2^32 takes a second, carrying loop.
// - The key schedule (k2 and the words injected after each group of four
//   rounds) is computed on the host, and kernel parameters carry it.
// - Every add is written a * one + b, one = 1 from the host: ptxas cannot
//   know one, so the adds are IMADs on the FMA pipe, and the integer pipe
//   runs only the 41 operations it alone can.
// - The normal's rare tail (w >= 5, 0.34% of outputs) stays a branch.
// - The Gumbel-max step keeps the gumbels in registers: each thread reads
//   4 distances (one 16-byte load), folds the key itself, and keeps one
//   (value, index) pair as an order-preserving 64-bit word (the float's
//   bits mapped to unsigned order above, the index's complement below, so
//   the lowest index wins ties); warps reduce by shuffles, blocks through
//   shared memory, and the grid by one 64-bit atomicMax into a scratch
//   word.  The last block to finish (a ticket in the scratch's second
//   word) writes the index and sets both words back to 0, so the step's
//   own launch leaves the scratch ready for the next one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

enum Form : int {
  kBits32 = 0,
  kBits16 = 1,
  kBits8 = 2,
  kUniformF32 = 3,
  kUniformBF16 = 4,
  kNormalF32 = 5,
  kNormalBF16 = 6,
  kGumbelF32 = 7,
};

constexpr int kThreads = 256;
constexpr int kArgmaxRows = 4;        // rows a thread of the argmax step

// The key schedule of threefry2x32 under (k0, k1): the words added to x0
// and x1 after each of the five groups of four rounds.
struct Schedule {
  uint32_t k0, k1;
  uint32_t inj0[5], inj1[5];
};

__host__ __device__ inline Schedule make_schedule(uint32_t k0, uint32_t k1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  Schedule s;
  s.k0 = k0;
  s.k1 = k1;
  for (int g = 0; g < 5; ++g) {
    s.inj0[g] = ks[(g + 1) % 3];
    s.inj1[g] = ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return s;
}

// a + b as an IMAD (one is 1; see the note above)
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b,
                                        uint32_t one) {
  return a * one + b;
}

template <int kR>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1,
                                    uint32_t one) {
  x0 = add(x0, x1, one);
  x1 = __funnelshift_l(x1, x1, kR) ^ x0;
}

// The 20 rounds and 5 injections from the keyed words x0 = hi + k0,
// x1 = lo + k1; leaves threefry2x32's output pair in (x0, x1).
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1,
                                       const Schedule& s, uint32_t one) {
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    if (g % 2 == 0) {
      mix<13>(x0, x1, one); mix<15>(x0, x1, one);
      mix<26>(x0, x1, one); mix<6>(x0, x1, one);
    } else {
      mix<17>(x0, x1, one); mix<29>(x0, x1, one);
      mix<16>(x0, x1, one); mix<24>(x0, x1, one);
    }
    x0 = add(x0, s.inj0[g], one);
    x1 = add(x1, s.inj1[g], one);
  }
}

// bits1 ^ bits2 of counter (hi, lo)
__device__ __forceinline__ uint32_t hash_xor(const Schedule& s, uint32_t hi,
                                             uint32_t lo, uint32_t one) {
  uint32_t x0 = add(hi, s.k0, one);
  uint32_t x1 = add(lo, s.k1, one);
  rounds(x0, x1, s, one);
  return x0 ^ x1;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// XLA's float32 log on the CPU (Cephes' logf)
__device__ __forceinline__ float xla_log(float x) {
  float t = fmaxf(x, 1.17549435e-38f);        // the least normal float
  const int bits = __float_as_int(t);
  // the exponent as a float without a conversion: 2^23 + e'' is exact
  float e = __fsub_rn(__uint_as_float(0x4B000000u | (bits >> 23)),
                      8388608.0f + 0x7f);
  e = __fadd_rn(e, 1.0f);
  t = __int_as_float((bits & ~0x7f800000) | 0x3f000000);   // [0.5, 1)
  const bool small = t < 0.707106781186547524f;
  const float t1 = small ? t : 0.0f;
  t = __fsub_rn(t, 1.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  t = __fadd_rn(t, t1);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  float y = fmaf(fmaf(t, 7.0376836292e-2f, -1.1514610310e-1f), t,
                 1.1676998740e-1f);
  const float y1 = fmaf(fmaf(t, -1.2420140846e-1f, 1.4249322787e-1f), t,
                        -1.6668057665e-1f);
  const float y2 = fmaf(fmaf(t, 2.0000714765e-1f, -2.4999993993e-1f), t,
                        3.3333331174e-1f);
  y = fmaf(fmaf(y, x3, y1), x3, y2);
  y = fmaf(y, x3, __fmul_rn(e, -2.12194440e-4f));
  t = fmaf(x2, -0.5f, t);
  float r = fmaf(e, 0.693359375f, __fadd_rn(t, y));
  if (x == 0.0f) r = -INFINITY;
  if (x == INFINITY) r = INFINITY;
  if (!(x >= 0.0f)) r = NAN;                  // negative or NaN
  return r;
}

// XLA's float32 log1p on the CPU: Cephes' rational form below sqrt(2) - 1
__device__ __forceinline__ float xla_log1p(float x) {
  if (!(fabsf(x) < 0.41421356237309504880f)) {
    return xla_log(__fadd_rn(x, 1.0f));
  }
  const float num[7] = {4.5270000862445199635215e-5f,
                        4.9854102823193375972212e-1f,
                        6.5787325942061044846969e0f,
                        2.9911919328553073277375e1f,
                        6.0949667980987787057556e1f,
                        5.7112963590585538103336e1f,
                        2.0039553499201281259648e1f};
  const float den[7] = {1.0f,
                        1.5062909083469192043167e1f,
                        8.3047565967967209469434e1f,
                        2.2176239823732856465394e2f,
                        3.0909872225312059774938e2f,
                        2.1642788614495947685003e2f,
                        6.0118660497603843919306e1f};
  float p = num[0];
  float q = den[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    p = fmaf(p, x, num[i]);
    q = fmaf(q, x, den[i]);
  }
  const float x2 = __fmul_rn(x, x);
  const float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  return __fadd_rn(x, fmaf(x2, -0.5f, r));
}

// XLA's float32 erf_inv (Giles)
__device__ __forceinline__ float xla_erf_inv(float x) {
  float w = -xla_log1p(__fmul_rn(x, -x));
  float p;
  if (w < 5.0f) {
    const float c[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                        -0.00417768164f, 0.246640727f, 1.50140941f};
    w = __fsub_rn(w, 2.5f);
    p = c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fmaf(p, w, c[i]);
  } else {
    const float c[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f, 0.00573950773f, -0.0076224613f,
                        0.00943887047f, 1.00167406f, 2.83297682f};
    w = __fsub_rn(sqrtf(w), 3.0f);
    p = c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fmaf(p, w, c[i]);
  }
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

__device__ __forceinline__ float uniform_f32(uint32_t bits, float lo,
                                             float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                            1.0f);
  return fmaxf(lo, fmaf(f, span, lo));
}

__device__ __forceinline__ float uniform_bf16(uint32_t bits, float lo,
                                              float span) {
  const uint32_t m7 = (bits & 0xFFu) >> 1;
  const float f = __fsub_rn(__uint_as_float((m7 | 0x3F80u) << 16), 1.0f);
  const float u = bf16_round(__fadd_rn(bf16_round(__fmul_rn(f, span)), lo));
  return fmaxf(lo, u);
}

__device__ __forceinline__ float gumbel_f32(uint32_t bits, float lo,
                                            float span) {
  return -xla_log(-xla_log(uniform_f32(bits, lo, span)));
}

// A float form's value (float32; bfloat16 forms hold bfloat16 values)
template <int kForm>
__device__ __forceinline__ float float_form(uint32_t bits, float lo,
                                            float span, float scale) {
  if (kForm == kUniformF32) return uniform_f32(bits, lo, span);
  if (kForm == kUniformBF16) return uniform_bf16(bits, lo, span);
  if (kForm == kNormalF32) {
    const float r = __fmul_rn(1.41421356237309504880f,
                              xla_erf_inv(uniform_f32(bits, lo, span)));
    return __fmul_rn(r, scale);
  }
  if (kForm == kNormalBF16) {
    const float e = bf16_round(xla_erf_inv(uniform_bf16(bits, lo, span)));
    const float r = bf16_round(__fmul_rn(e, 1.4140625f));   // bf16 sqrt(2)
    return __fmul_rn(r, scale);
  }
  return gumbel_f32(bits, lo, span);
}

// Output bytes of a form, and the outputs a thread hashes in a run: 16
// for the raw bits (a run's bookkeeping, ~10 integer-pipe instructions,
// spread over 16 hashes), 16 bytes' worth for a float form (whose float
// work dwarfs the bookkeeping, and whose code at 16 a run would crowd the
// instruction cache)
template <int kForm>
struct Width {
  static constexpr int kBytes =
      (kForm == kBits16 || kForm == kUniformBF16 || kForm == kNormalBF16)
          ? 2 : (kForm == kBits8 ? 1 : 4);
  static constexpr bool kRaw =
      kForm == kBits32 || kForm == kBits16 || kForm == kBits8;
  static constexpr int kRun = kRaw ? 16 : 16 / kBytes;
  static constexpr int kVecs = kRun * kBytes / 16;     // 16-byte stores
};

// The stored bits of one output, in the low kBytes bytes of a word
template <int kForm>
__device__ __forceinline__ uint32_t stored(uint32_t bits, float lo,
                                           float span, float scale) {
  if (kForm == kBits32 || kForm == kBits16 || kForm == kBits8) return bits;
  const float v = float_form<kForm>(bits, lo, span, scale);
  if (Width<kForm>::kBytes == 2) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  return __float_as_uint(v);
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(void* __restrict__ out, long long n,
                    unsigned long long start, Schedule s, uint32_t one,
                    float lo, float span, float scale) {
  constexpr int kB = Width<kForm>::kBytes;
  constexpr int kRun = Width<kForm>::kRun;
  const long long runs = (n + kRun - 1) / kRun;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       r < runs; r += stride) {
    const long long first = r * kRun;
    const unsigned long long c =
        start + static_cast<unsigned long long>(first);
    const uint32_t hi = static_cast<uint32_t>(c >> 32);
    const uint32_t lo0 = static_cast<uint32_t>(c);
    uint32_t w[kRun];
    if (lo0 <= 0xFFFFFFFFu - (kRun - 1)) {
      // no carry in the run: x0 is the same for every counter
      const uint32_t x0k = add(hi, s.k0, one);
      const uint32_t x1k = add(lo0, s.k1, one);
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        uint32_t x0 = x0k;
        uint32_t x1 = add(x1k, static_cast<uint32_t>(u), one);
        rounds(x0, x1, s, one);
        w[u] = stored<kForm>(x0 ^ x1, lo, span, scale);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        const unsigned long long cu = c + static_cast<unsigned long long>(u);
        w[u] = stored<kForm>(
            hash_xor(s, static_cast<uint32_t>(cu >> 32),
                     static_cast<uint32_t>(cu), one),
            lo, span, scale);
      }
    }
    if (first + kRun <= n) {
      constexpr int kVecs = Width<kForm>::kVecs;
      uint4 v[kVecs];
      uint32_t* p = reinterpret_cast<uint32_t*>(v);
      if (kB == 4) {
#pragma unroll
        for (int i = 0; i < 4 * kVecs; ++i) p[i] = w[i];
      } else if (kB == 2) {
#pragma unroll
        for (int i = 0; i < 4 * kVecs; ++i) {
          p[i] = __byte_perm(w[2 * i], w[2 * i + 1], 0x5410);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4 * kVecs; ++i) {
          p[i] = __byte_perm(__byte_perm(w[4 * i], w[4 * i + 1], 0x0040),
                             __byte_perm(w[4 * i + 2], w[4 * i + 3], 0x0040),
                             0x5410);
        }
      }
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        reinterpret_cast<uint4*>(out)[r * kVecs + q] = v[q];
      }
    } else {
      // the ragged end: one output at a time
      for (int u = 0; u < kRun && first + u < n; ++u) {
        if (kB == 4) {
          static_cast<uint32_t*>(out)[first + u] = w[u];
        } else if (kB == 2) {
          static_cast<uint16_t*>(out)[first + u] = static_cast<uint16_t>(w[u]);
        } else {
          static_cast<uint8_t*>(out)[first + u] = static_cast<uint8_t>(w[u]);
        }
      }
    }
  }
}

// The 64-bit word whose unsigned order is (v, -j)'s: the float's bits in
// unsigned order above (NaN above +inf, as argmax takes the first NaN;
// -0 as +0), the index's complement below.
__device__ __forceinline__ unsigned long long order_word(float v,
                                                         uint32_t j) {
  uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (v != v) b = 0xFFFFFFFFu;
  return (static_cast<unsigned long long>(b) << 32) | (~j);
}

__device__ __forceinline__ unsigned long long max64(unsigned long long a,
                                                    unsigned long long b) {
  return a > b ? a : b;
}

// log(max(d, 1e-30)), nan kept, as torch.log(torch.clamp(d, 1e-30)) on
// the card: CUDA's logf
__device__ __forceinline__ float logit(float d) {
  return logf(d != d ? d : fmaxf(d, 1e-30f));
}

__global__ void __launch_bounds__(kThreads)
    gumbel_argmax_kernel(const float* __restrict__ d, long long n,
                         uint32_t k0, uint32_t k1, uint32_t step,
                         uint32_t one, float lo, float span,
                         unsigned long long* __restrict__ scratch,
                         long long* __restrict__ idx) {
  __shared__ unsigned long long warp_best[kThreads / 32];
  __shared__ bool last;
  // fold_in(key, step): the output pair of counter (0, step)
  const Schedule ks = make_schedule(k0, k1);
  uint32_t f0 = add(0u, k0, one);
  uint32_t f1 = add(step, k1, one);
  rounds(f0, f1, ks, one);
  const Schedule s = make_schedule(f0, f1);
  const uint32_t x0k = add(0u, s.k0, one);     // counters j < 2^32: hi 0

  unsigned long long best = 0;                 // below every real word
  const bool aligned = (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  const long long groups = (n + kArgmaxRows - 1) / kArgmaxRows;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    const long long j0 = g * kArgmaxRows;
    float dv[kArgmaxRows];
    if (aligned && j0 + kArgmaxRows <= n) {
      const float4 v = reinterpret_cast<const float4*>(d)[g];
      dv[0] = v.x; dv[1] = v.y; dv[2] = v.z; dv[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < kArgmaxRows; ++u) {
        dv[u] = j0 + u < n ? d[j0 + u] : 0.0f;
      }
    }
    const uint32_t x1k = add(static_cast<uint32_t>(j0), s.k1, one);
#pragma unroll
    for (int u = 0; u < kArgmaxRows; ++u) {
      if (j0 + u < n) {
        uint32_t x0 = x0k;
        uint32_t x1 = add(x1k, static_cast<uint32_t>(u), one);
        rounds(x0, x1, s, one);
        const float v =
            __fadd_rn(logit(dv[u]), gumbel_f32(x0 ^ x1, lo, span));
        best = max64(best, order_word(v, static_cast<uint32_t>(j0 + u)));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    best = max64(best, __shfl_down_sync(0xFFFFFFFFu, best, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? warp_best[lane] : 0;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      best = max64(best, __shfl_down_sync(0xFFFFFFFFu, best, off));
    }
    if (lane == 0) {
      atomicMax(&scratch[0], best);
      __threadfence();
      const unsigned long long ticket = atomicAdd(&scratch[1], 1ull);
      last = ticket == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned long long word = atomicExch(&scratch[0], 0ull);
    atomicExch(&scratch[1], 0ull);
    idx[0] = static_cast<long long>(~static_cast<uint32_t>(word));
  }
}

// Blocks of kThreads for a launch over `items` thread-items: enough to
// fill the card, no more than the work needs.  kSite names the kernel, so
// each has its own cache of the device's SMs and its occupancy.
template <int kSite, typename Kernel>
cudaError_t grid_for(Kernel kernel, long long items, unsigned* blocks) {
  static int sms[64] = {0};
  static int per_sm[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(sms[dev]) * per_sm[dev];
  *blocks = static_cast<unsigned>(need < full ? need : full);
  return cudaSuccess;
}

constexpr int kArgmaxSite = 100;

template <int kForm>
cudaError_t launch(void* out, long long n, unsigned long long start,
                   const Schedule& s, float lo, float span, float scale,
                   cudaStream_t stream) {
  constexpr int kRun = Width<kForm>::kRun;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return cudaErrorMisalignedAddress;
  }
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for<kForm>(threefry_kernel<kForm>, (n + kRun - 1) / kRun, &blocks);
  if (err != cudaSuccess) return err;
  threefry_kernel<kForm><<<blocks, kThreads, 0, stream>>>(
      out, n, start, s, 1u, lo, span, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int chamjax_threefry(void* out, long long n,
                                unsigned long long start, unsigned k0,
                                unsigned k1, int form, float lo, float span,
                                float scale, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Schedule s = make_schedule(k0, k1);
  switch (form) {
    case kBits32: return launch<kBits32>(out, n, start, s, lo, span, scale, st);
    case kBits16: return launch<kBits16>(out, n, start, s, lo, span, scale, st);
    case kBits8: return launch<kBits8>(out, n, start, s, lo, span, scale, st);
    case kUniformF32: return launch<kUniformF32>(out, n, start, s, lo, span, scale, st);
    case kUniformBF16: return launch<kUniformBF16>(out, n, start, s, lo, span, scale, st);
    case kNormalF32: return launch<kNormalF32>(out, n, start, s, lo, span, scale, st);
    case kNormalBF16: return launch<kNormalBF16>(out, n, start, s, lo, span, scale, st);
    case kGumbelF32: return launch<kGumbelF32>(out, n, start, s, lo, span, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One Gumbel-max step over d[0..n) (float32, n in [1, 2^32)): the index,
// an int64, into idx[0].  scratch is two zeroed 64-bit words; the launch
// leaves them zeroed.  One stream at a time may use a scratch.
extern "C" int chamjax_threefry_gumbel_argmax(const void* d, long long n,
                                              unsigned k0, unsigned k1,
                                              unsigned step, float lo,
                                              float span, void* scratch,
                                              void* idx, void* stream) {
  if (n < 1 || n > 0xFFFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for<kArgmaxSite>(gumbel_argmax_kernel, (n + kArgmaxRows - 1) / kArgmaxRows,
               &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  gumbel_argmax_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), n, k0, k1, step, 1u, lo, span,
      static_cast<unsigned long long*>(scratch),
      static_cast<long long*>(idx));
  return static_cast<int>(cudaGetLastError());
}

// The argmax step's logit, log(max(d, 1e-30)) by CUDA's logf, over d[0..n)
// into out: the check that it is torch.log's on the card, bit for bit.
__global__ void logit_kernel(const float* __restrict__ d, long long n,
                             float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = logit(d[i]);
}

extern "C" int chamjax_threefry_logit(const void* d, long long n, void* out,
                                      void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  logit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
