// threefry2x32 draws for Hopper (sm_90a): the JAX PRNG on the card.
//
// There is no Pallas kernel to replace: on the TPU, XLA generates the
// threefry2x32 hash of jax.random (jax/_src/prng.py, the partitionable
// counters of _threefry_random_bits_partitionable) and the samplers around
// it (jax/_src/random.py: _uniform, _normal_real, _gumbel).  This kernel is
// their counterpart, so chamjax_torch draws the numbers chamjax draws from
// the same key: chamjax_torch/random.py::threefry_draw launches it, and
// threefry_draw_reference is its plain version.
//
// One thread an output.  Output i of a draw hashes the 64-bit counter
// start + i, split into its hi and lo words, under the key (k0, k1): 20
// rounds of threefry2x32 in registers (rotations by __funnelshift_l), then
// bits1 ^ bits2, written in one of these forms:
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
// erf_inv, log and log1p are XLA's own float32 CPU code (Giles' polynomial;
// Cephes' logf polynomial and log1p rational form), evaluated with the same
// fused multiply-adds (fmaf) and otherwise with _rn intrinsics, which nvcc
// never contracts, so a draw equals jax.random's on the CPU bit for bit.
// sqrtf and __fdiv_rn round correctly (no fast-math flags).
//
// Bound on an H100 SXM: integer work.  The hash is ~75 32-bit integer
// operations an output (20 rounds of add, funnel shift and xor, the key
// schedule, the counter), against at most 4 bytes written: at 64 integer
// lanes an SM a clock (half the float32 lanes) the card hashes ~2.2e11
// outputs a second, while 3.35 TB/s writes ~8.4e11 floats.  The smoke
// counts the kernel's integer and float instructions in its SASS
// (benchmarks/sass_report.py::alu_counts) and divides by those rates.
// Design against that bound: nothing is read, each output is written once
// by one thread, the rounds stay in registers, and a normal or gumbel adds
// float work on the float32 pipe beside the integer one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// bits1 ^ bits2 of threefry2x32 over counter (hi, lo) under key (k0, k1)
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
#define CHAMJAX_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r);      \
  x1 ^= x0;
#define CHAMJAX_ROUNDS_A \
  CHAMJAX_ROUND(13) CHAMJAX_ROUND(15) CHAMJAX_ROUND(26) CHAMJAX_ROUND(6)
#define CHAMJAX_ROUNDS_B \
  CHAMJAX_ROUND(17) CHAMJAX_ROUND(29) CHAMJAX_ROUND(16) CHAMJAX_ROUND(24)
  CHAMJAX_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  CHAMJAX_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  CHAMJAX_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  CHAMJAX_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  CHAMJAX_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef CHAMJAX_ROUNDS_B
#undef CHAMJAX_ROUNDS_A
#undef CHAMJAX_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// XLA's float32 log on the CPU (Cephes' logf)
__device__ __forceinline__ float xla_log(float x) {
  float t = fmaxf(x, 1.17549435e-38f);        // the least normal float
  const int bits = __float_as_int(t);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 0x7f), 1.0f);
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

template <int kForm>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(void* __restrict__ out, long long n,
                    unsigned long long start, uint32_t k0, uint32_t k1,
                    float lo, float span, float scale) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long c = start + static_cast<unsigned long long>(i);
  const uint32_t bits = threefry_xor(k0, k1, static_cast<uint32_t>(c >> 32),
                                     static_cast<uint32_t>(c));
  if (kForm == kBits32) {
    static_cast<uint32_t*>(out)[i] = bits;
  } else if (kForm == kBits16) {
    static_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(bits);
  } else if (kForm == kBits8) {
    static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(bits);
  } else if (kForm == kUniformF32) {
    static_cast<float*>(out)[i] = uniform_f32(bits, lo, span);
  } else if (kForm == kUniformBF16) {
    static_cast<__nv_bfloat16*>(out)[i] =
        __float2bfloat16_rn(uniform_bf16(bits, lo, span));
  } else if (kForm == kNormalF32) {
    const float r = __fmul_rn(1.41421356237309504880f,
                              xla_erf_inv(uniform_f32(bits, lo, span)));
    static_cast<float*>(out)[i] = __fmul_rn(r, scale);
  } else if (kForm == kNormalBF16) {
    const float e = bf16_round(xla_erf_inv(uniform_bf16(bits, lo, span)));
    const float r = bf16_round(__fmul_rn(e, 1.4140625f));   // bf16 sqrt(2)
    static_cast<__nv_bfloat16*>(out)[i] =
        __float2bfloat16_rn(__fmul_rn(r, scale));
  } else if (kForm == kGumbelF32) {
    static_cast<float*>(out)[i] =
        -xla_log(-xla_log(uniform_f32(bits, lo, span)));
  }
}

template <int kForm>
cudaError_t launch(void* out, long long n, unsigned long long start,
                   uint32_t k0, uint32_t k1, float lo, float span,
                   float scale, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  threefry_kernel<kForm><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(out, n, start, k0, k1, lo, span, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int chamjax_threefry(void* out, long long n,
                                unsigned long long start, unsigned k0,
                                unsigned k1, int form, float lo, float span,
                                float scale, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kBits32: return launch<kBits32>(out, n, start, k0, k1, lo, span, scale, s);
    case kBits16: return launch<kBits16>(out, n, start, k0, k1, lo, span, scale, s);
    case kBits8: return launch<kBits8>(out, n, start, k0, k1, lo, span, scale, s);
    case kUniformF32: return launch<kUniformF32>(out, n, start, k0, k1, lo, span, scale, s);
    case kUniformBF16: return launch<kUniformBF16>(out, n, start, k0, k1, lo, span, scale, s);
    case kNormalF32: return launch<kNormalF32>(out, n, start, k0, k1, lo, span, scale, s);
    case kNormalBF16: return launch<kNormalBF16>(out, n, start, k0, k1, lo, span, scale, s);
    case kGumbelF32: return launch<kGumbelF32>(out, n, start, k0, k1, lo, span, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* chamjax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
