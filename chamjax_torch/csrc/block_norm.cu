// The elementwise junctions of a transformer block, for Hopper (sm_90a):
// the residual add with the layernorm after it, and the FFN's bias with its
// GELU (chamjax_torch/ops/block_norm.py::add_ln and bias_gelu; plain
// versions add_ln_reference and bias_gelu_reference, which are
// models/transformer.py's arithmetic).
//
// It replaces no Pallas kernel: the JAX package leaves these chains to XLA,
// which fuses them (chamjax/models/transformer.py, _ln and _ffn).  On the
// card the plain PyTorch chain runs each op as its own kernel: a layernorm
// is about ten (the float32 cast, mean, variance, subtract, add eps, rsqrt,
// multiply, the cast back, scale, shift), and the FFN's bias, GELU, second
// bias and residual adds four more.
//
//   add_ln:    x_new = bf16(bf16(x + delta) + bias)       (either optional)
//              y     = bf16(bf16(bf16((x_new - mu) * rsqrt(var + eps))
//                                 * scale) + ln_bias)
//   bias_gelu: out   = bf16(gelu_tanh(bf16(g + b)))
//
// with mu and var (the population variance) in float32: the same three
// roundings as the chain, so only the order of the float32 sums differs
// from it (y within one bfloat16 ulp of its rounding of the normalised
// row); x_new and the GELU are bit-equal.  The GELU is PyTorch's tanh form
// written as PyTorch's CUDA kernel writes it (float32, tanhf).
//
// Bound on an H100 SXM: bytes at large row counts, launches at small ones.
// A row of d bfloat16 values costs a few flops a value.  At the encoder of
// an EncDec-S refill (32,768 rows of 512) an add_ln reads x and delta and
// writes x_new and y, 128 MB, ~38 us at 3.35 TB/s, where the chain made
// about eight float32 passes; at a decode step (64 rows) it moves 256 KB
// and its cost is its launch.
//
// Design: add_ln takes one warp a row, the row read once into registers as
// 16-byte vectors (8 bfloat16 values a lane, neighbouring lanes on
// neighbouring addresses), the two sums by xor shuffles within the warp,
// the outputs written from the same registers.  The width is a template
// parameter (d / 256 vectors a lane, 1 to 16: d up to 4096), so every
// index is static and the row stays in registers; a CTA takes 4 rows.
// bias_gelu needs no sum across a row: one thread a 16-byte vector, CTAs of
// 256 threads, so that a decode step's 64 rows of 2048 spread over 128 CTAs
// (one warp a row left each lane 64 GELUs in a chain, 5.1 us, where the
// plain chain's two launches took 5.4; NVIDIA H100 80GB HBM3, 700 W).
// Both grids cover the rows, so the two shapes differ in launch geometry
// alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 32;
constexpr int kPack = 8;                  // bfloat16 values a 16-byte vector
constexpr int kSpan = kLanes * kPack;     // columns a vector a lane covers
constexpr int kMaxVec = 16;               // widths up to 16 x 256 = 4096
constexpr int kWarps = 4;                 // rows a CTA
constexpr int kThreads = kWarps * kLanes;
constexpr int kGeluThreads = 256;         // bias_gelu: one vector a thread

struct AddLnArgs {
  const bf16* x;              // (rows, d), contiguous
  const bf16* delta;          // (rows, d) or null
  const bf16* bias;           // (d) or null
  const bf16* scale;          // (d)
  const bf16* ln_bias;        // (d)
  bf16* x_out;                // (rows, d), or null where x_new is x
  bf16* y;                    // (rows, d)
  long long rows;
  float eps;
};

struct BiasGeluArgs {
  const bf16* g;              // (rows, f), contiguous
  const bf16* b;              // (f)
  bf16* out;                  // (rows, f)
  long long vectors;          // rows * f / 8
  int row_vectors;            // f / 8
};

__device__ __forceinline__ void load8(const bf16* p, float (&f)[kPack]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kPack / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[kPack]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kPack / 2; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// a float32 value rounded to bfloat16 and back: one rounding of the chain
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// PyTorch's tanh GELU (aten/src/ATen/native/cuda/ActivationGeluKernel.cu),
// term for term: the constants rounded from double as there
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr double kSqrt2 = 1.41421356237309504880;      // M_SQRT2
  constexpr double k2SqrtPi = 1.12837916709551257390;    // M_2_SQRTPI
  constexpr float kBeta = kSqrt2 * k2SqrtPi * float(0.5);
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return float(0.5) * x * (float(1) + tanhf(inner));
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
add_ln_kernel(const AddLnArgs a) {
  constexpr int kD = kVec * kSpan;
  constexpr float kInvD = 1.f / kD;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kLanes;
  if (row >= a.rows) return;
  const int lane = threadIdx.x % kLanes;
  const long long base = row * kD;

  float v[kVec][kPack];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    load8(a.x + base + (j * kLanes + lane) * kPack, v[j]);
  }
  if (a.delta) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float t[kPack];
      load8(a.delta + base + (j * kLanes + lane) * kPack, t);
#pragma unroll
      for (int e = 0; e < kPack; ++e) v[j][e] = round_bf16(v[j][e] + t[e]);
    }
  }
  if (a.bias) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float t[kPack];
      load8(a.bias + (j * kLanes + lane) * kPack, t);
#pragma unroll
      for (int e = 0; e < kPack; ++e) v[j][e] = round_bf16(v[j][e] + t[e]);
    }
  }
  if (a.x_out) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      store8(a.x_out + base + (j * kLanes + lane) * kPack, v[j]);
    }
  }

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int e = 0; e < kPack; ++e) s += v[j][e];
  }
  const float mu = warp_sum(s) * kInvD;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      const float c = v[j][e] - mu;
      q += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) * kInvD + a.eps);

#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int col = (j * kLanes + lane) * kPack;
    float sc[kPack], sh[kPack], out[kPack];
    load8(a.scale + col, sc);
    load8(a.ln_bias + col, sh);
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      const float n = round_bf16((v[j][e] - mu) * rstd);
      out[e] = round_bf16(n * sc[e]) + sh[e];
    }
    store8(a.y + base + col, out);
  }
}

__global__ void __launch_bounds__(kGeluThreads)
bias_gelu_kernel(const BiasGeluArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kGeluThreads + threadIdx.x;
  if (i >= a.vectors) return;
  const int col = static_cast<int>(i % a.row_vectors) * kPack;
  float g[kPack], b[kPack];
  load8(a.g + i * kPack, g);
  load8(a.b + col, b);
#pragma unroll
  for (int e = 0; e < kPack; ++e) g[e] = gelu_tanh(round_bf16(g[e] + b[e]));
  store8(a.out + i * kPack, g);
}

template <int kVec>
cudaError_t launch_add_ln(const AddLnArgs& a, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((a.rows + kWarps - 1) / kWarps);
  add_ln_kernel<kVec><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// the instantiation of add_ln at width d (a multiple of 256 up to 4096)
cudaError_t add_ln_by_width(int d, const AddLnArgs& a, cudaStream_t st) {
  switch (d / kSpan) {
    case 1: return launch_add_ln<1>(a, st);
    case 2: return launch_add_ln<2>(a, st);
    case 3: return launch_add_ln<3>(a, st);
    case 4: return launch_add_ln<4>(a, st);
    case 5: return launch_add_ln<5>(a, st);
    case 6: return launch_add_ln<6>(a, st);
    case 7: return launch_add_ln<7>(a, st);
    case 8: return launch_add_ln<8>(a, st);
    case 9: return launch_add_ln<9>(a, st);
    case 10: return launch_add_ln<10>(a, st);
    case 11: return launch_add_ln<11>(a, st);
    case 12: return launch_add_ln<12>(a, st);
    case 13: return launch_add_ln<13>(a, st);
    case 14: return launch_add_ln<14>(a, st);
    case 15: return launch_add_ln<15>(a, st);
    case 16: return launch_add_ln<16>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

bool width_ok(int d) {
  return d > 0 && d % kSpan == 0 && d / kSpan <= kMaxVec;
}

}  // namespace

// add_ln over `rows` rows of width d; delta, bias and x_out may be null;
// every pointer contiguous and 16-byte aligned (ops/block_norm.py checks).
// Returns a cudaError_t.
extern "C" int chamjax_add_ln(const void* x, const void* delta,
                              const void* bias, const void* scale,
                              const void* ln_bias, void* x_out, void* y,
                              long long rows, int d, float eps,
                              void* stream) {
  if (rows < 0 || !width_ok(d) || rows / kWarps >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const AddLnArgs a{static_cast<const bf16*>(x),
                    static_cast<const bf16*>(delta),
                    static_cast<const bf16*>(bias),
                    static_cast<const bf16*>(scale),
                    static_cast<const bf16*>(ln_bias),
                    static_cast<bf16*>(x_out),
                    static_cast<bf16*>(y),
                    rows,
                    eps};
  return static_cast<int>(
      add_ln_by_width(d, a, static_cast<cudaStream_t>(stream)));
}

// bias_gelu over `rows` rows of width f; every pointer contiguous and
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int chamjax_bias_gelu(const void* g, const void* b, void* out,
                                 long long rows, int f, void* stream) {
  const long long vectors = rows * (f / kPack);
  if (rows < 0 || !width_ok(f) || vectors / kGeluThreads >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const BiasGeluArgs a{static_cast<const bf16*>(g),
                       static_cast<const bf16*>(b),
                       static_cast<bf16*>(out), vectors, f / kPack};
  const unsigned grid =
      static_cast<unsigned>((vectors + kGeluThreads - 1) / kGeluThreads);
  bias_gelu_kernel<<<grid, kGeluThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
