// The decode step of Kimi Delta Attention (KDA), for Hopper (sm_90a): the
// recurrence of a KDA layer of Kimi-Linear (models/kimi_linear.py;
// chamjax_torch/ops/kda_decode.py::step, plain version step_reference).
//
// It replaces no Pallas kernel: the JAX package has no linear-attention
// family.  Each (row, head) holds a state S of K x V = 128 x 128 float32,
// rows indexed by the key channel, columns by the value channel.  With the
// step's q, k, v (128 each, float32; q and k L2-normed), the per-channel
// decay alpha in (0, 1) and the gate beta in (0, 1):
//
//   S <- Diag(alpha) S
//   S <- S + beta k (v - S^T k)^T
//   o  = S^T q              (written in bfloat16)
//
// Bound on an H100 SXM: bytes.  A (row, head) reads and writes its 64 KB
// state once, against ~6 flops an element: 0.75 flops a byte.  At the
// Kimi-Linear-48B-A3B step (b 64, 32 heads, 20 KDA layers) a layer's state
// is 134 MB, 268 MB read and written: 80 us at 3.35 TB/s.
//
// Design against that bound: the columns of S are independent (column j
// needs k, q, alpha, its own v_j and its own S[:, j]), so one CTA takes
// one (row, head) whole and reads its state once into registers.  8 warps;
// warp w holds key rows 16w .. 16w + 15, lane l value columns 4l .. 4l + 3
// (one float4 a row: a warp reads 512 contiguous bytes a row).  The two
// sums over the key rows (S^T k before the update, S^T q after it) are a
// warp's partial sums over its 16 rows, then a sum over the 8 warps through
// shared memory.  The state is decayed, updated and written back from the
// same registers; q, k and alpha are read once into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kK = 128;                 // key channels: rows of S
constexpr int kV = 128;                 // value channels: columns of S
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kK / kWarps;      // key rows a warp (16)
static_assert(kV == 4 * 32, "a lane's float4 of columns spans V");

struct Args {
  float* state;               // (bh, 128, 128), contiguous
  const float* q;             // (bh, 128) each, contiguous
  const float* k;
  const float* v;
  const float* alpha;
  const float* beta;          // (bh)
  __nv_bfloat16* out;         // (bh, 128)
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float c, const float4& s) {
  acc.x = fmaf(c, s.x, acc.x);
  acc.y = fmaf(c, s.y, acc.y);
  acc.z = fmaf(c, s.z, acc.z);
  acc.w = fmaf(c, s.w, acc.w);
}

__global__ void __launch_bounds__(kThreads, 2)
kda_decode_kernel(const Args a) {
  __shared__ float sk[kK], sq[kK], sa[kK];
  __shared__ float4 red[kWarps][32];
  const long long bh = blockIdx.x;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;

  float4* S = reinterpret_cast<float4*>(a.state + bh * kK * kV);
  float4 s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) s[i] = S[(warp * kRows + i) * (kV / 4) + lane];
  if (t < kK) {
    sk[t] = a.k[bh * kK + t];
    sq[t] = a.q[bh * kK + t];
    sa[t] = a.alpha[bh * kK + t];
  }
  const float4 v = reinterpret_cast<const float4*>(a.v + bh * kV)[lane];
  const float beta = a.beta[bh];
  __syncthreads();

  // decay, and this warp's part of S^T k
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    const float al = sa[r];
    s[i].x *= al;
    s[i].y *= al;
    s[i].z *= al;
    s[i].w *= al;
    fma4(d, sk[r], s[i]);
  }
  red[warp][lane] = d;
  __syncthreads();
  float4 u = red[0][lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) add4(u, red[w][lane]);
  u.x = beta * (v.x - u.x);
  u.y = beta * (v.y - u.y);
  u.z = beta * (v.z - u.z);
  u.w = beta * (v.w - u.w);

  // the rank-1 update, written back; this warp's part of S^T q
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp * kRows + i;
    fma4(s[i], sk[r], u);
    S[r * (kV / 4) + lane] = s[i];
    fma4(o, sq[r], s[i]);
  }
  __syncthreads();            // every warp has read red for u
  red[warp][lane] = o;
  __syncthreads();
  if (warp == 0) {
    float4 acc = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) add4(acc, red[w][lane]);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const unsigned*>(&lo);
    packed.y = *reinterpret_cast<const unsigned*>(&hi);
    reinterpret_cast<uint2*>(a.out + bh * kV)[lane] = packed;
  }
}

}  // namespace

// One step of bh = rows x heads states in place; every pointer contiguous
// and 16-byte aligned (ops/kda_decode.py checks).  Returns a cudaError_t.
extern "C" int chamjax_kda_decode(void* state, const void* q, const void* k,
                                  const void* v, const void* alpha,
                                  const void* beta, void* out, int bh,
                                  void* stream) {
  if (bh < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0) return 0;
  const Args a{static_cast<float*>(state),
               static_cast<const float*>(q),
               static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const float*>(alpha),
               static_cast<const float*>(beta),
               static_cast<__nv_bfloat16*>(out)};
  kda_decode_kernel<<<bh, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
