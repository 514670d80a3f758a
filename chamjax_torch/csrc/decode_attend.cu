// Single-query attention against a K/V history, for Hopper (sm_90a): the
// decode step's attention (chamjax_torch/ops/decode_attend.py::attend;
// plain version attend_reference).
//
// It replaces no Pallas kernel: the JAX package leaves this einsum, its
// mask and its softmax to XLA (chamjax/models/transformer.py:291-292).
// On the card the plain PyTorch version cast every cached position to
// float32, copied both einsums' operands into their layouts and ran the
// masked softmax as separate kernels, over all T positions whatever the
// number held.
//
// out[b, 0, h, :] = sum_j softmax_j(q[b, 0, h, :] . k[b, j, h, :] * scale)
//                   v[b, j, h, :]
// over the positions j < length[b] (length: a 0-d idx broadcast to every
// row, one cross_valid_len a row, or none: all T), and, where the current
// token's key and value are given (self_kv), over that one key too.
// Scores, softmax and the p.V sums are float32; K and V are read in their
// stored dtype (bfloat16 or float32) and the output is rounded to it once.
//
// Bound on an H100 SXM: bytes.  A held position costs 2·h·hd values read
// (K and V) against ~4·h·hd flops, about one flop a byte in bfloat16, far
// below the card's ~20 fp32 flops a byte.  At the Dec-S step (b 64, h 8,
// hd 64, bfloat16, 24 layers) a held position is 2 KiB a row; at 256 held
// positions on average a step reads 0.80 GB: 0.24 ms at 3.35 TB/s.
//
// Design against that bound:
// - A position's K (or V) for every head of one row is h·hd contiguous
//   values (1 KiB at Dec-S).  Each thread owns one 16-byte slice of it
//   (8 bfloat16 or 4 float32 values, the same slice of q held in
//   registers, pre-scaled by scale·log2(e)), and a CTA of up to 256
//   threads covers P = threads / (h·hd/8) positions a pass: neighbouring
//   threads read neighbouring addresses, whole rows at a time.  The
//   history is streamed with evict-first loads (__ldcs): it is read once.
// - The lanes that own one head's slices (a power of two, at most 32) sum the
//   dot product by xor shuffles; each keeps that head's online softmax
//   (running max, sum and its slice of the accumulator) in float32, two
//   positions a step with both rows' loads issued before either is used
//   (more in flight a thread, or 128-thread CTAs, measured no faster).
// - A row's held positions are split over a cluster of CTAs (8, 4, 2 or
//   1), each a run of whole passes.  The wrapper takes the most at which
//   every row's cluster is resident at once (chamjax_decode_attend_chunks,
//   the card's occupancy calculator): at b = 64 four, 256 CTAs, where
//   eight would leave two of the 64 clusters to a second wave and cost
//   30% more (H100 80GB HBM3, 700 W).  The split is computed on the
//   device from the row's length: the grid is fixed by the batch, the CUDA
//   graph captures it once, and positions at or past the length are never
//   read (a CTA with no positions loads nothing and only joins the
//   combine).
// - The combine stays on chip: each CTA folds its P partial states in
//   shared memory, then, after a cluster barrier, each CTA of the cluster
//   merges its share of the row's slices from every CTA's shared memory
//   (distributed shared memory), adds the current token (its score taken
//   by every CTA beside q's load, its value loaded during the fold), and
//   writes the output.  No scratch in device memory, no second launch, no
//   counters to reset.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChunks = 8;     // CTAs a row at most: one cluster
constexpr int kMaxThreads = 256;  // a CTA's threads
constexpr int kUnroll = 2;        // positions a thread loads before use

template <typename T>
struct Slice;

template <>
struct Slice<float> {
  static constexpr int n = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Slice<__nv_bfloat16> {
  static constexpr int n = 8;
  // bfloat16 is float32's top half: widening is a shift or a mask
  __device__ static void load(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 store(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct Args {
  const void* q;     // (b, 1, h, hd), rows q_sb values apart
  const void* k;     // (b, T, h, hd), rows k_sb and positions k_st apart
  const void* v;
  const void* kh;    // the current token's key and value, (b, 1, h, hd),
  const void* vh;    // or null
  const int* len;    // held positions: len[row * len_sb], or null: T
  void* out;         // (b, 1, h, hd), contiguous
  long long q_sb, k_sb, k_st, v_sb, v_st, kh_sb, vh_sb;
  int len_sb, T, h, hd;
  float scale;       // hd^-0.5 · log2(e): scores in base 2
};

// threads a CTA: whole passes of h·hd/n slices, a whole number of warps
inline int threads_for(int vecs) {
  int passes = kMaxThreads / vecs;
  while (passes > 0 && (passes * vecs) % 32) --passes;
  return passes * vecs;
}

// q . k over a head: each lane's slice, then an xor-shuffle sum over the
// lanes of the head (a power of two; every lane of the warp takes part)
template <int E>
__device__ __forceinline__ float head_dot(const float* qf, const float* kf,
                                          int lanes) {
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) d = fmaf(qf[e], kf[e], d);
  for (int off = lanes / 2; off > 0; off >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 4)
decode_attend_kernel(const Args a) {
  using S = Slice<T>;
  constexpr int E = S::n;
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunks = gridDim.x;            // the cluster: one row's CTAs
  const int row = blockIdx.y;
  const int width = a.h * a.hd;            // values a position
  const int vecs = width / E;              // 16-byte slices a position
  const int lanes = a.hd / E;              // slices a head
  const int passes = blockDim.x / vecs;    // positions a pass
  const int t = threadIdx.x;
  const int sub = t / vecs, vi = t % vecs, head = vi / lanes;
  const bool own = a.kh != nullptr;        // the current token's key

  const int held = a.len ? min(max(a.len[row * a.len_sb], 0), a.T) : a.T;
  const int step = passes * chunks;
  const int per = (held + step - 1) / step * passes;
  const int begin = min(rank * per, held);
  const int end = min(begin + per, held);

  // q's slice (scaled to base-2 scores) and the current token's score,
  // which every CTA keeps for the heads it merges
  const uint4 qv = __ldg(reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.q) + row * a.q_sb + vi * E));
  uint4 khv = make_uint4(0, 0, 0, 0);
  if (own) {
    khv = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.kh) + row * a.kh_sb + vi * E));
  }
  float qf[E];
  S::load(qv, qf);
#pragma unroll
  for (int e = 0; e < E; ++e) qf[e] *= a.scale;
  float self = -INFINITY;
  if (own) {
    float kf[E];
    S::load(khv, kf);
    self = head_dot<E>(qf, kf, lanes);
  }

  const T* kp = static_cast<const T*>(a.k) + row * a.k_sb + vi * E;
  const T* vp = static_cast<const T*>(a.v) + row * a.v_sb + vi * E;
  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // begin, end and passes are the CTA's own: every thread runs every
  // pass, so the shuffles see whole warps
  for (int base = begin; base < end; base += passes * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * passes + sub;
      ok[u] = p < end;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        kr[u] = __ldcs(reinterpret_cast<const uint4*>(kp + p * a.k_st));
        vr[u] = __ldcs(reinterpret_cast<const uint4*>(vp + p * a.v_st));
      }
    }
    float s[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[E];
      S::load(kr[u], kf);
      const float d = head_dot<E>(qf, kf, lanes);
      s[u] = ok[u] ? d : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    if (mx == -INFINITY) continue;         // nothing held in this pass
    const float c = exp2f(m - mx);
    l *= c;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= c;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = exp2f(s[u] - mx);    // 0 where not held
      float vf[E];
      S::load(vr[u], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = mx;
  }

  // the slice this thread merges (CTA r takes r, r + chunks, ...): the
  // current token's value, loaded while the CTAs fold and meet
  const int vo = rank + chunks * t;
  uint4 vhv = make_uint4(0, 0, 0, 0);
  if (own && vo < vecs) {
    vhv = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.vh) + row * a.vh_sb + vo * E));
  }

  // the CTA's P states a head folded into one: pass 0's slots and fin
  float* st_acc = sm;                        // [passes][width]
  float* st_m = sm + passes * width;         // [passes][h]
  float* st_l = st_m + passes * a.h;         // [passes][h]
  float* fin = st_l + passes * a.h;          // [3][h]: max, sum, own score
#pragma unroll
  for (int e = 0; e < E; ++e) st_acc[sub * width + vi * E + e] = acc[e];
  if (vi % lanes == 0) {
    st_m[sub * a.h + head] = m;
    st_l[sub * a.h + head] = l;
  }
  __syncthreads();
  if (sub == 0) {
    float mm = -INFINITY;
    for (int j = 0; j < passes; ++j) mm = fmaxf(mm, st_m[j * a.h + head]);
    float ll = 0.f, aa[E];
#pragma unroll
    for (int e = 0; e < E; ++e) aa[e] = 0.f;
    for (int j = 0; j < passes; ++j) {
      const float mj = st_m[j * a.h + head];
      if (mj == -INFINITY) continue;
      const float w = exp2f(mj - mm);
      ll = fmaf(st_l[j * a.h + head], w, ll);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        aa[e] = fmaf(st_acc[j * width + vi * E + e], w, aa[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) st_acc[vi * E + e] = aa[e];
    if (vi % lanes == 0) {
      fin[head] = mm;
      fin[a.h + head] = ll;
      fin[2 * a.h + head] = self;
    }
  }
  cluster.sync();

  // the cluster's merge: every CTA's state of the slice's head, then the
  // current token
  if (vo < vecs) {
    const int hh = vo / lanes;
    float mc[kMaxChunks];
    float mm = fin[2 * a.h + hh];            // -inf without a current token
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      mc[c] = c < chunks ? cluster.map_shared_rank(fin, c)[hh] : -INFINITY;
      mm = fmaxf(mm, mc[c]);
    }
    float ll = 0.f, aa[E];
#pragma unroll
    for (int e = 0; e < E; ++e) aa[e] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (mc[c] == -INFINITY) continue;
      const float w = exp2f(mc[c] - mm);
      ll = fmaf(cluster.map_shared_rank(fin, c)[a.h + hh], w, ll);
      const float4* ra = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sm, c) + vo * E);
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        const float4 r4 = ra[i];
        aa[4 * i] = fmaf(r4.x, w, aa[4 * i]);
        aa[4 * i + 1] = fmaf(r4.y, w, aa[4 * i + 1]);
        aa[4 * i + 2] = fmaf(r4.z, w, aa[4 * i + 2]);
        aa[4 * i + 3] = fmaf(r4.w, w, aa[4 * i + 3]);
      }
    }
    if (own) {
      const float w = exp2f(fin[2 * a.h + hh] - mm);
      float vf[E];
      S::load(vhv, vf);
      ll += w;
#pragma unroll
      for (int e = 0; e < E; ++e) aa[e] = fmaf(w, vf[e], aa[e]);
    }
    float o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = aa[e] / ll;   // 0/0: nothing held
    reinterpret_cast<uint4*>(static_cast<T*>(a.out) +
                             static_cast<long long>(row) * width)[vo] =
        S::store(o);
  }
  cluster.sync();     // the other CTAs' reads of this one's shared memory
}

// the kernel's block size and shared memory for a shape, or 0 threads for
// a shape it does not take
template <typename T>
void shape_for(int h, int hd, int* threads, size_t* smem) {
  constexpr int E = Slice<T>::n;
  *threads = 0;
  if (hd % E) return;
  const int vecs = h * hd / E, lanes = hd / E;
  if (lanes > 32 || (lanes & (lanes - 1)) || vecs > kMaxThreads) return;
  *threads = threads_for(vecs);
  const size_t passes = *threads / vecs;
  *smem = sizeof(float) * (passes * h * hd + 2 * passes * h + 3 * h);
}

template <typename T>
int launch(const Args& a, int b, int chunks, cudaStream_t stream) {
  int threads;
  size_t smem;
  shape_for<T>(a.h, a.hd, &threads, &smem);
  if (!threads || chunks < 1 || chunks > kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      chamjax::row_clusters(b, chunks, threads, smem, &cluster, stream);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, decode_attend_kernel<T>, a));
}

// the most CTAs a row (8, 4, 2, 1) at which every row's cluster is resident
// at once on this card
template <typename T>
int plan(int b, int h, int hd, int* chunks) {
  int threads;
  size_t smem;
  shape_for<T>(h, hd, &threads, &smem);
  if (!threads) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(chamjax::resident_chunks(
      decode_attend_kernel<T>, b, kMaxChunks, threads, smem, chunks));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in values; chunks: the CTAs a
// row, from chamjax_decode_attend_chunks.  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int chamjax_decode_attend(
    const void* q, long long q_sb, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st,
    const void* kh, long long kh_sb, const void* vh, long long vh_sb,
    const void* len, int len_sb, void* out, int b, int T, int h, int hd,
    int dtype, int chunks, float scale, void* stream) {
  if (b < 0 || b > 65535 || T < 0 || h < 1 || hd < 1 || !kh != !vh) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  Args a{q, k, v, kh, vh, static_cast<const int*>(len), out,
         q_sb, k_sb, k_st, v_sb, v_st, kh_sb, vh_sb,
         len_sb, T, h, hd, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, b, chunks, st);
    case 1: return launch<__nv_bfloat16>(a, b, chunks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the CTAs a row for b rows of h heads of hd on the current device
extern "C" int chamjax_decode_attend_chunks(int b, int h, int hd, int dtype,
                                            int* chunks) {
  if (b < 1 || h < 1 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return plan<float>(b, h, hd, chunks);
    case 1: return plan<__nv_bfloat16>(b, h, hd, chunks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
