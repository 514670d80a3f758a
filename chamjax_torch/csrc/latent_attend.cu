// Single-query latent attention against a compressed cache, for Hopper
// (sm_90a): the decode step's attention of the DeepSeek-V3 block
// (chamjax_torch/ops/latent_attend.py::attend; plain version
// attend_reference), as models/mla_moe.py absorbs it, and of the
// latent-attention layers of Kimi-Linear (models/kimi_linear.py).
//
// It replaces no Pallas kernel: the JAX package has no latent-attention
// family.  Each cached position holds one latent of D = 576 values, the
// normed c_kv (512) and the k_pe (64), shared by every head.  The step's
// h <= 32 queries a row are [q_lat | q_pe] (576 each), and
//
// out[b, h, :] = sum_j softmax_j(q[b, h, :] . lat[b, j, :] * scale)
//                lat[b, j, :512]
// over the positions j < length[b] (a 0-d idx broadcast to every row, one
// count a row, or none: all T), and, where the current token's latent is
// given (self), over that one position too.  Scores, softmax and the sums
// are float32 (tensor-core MMA, bfloat16 operands: the probabilities are
// rounded to bfloat16 for P.V); the output is rounded to bfloat16 once.
//
// Bound on an H100 SXM: bytes.  A held position is 1152 bytes a row,
// read once for all heads, against 2·16·(576 + 512) = 34,816 flops: about
// 30 flops a byte.  The CUDA cores give ~20 fp32 flops a byte, so the 16
// heads run as the M = 16 of mma.sync.m16n8k16 on the tensor cores, where
// the work is ~1/6 of the time the bytes take.  At the Moonlight-16B-A3B
// step (b 64, 7168-7680 held, 27 layers) a step reads 14.8 GB of latents:
// 4.4 ms at 3.35 TB/s.
//
// Design against that bound:
// - A row's positions are split over a cluster of CTAs (8, 4, 2 or 1; the
//   most at which every row's cluster is resident at once, asked of the
//   card's occupancy calculator), as in decode_attend.cu.  The split is
//   computed on the device from the row's length, so the grid is fixed by
//   the batch and one CUDA graph captures it; no position at or past the
//   length is read.  The current token is the position after the last
//   held one.
// - The heads are MT tiles of 16 rows (MT = 1 up to 16 heads, 2 up to 32),
//   each the M = 16 of the MMA and each taken by a group of 4 warps; the
//   groups share the CTA's tiles, so a latent is read once for all heads.
//   MT = 1 is the kernel as it was written for 16 heads, instruction for
//   instruction (PERF.md).
// - A CTA of 4 warps a group streams tiles of 32 positions (32 x 1152 bytes) into
//   shared memory with cp.async, two tiles in flight, each row padded by
//   16 bytes so that ldmatrix reads no two rows from one bank.
// - S = Q K^T: each warp holds its quarter of the 576 dims of its group's
//   16 heads of Q
//   in registers as A fragments and takes the partial scores of all 32
//   positions; a group's four partials are summed through shared memory, and
//   every warp keeps the same online softmax (running max and sum in
//   float32).  P, in registers, is the A operand of P.V, and each warp
//   owns 128 of the 512 output columns (V is the first 512 values of the
//   tile already in shared memory: one read serves K and V).
// - The combine stays on chip: each CTA leaves its 16·MT x 512 state and
//   its max and sum in shared memory, and after a cluster barrier each CTA
//   merges 16·MT / cluster heads from every CTA's shared memory (distributed
//   shared memory) and writes them.  No scratch in device memory and no
//   second launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 576;                 // a latent: c_kv 512 + k_pe 64
constexpr int kDV = 512;                // the values: c_kv
constexpr int kMTile = 16;              // heads an M tile: the MMA's M
constexpr int kMaxMTiles = 2;           // heads a row at most: 32
constexpr int kTile = 32;               // positions a tile
constexpr int kStages = 2;              // tiles in flight
constexpr int kGroupWarps = 4;          // warps an M tile
constexpr int kPitch = kD + 8;          // a tile row in shared memory
constexpr int kKSteps = kD / kGroupWarps / 16;   // S: a warp's k-steps (9)
constexpr int kCols = kDV / kGroupWarps;    // P.V: a warp's output columns
constexpr int kNTiles = kCols / 8;      // ... in 8-column MMA tiles (16)
constexpr int kSRegs = kTile / 8 * 4;   // S: a lane's accumulators (16)
constexpr int kChunks16 = kD * 2 / 16;  // 16-byte pieces a position (72)
constexpr int kMaxChunks = 8;           // CTAs a row at most: one cluster

constexpr size_t kTileBytes = size_t(kTile) * kPitch * 2;

// the CTA of MT M tiles
template <int MT>
struct Cta {
  static constexpr int kM = kMTile * MT;         // heads a row at most
  static constexpr int kWarps = kGroupWarps * MT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr size_t kSmem = kStages * kTileBytes              // tiles
                                  + size_t(kWarps) * kSRegs * 32 * 4  // S partials
                                  + 2 * kM * 4;                     // max, sum
  static_assert(kM * kDV * 4 <= kStages * kTileBytes,
                "the final state fits in the tiles' room");
};

struct Args {
  const __nv_bfloat16* q;     // (b, h, 576): rows q_sb, heads q_sh apart
  const __nv_bfloat16* lat;   // (b, T, 576): rows lat_sb, positions lat_st
  const __nv_bfloat16* self;  // the current token's latent (b, 576), or null
  const int* len;             // held positions: len[row * len_sb], or null
  __nv_bfloat16* out;         // (b, h, 512), contiguous
  long long q_sb, q_sh, lat_sb, lat_st, self_sb;
  int len_sb, T, h;
  float scale;                // the score scale · log2(e): base-2 scores
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;      // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* c, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// two adjacent bf16 values of q (a head's row; 0 past the heads held)
__device__ __forceinline__ unsigned q_pair(const Args& a, int row, int head,
                                           int dim) {
  if (head >= a.h) return 0u;
  return __ldg(reinterpret_cast<const unsigned*>(
      a.q + row * a.q_sb + head * a.q_sh + dim));
}

template <int MT>
__global__ void __launch_bounds__(Cta<MT>::kThreads, MT == 1 ? 2 : 1)
latent_attend_kernel(const Args a) {
  constexpr int kM = Cta<MT>::kM;
  constexpr int kWarps = Cta<MT>::kWarps;
  constexpr int kThreads = Cta<MT>::kThreads;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(sm_raw);
  float* red = reinterpret_cast<float*>(sm_raw + kStages * kTileBytes);
  float* fin = red + kWarps * kSRegs * 32;      // [2][kM]: max, sum
  float* ofin = reinterpret_cast<float*>(sm_raw);   // [kM][kDV], at the end

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunks = gridDim.x;
  const int row = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;
  // this warp's M tile (its heads 16·grp ...) and place in the tile's group
  const int grp = MT == 1 ? 0 : warp / kGroupWarps;
  const int wq = MT == 1 ? warp : warp % kGroupWarps;
  const int hg = kMTile * grp;
  const bool own = a.self != nullptr;

  const int held = a.len ? min(max(a.len[row * a.len_sb], 0), a.T) : a.T;
  const int n = held + (own ? 1 : 0);        // the current token: held
  const int step = kTile * chunks;
  const int per = (n + step - 1) / step * kTile;
  const int begin = min(rank * per, n);
  const int end = min(begin + per, n);
  const int ntiles = (end - begin + kTile - 1) / kTile;

  const __nv_bfloat16* lat_row = a.lat + row * a.lat_sb;
  const __nv_bfloat16* self_row = own ? a.self + row * a.self_sb : lat_row;

  auto load_tile = [&](int it) {
    __nv_bfloat16* dst = tiles + (it % kStages) * (kTile * kPitch);
    const int base = begin + it * kTile;
#pragma unroll
    for (int i = 0; i < kTile * kChunks16 / kThreads; ++i) {
      const int c = t + i * kThreads;
      const int r = c / kChunks16, part = c % kChunks16;
      const int p = base + r;
      const bool ok = p < end;
      const __nv_bfloat16* src =
          (ok && p < held ? lat_row + p * a.lat_st : self_row) + part * 8;
      cp16(dst + r * kPitch + part * 8, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }

  // Q: this warp's 9 k-steps of A fragments (dims 144·wq ...)
  unsigned qa[kKSteps][4];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int d0 = (wq * kKSteps + s) * 16 + 2 * tig;
    qa[s][0] = q_pair(a, row, hg + g, d0);
    qa[s][1] = q_pair(a, row, hg + g + 8, d0);
    qa[s][2] = q_pair(a, row, hg + g, d0 + 8);
    qa[s][3] = q_pair(a, row, hg + g + 8, d0 + 8);
  }

  float o[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g+8

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* tile = tiles + (it % kStages) * (kTile * kPitch);

    // the partial scores of the 32 positions over this warp's dims
    float s[kSRegs];
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) s[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int d0 = (wq * kKSteps + ks) * 16;
#pragma unroll
      for (int jp = 0; jp < kTile / 16; ++jp) {
        unsigned b[4];
        const int pos = 16 * jp + 8 * (lane >> 4) + (lane & 7);
        ldsm4(b, tile + pos * kPitch + d0 + 8 * ((lane >> 3) & 1));
        mma(s + 8 * jp, qa[ks], b[0], b[1]);
        mma(s + 8 * jp + 4, qa[ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) red[(warp * kSRegs + i) * 32 + lane] = s[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kGroupWarps; ++w) {
        v += red[((kGroupWarps * grp + w) * kSRegs + i) * 32 + lane];
      }
      s[i] = v;
    }

    // mask, then the online softmax of rows g (e = 0, 1) and g + 8 (2, 3)
    const int base = begin + it * kTile;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = base + 8 * j + 2 * tig + (e & 1);
        float& v = s[4 * j + e];
        v = p < end ? v * a.scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with nothing held yet keeps max -inf: its p are all 0
    const float c0 = mx0 == -INFINITY ? 1.f : exp2f(m0 - mx0);
    const float c1 = mx1 == -INFINITY ? 1.f : exp2f(m1 - mx1);
    const float z0 = mx0 == -INFINITY ? 0.f : mx0;
    const float z1 = mx1 == -INFINITY ? 0.f : mx1;
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
    unsigned pa[kTile / 16][4];               // P as A fragments
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float p0 = exp2f(s[4 * j] - z0), p1 = exp2f(s[4 * j + 1] - z0);
      const float p2 = exp2f(s[4 * j + 2] - z1), p3 = exp2f(s[4 * j + 3] - z1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // P.V over this warp's 128 columns
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        unsigned b[4];
        const int pos = 16 * ks + 8 * ((lane >> 3) & 1) + (lane & 7);
        const int col = wq * kCols + 16 * jp + 8 * (lane >> 4);
        ldsm4_t(b, tile + pos * kPitch + col);
        mma(o[2 * jp], pa[ks], b[0], b[1]);
        mma(o[2 * jp + 1], pa[ks], b[2], b[3]);
      }
    }
    __syncthreads();          // every warp done with this tile and red
    if (it + kStages < ntiles) load_tile(it + kStages);
    cp_commit();
  }
  cp_wait<0>();

  // a row's sum over the quad that holds it
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();            // the tiles' room becomes the final state
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int col = wq * kCols + 8 * j + 2 * tig;
    ofin[(hg + g) * kDV + col] = o[j][0];
    ofin[(hg + g) * kDV + col + 1] = o[j][1];
    ofin[(hg + g + 8) * kDV + col] = o[j][2];
    ofin[(hg + g + 8) * kDV + col + 1] = o[j][3];
  }
  if (wq == 0 && tig == 0) {
    fin[hg + g] = m0;
    fin[hg + g + 8] = m1;
    fin[kM + hg + g] = l0;
    fin[kM + hg + g + 8] = l1;
  }
  cluster.sync();

  // the cluster's merge: this CTA's heads, from every CTA's state
  const int hp = kM / chunks;
  for (int i = t; i < hp * (kDV / 4); i += kThreads) {
    const int hh = rank * hp + i / (kDV / 4), c4 = i % (kDV / 4);
    float mc[kMaxChunks];
    float mm = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      mc[c] = c < chunks ? cluster.map_shared_rank(fin, c)[hh] : -INFINITY;
      mm = fmaxf(mm, mc[c]);
    }
    float ll = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (mc[c] == -INFINITY) continue;
      const float w = exp2f(mc[c] - mm);
      ll = fmaf(cluster.map_shared_rank(fin, c)[kM + hh], w, ll);
      const float4 r4 = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(ofin, c) + hh * kDV)[c4];
      acc[0] = fmaf(r4.x, w, acc[0]);
      acc[1] = fmaf(r4.y, w, acc[1]);
      acc[2] = fmaf(r4.z, w, acc[2]);
      acc[3] = fmaf(r4.w, w, acc[3]);
    }
    if (hh < a.h) {           // 0/0 where nothing is held, as decode_attend
      uint2 v;
      v.x = pack_bf16(acc[0] / ll, acc[1] / ll);
      v.y = pack_bf16(acc[2] / ll, acc[3] / ll);
      reinterpret_cast<uint2*>(a.out + (static_cast<long long>(row) * a.h +
                                        hh) * kDV)[c4] = v;
    }
  }
  cluster.sync();     // the other CTAs' reads of this one's shared memory
}

template <int MT>
int launch(const Args& a, int b, int chunks, cudaStream_t stream) {
  using C = Cta<MT>;
  if (C::kM % chunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = chamjax::allow_smem<latent_attend_kernel<MT>>(C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = chamjax::row_clusters(
      b, chunks, C::kThreads, C::kSmem, &cluster, stream);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, latent_attend_kernel<MT>, a));
}

template <int MT>
int resident(int b, int* chunks) {
  using C = Cta<MT>;
  cudaError_t err = chamjax::allow_smem<latent_attend_kernel<MT>>(C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(chamjax::resident_chunks(
      latent_attend_kernel<MT>, b, kMaxChunks, C::kThreads, C::kSmem,
      chunks));
}

}  // namespace

// Strides in values; chunks: the CTAs a row, from
// chamjax_latent_attend_chunks for the same h.  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int chamjax_latent_attend(
    const void* q, long long q_sb, long long q_sh, const void* lat,
    long long lat_sb, long long lat_st, const void* self, long long self_sb,
    const void* len, int len_sb, void* out, int b, int T, int h, int chunks,
    float scale, void* stream) {
  if (b < 0 || b > 65535 || T < 0 || h < 1 || h > kMTile * kMaxMTiles ||
      chunks < 1 || chunks > kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(lat),
               static_cast<const __nv_bfloat16*>(self),
               static_cast<const int*>(len),
               static_cast<__nv_bfloat16*>(out),
               q_sb, q_sh, lat_sb, lat_st, self_sb, len_sb, T, h, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return h <= kMTile ? launch<1>(a, b, chunks, st)
                     : launch<2>(a, b, chunks, st);
}

// the most CTAs a row (8, 4, 2, 1) at which every row's cluster is resident
// at once on the current device, for h heads
extern "C" int chamjax_latent_attend_chunks(int b, int h, int* chunks) {
  if (b < 1 || h < 1 || h > kMTile * kMaxMTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return h <= kMTile ? resident<1>(b, chunks) : resident<2>(b, chunks);
}
