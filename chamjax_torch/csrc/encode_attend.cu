// Bidirectional multi-head attention over a key-padded context, for Hopper
// (sm_90a): the attention of an encoder layer
// (chamjax_torch/ops/encode_attend.py::attend; plain version
// attend_reference, the arithmetic of models/transformer.py::_attn_full
// without the causal mask).
//
// It replaces no Pallas kernel: the JAX package's encoder attention is
// XLA's einsums, mask and softmax (chamjax/models/transformer.py,
// _attn_full).  For each row, head and query i,
//
// out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h, :] * scale)
//                   v[b, j, h, :]
// over the keys j < len[b] (one count a row, or none: all keys).  The
// scores come from tensor-core MMAs of the bfloat16 values with float32
// sums (a product of two bfloat16 values is exact in float32), the
// softmax is float32, the probabilities are rounded to bfloat16 for P.V as
// the plain version rounds them, P.V sums in float32, and the output is
// rounded to bfloat16 once.
//
// Bound on an H100 SXM: at EncDec-S's encoder (64 rows, 512 tokens, 8
// heads of 64) a layer reads q, k and v once and writes the output (4 x 32
// MB: 0.040 ms at 3.35 TB/s) and does 4 * 512 * 512 * 64 flops a row and
// head (34 GFLOP: 0.035 ms at 989 TFLOP/s bf16), so it sits near the
// ridge; its 134M exponentials take 0.035 ms more on the special-function
// units.  The plain chain writes and reads the (b, h, s, s) float32 scores
// several times over (0.54 GB each pass).
//
// Design against that bound:
// - One CTA, one warpgroup (4 warps), a (row, head, 64-query tile).  Q, K
//   and V are read in place from their strided (b, s, h, hd) views (the
//   chunks of one fused QKV product), 16 bytes a copy.
// - K and V stream through shared memory in tiles of 64 keys with
//   cp.async, two tiles in flight, in the 128-byte swizzled layout that
//   wgmma reads (each 128-byte row's 16-byte pieces permuted by the row's
//   index mod 8, which also keeps the copies free of bank conflicts).  No
//   key at or past a row's length is read: the tiles stop there, and the
//   last one's rows past it are zero-filled and their scores set to -inf.
// - S = Q K^T by wgmma (m64n64k16, Q and K from shared memory): the
//   tensor cores read each K tile once for all 64 queries.  The online
//   softmax (running max and sum in float32; p = 2^(s·c - max·c), c the
//   scale times log2(e), one FMA and one ex2 a score) keeps S in
//   registers; P, rounded to bfloat16 in registers, is the A operand of
//   P.V by wgmma (V from shared memory, transposed by the descriptor).
//   The scores never reach device memory.
// - The output goes through the Q tile's shared memory, so that each
//   query's heads are written as 16-byte pieces of a contiguous
//   (b, s, h, hd) tensor.
// - Four CTAs share an SM at hd 64 (41 KB of shared memory, registers held
//   to 128 a thread), so that one CTA's softmax overlaps another's MMAs.
//   On an H100 SXM (700 W) at EncDec-S's shape a layer takes 0.112 ms;
//   with 3 CTAs an SM (144 registers) 0.126, with 5 (96 registers and
//   spills) 0.122, with two warpgroups a CTA 0.117, with 128-key tiles
//   0.132, with three tiles in flight 0.126, and on mma.sync (16 or 32
//   queries a warp) 0.140-0.158.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 128;           // one warpgroup
constexpr int kBM = 64;                 // queries a CTA: wgmma's M
constexpr int kBN = 64;                 // keys a tile
constexpr int kStages = 2;              // tiles in flight
constexpr int kNTiles = kBN / 8;        // S: a thread's 8-key column tiles
constexpr int kGroup = 8 * 128;         // 8 rows of 128 bytes: the swizzle's
                                        // period, wgmma's stride byte offset
constexpr int kBlock = 64 * 128;        // a tile's 64 rows x 64 values: one
                                        // 128-byte column block

// a tile of 64 rows x HD values: HD / 64 column blocks of kBlock bytes
template <int HD>
struct Shape {
  static constexpr int kBlocks = HD / 64;
  static constexpr int kTile = kBlocks * kBlock;       // bytes
  static constexpr int kKSteps = HD / 16;              // S: k-steps
  static constexpr int kChunks = HD / 8;               // 16-byte pieces a row
  static constexpr int kPasses = kBM * kChunks / kThreads;
  static constexpr size_t kSmem =
      size_t(1 + 2 * kStages) * kTile + 1024;          // + alignment
};

struct Args {
  const __nv_bfloat16* q;     // (b, sq, h, hd): strides q_sb, q_ss, q_sh
  const __nv_bfloat16* k;     // (b, sk, h, hd)
  const __nv_bfloat16* v;     // (b, sk, h, hd)
  const void* len;            // keys held: len[row * len_sb], or null
  __nv_bfloat16* out;         // (b, sq, h, hd), contiguous
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int len_sb, len64, sq, sk, h;
  float scale;                // the score scale · log2(e): base-2 scores
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the byte offset of row r's 16-byte piece c in a tile: 128-byte swizzle,
// piece c % 8 of a column block's row r sits at (c ^ r) % 8
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * kBlock + r * 128 + (((c ^ r) & 7) << 4);
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     bool ok) {
  const int n = ok ? 16 : 0;      // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the copies this thread made are complete: make them visible to the
// tensor cores' reads of shared memory (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading byte offset (MN-major: between 64-value column blocks; unused
// K-major) and the stride byte offset (between groups of 8 rows)
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>(kGroup >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define CHAMJAX_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define CHAMJAX_D32_OUT(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory)
//                       . B (16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CHAMJAX_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CHAMJAX_D32_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers)
//                     . B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float* d, const unsigned* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CHAMJAX_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CHAMJAX_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// 2^x on the special-function unit (a result below 2^-126 is 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 4 : 1)
encode_attend_kernel(const Args a) {
  using S = Shape<HD>;
  extern __shared__ unsigned char sm_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const unsigned base = (smem_addr(sm_raw) + 1023u) & ~1023u;
  unsigned char* sm = sm_raw + (base - smem_addr(sm_raw));
  const unsigned sq = base;                       // the Q tile, then out
  const unsigned sk = base + S::kTile;            // kStages K tiles
  const unsigned sv = sk + kStages * S::kTile;    // kStages V tiles

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;
  const int row = blockIdx.z, head = blockIdx.y;
  const int q0 = blockIdx.x * kBM;

  int n = a.sk;                             // the keys this row holds
  if (a.len) {
    const long long at = static_cast<long long>(row) * a.len_sb;
    const long long held =
        a.len64 ? static_cast<const long long*>(a.len)[at]
                : static_cast<const int*>(a.len)[at];
    n = static_cast<int>(min(max(held, 0LL), static_cast<long long>(a.sk)));
  }
  const int ntiles = (n + kBN - 1) / kBN;

  const __nv_bfloat16* qb = a.q + row * a.q_sb + head * a.q_sh;
  const __nv_bfloat16* kb = a.k + row * a.k_sb + head * a.k_sh;
  const __nv_bfloat16* vb = a.v + row * a.v_sb + head * a.v_sh;

  // the query tile joins the first key tile's copy group
#pragma unroll
  for (int i = 0; i < S::kPasses; ++i) {
    const int c = t + i * kThreads;
    const int r = c / S::kChunks, part = c % S::kChunks;
    const bool ok = q0 + r < a.sq;
    cp16(sq + swz(r, part), qb + (ok ? q0 + r : 0) * a.q_ss + part * 8, ok);
  }
  auto load_tile = [&](int it) {
    const unsigned dk = sk + (it % kStages) * S::kTile;
    const unsigned dv = sv + (it % kStages) * S::kTile;
    const int first = it * kBN;
#pragma unroll
    for (int i = 0; i < S::kPasses; ++i) {
      const int c = t + i * kThreads;
      const int r = c / S::kChunks, part = c % S::kChunks;
      const bool ok = first + r < n;
      const long long at = ok ? first + r : 0;
      cp16(dk + swz(r, part), kb + at * a.k_ss + part * 8, ok);
      cp16(dv + swz(r, part), vb + at * a.v_ss + part * 8, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < ntiles) load_tile(st);
    cp_commit();
  }

  // a thread's accumulators hold rows 16·warp + g (e = 0, 1) and
  // 16·warp + g + 8 (e = 2, 3), columns 8j + 2·tig (+ 1) of each 8-column
  // tile j: element 4j + e
  float o[S::kBlocks][32];
#pragma unroll
  for (int cb = 0; cb < S::kBlocks; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // raw max, sum

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<kStages - 1>();
    fence_async_smem();
    __syncthreads();
    const unsigned tk = sk + (it % kStages) * S::kTile;
    const unsigned tv = sv + (it % kStages) * S::kTile;

    // S = Q K^T: 16 dims a step, 4 steps a 128-byte column block
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < S::kKSteps; ++ks) {
      const unsigned off = (ks / 4) * kBlock + (ks % 4) * 32;
      wgmma_ss(s, desc(sq + off, 16), desc(tk + off, 16), ks > 0);
    }
    wg_commit();
    wg_wait();

    // mask the keys past the row's length, then the online softmax
    const int first = it * kBN;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = first + 8 * j + 2 * tig + (e & 1);
        if (p >= n) s[4 * j + e] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a key of the row, so the max is finite: the first
    // tile's factor 2^-inf is 0
    const float c0 = exp2_ftz((m0 - mx0) * a.scale);
    const float c1 = exp2_ftz((m1 - mx1) * a.scale);
    const float z0 = mx0 * a.scale, z1 = mx1 * a.scale;
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int cb = 0; cb < S::kBlocks; ++cb) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        o[cb][4 * j] *= c0;
        o[cb][4 * j + 1] *= c0;
        o[cb][4 * j + 2] *= c1;
        o[cb][4 * j + 3] *= c1;
      }
    }
    unsigned pa[kBN / 16][4];                 // P as A fragments
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const float p0 = exp2_ftz(fmaf(s[4 * j], a.scale, -z0));
      const float p1 = exp2_ftz(fmaf(s[4 * j + 1], a.scale, -z0));
      const float p2 = exp2_ftz(fmaf(s[4 * j + 2], a.scale, -z1));
      const float p3 = exp2_ftz(fmaf(s[4 * j + 3], a.scale, -z1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: 16 keys a step, each of V's 64-value column blocks
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < S::kBlocks; ++cb) {
        wgmma_rs(o[cb], pa[kk], desc(tv + cb * kBlock + kk * 2 * kGroup,
                                     kBlock));
      }
    }
    wg_commit();
    wg_wait();
    __syncthreads();          // every warp done with this tile's buffers
    if (it + kStages < ntiles) load_tile(it + kStages);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();            // no copy or read of the Q tile in flight

  // each row's sum over the quad that holds it; 0/0 where the row holds
  // no key, as the plain version's softmax over -inf.  The output goes
  // through the Q tile's shared memory, in the same layout
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
  for (int cb = 0; cb < S::kBlocks; ++cb) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int piece = 8 * cb + j, within = 4 * tig;
      *reinterpret_cast<unsigned*>(sm + swz(ra, piece) + within) =
          pack_bf16(o[cb][4 * j] * r0, o[cb][4 * j + 1] * r0);
      *reinterpret_cast<unsigned*>(sm + swz(rb, piece) + within) =
          pack_bf16(o[cb][4 * j + 2] * r1, o[cb][4 * j + 3] * r1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S::kPasses; ++i) {
    const int c = t + i * kThreads;
    const int r = c / S::kChunks, part = c % S::kChunks;
    if (q0 + r < a.sq) {
      const long long at =
          ((static_cast<long long>(row) * a.sq + q0 + r) * a.h + head) * HD;
      *reinterpret_cast<uint4*>(a.out + at + part * 8) =
          *reinterpret_cast<const uint4*>(sm + swz(r, part));
    }
  }
}

template <int HD>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const cudaError_t err =
      chamjax::allow_smem<encode_attend_kernel<HD>>(Shape<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBM - 1) / kBM, a.h, b);
  encode_attend_kernel<HD><<<grid, kThreads, Shape<HD>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Strides in values (each head's hd values contiguous, 16-byte aligned);
// len: int32 (len64 = 0) or int64 counts, len_sb apart, or null.  Returns
// a cudaError_t (cudaErrorInvalidValue for a shape the kernel does not
// take).
extern "C" int chamjax_encode_attend(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh,
    const void* len, int len_sb, int len64, void* out, int b, int sq, int sk,
    int h, int hd, float scale, void* stream) {
  if (b < 0 || b > 65535 || sq < 0 || sk < 0 || h < 1 || h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || sq == 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               len,
               static_cast<__nv_bfloat16*>(out),
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               len_sb, len64, sq, sk, h, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return static_cast<int>(launch<64>(a, b, st));
    case 128: return static_cast<int>(launch<128>(a, b, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
