// The staged ADC scan body shared by adc_scan_tiles.cu and adc_scan_flat.cu
// (each .cu still builds into its own library).
//
// For every window w of width `width` rows:
//
//   dist[w, r] = sum_j LUT[row(w)][j, code(w, j, r)]    for r < len(w)
//
// and +inf beyond.  The window's code row j is a byte row in device memory:
// base(w) + j * stride, where base/stride are a tile's (codes_tiled
// [tile_idx[w]], seg) or a flat window's (codes_t + starts[w], n_cols).
//
// Design (one CTA of 128 threads a window; registers for 12 CTAs an SM):
//
// - Work items.  The window is cut into column chunks of `chunk` rows (a
//   multiple of 128, at most 1024); an item is one chunk.
// - Staging.  An item's code bytes go into shared memory with 16-byte
//   cp.async.cg copies: for each code row j, the 16-byte-aligned chunks of
//   device memory that cover the item's valid columns [c0, c0 + n), n =
//   the rows of the chunk below len(w).  The window's LUT row goes the same
//   way with the first item.  Both are issued before any wait.
// - Ring.  One LUT slot and, where the window is more than one item, two
//   code slots: while item i is computed, item i+1's copies are in flight.
//   Across windows the overlap comes from the CTAs an SM holds at once: on
//   the card, more CTAs in flight beat a CTA that walks several windows
//   through its own ring (two LUT and two code slots halve the CTAs an SM
//   holds; PERF.md).  Slots are found by offset arithmetic, not
//   through an array of pointers (which the compiler kept on the stack).
// - Occupancy.  The second launch bound asks the registers to allow
//   kMinCtas CTAs an SM (40 registers at 128 threads, no spills), about
//   what shared memory allows at the flagship (13 packed); unbounded, the
//   compiler took 70-93 registers, 5-7 CTAs an SM.
// - Compute.  Thread t owns rows 4q..4q+3 for q = t, t + kThreads, ...: it
//   reads one 32-bit word of each staged code row j (four codes; a funnel
//   shift joins two words where the row is not 4-byte aligned in shared
//   memory), gathers four LUT entries from shared memory and keeps four
//   fp32 sums, summing over j = 0..m-1 in order.  It writes the four
//   distances as one float4 (f32) or one 8-byte store of four bf16.
//   lane_l1 puts the chunk's distances in shared memory and thread l takes
//   the strict minimum over the row groups of lane l (threads 0..127), so
//   the first group wins ties.
// - Empty work.  An item with no valid row copies nothing and writes +inf.
//
// No read outside the data: every 16-byte chunk copied is aligned and holds
// at least one byte of [base + j*stride + c0, ... + n), which lies inside
// the codes tensor (n is cut at len(w), at the window's width and, for the
// flat layout, at n_cols - start).  An aligned 16-byte chunk that holds one
// byte of an allocation lies inside that allocation's (512-byte aligned)
// block.  A LUT row is copied whole: it is m*1 KB (f32) or m*512 B
// (packed), 16-byte aligned (the wrappers check luts' alignment).  Offsets
// are 64-bit (m * n_cols passes 2^31).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chamjax_stage {

// The CTA's shape, chosen on the card (the times are in the .cu notes and
// PERF.md).
constexpr int kThreads = 128;   // threads a CTA, one window each
constexpr int kLanes = 128;
constexpr int kChunk = 1024;    // most columns a work item covers
constexpr int kMinCtas = 12;    // CTAs an SM the registers must allow

enum OutMode { kOutF32 = 0, kOutBF16 = 1, kOutLaneL1 = 2 };
enum Body { kBodyAdc = 0, kBodyCopy = 1, kBodyNoGather = 2 };

struct StageArgs {
  const uint8_t* codes;     // tiled (n_tiles, m, width) | flat (m, n_cols)
  int64_t n_cols;           // flat: code row stride; tiled: unused
  const int32_t* where;     // tiled: tile_idx; flat: starts
  const int32_t* lens;
  const int32_t* lut_idx;   // null: window w reads LUT row w
  const uint32_t* luts;
  void* out;
  int bw, m, width;
  int chunk, code_slots;    // set by launch_staged
};

struct Item {
  const uint8_t* addr;      // code row 0 at column c0 (valid only if n > 0)
  int64_t stride;           // bytes between code rows
  int c0, cw, n;            // first column, chunk width, valid rows
};

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

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared memory row stride of a staged code row: the chunk plus the up to
// 15 bytes of misalignment in front of it, rounded to 16.
__host__ __device__ __forceinline__ int code_row_bytes(int chunk) {
  return chunk + 16;
}

template <bool kFlat, int kBody>
__device__ __forceinline__ Item describe(const StageArgs& a, int64_t w,
                                         int c) {
  Item it;
  it.c0 = c * a.chunk;
  it.cw = min(a.chunk, a.width - it.c0);
  int64_t len;
  if constexpr (kFlat) {
    const int64_t start = a.where[w];
    int64_t n = a.lens[w];
    n = n < a.width ? n : a.width;
    n = n < a.n_cols - start ? n : a.n_cols - start;   // never past codes_t
    len = (start < 0 || n < 0) ? 0 : n;
    it.addr = len > 0 ? a.codes + start + it.c0 : a.codes;
    it.stride = a.n_cols;
  } else {
    // the measurement bodies ignore lens: every row is read and written
    len = kBody == kBodyAdc ? a.lens[w] : a.width;
    len = len < a.width ? len : a.width;
    it.addr = a.codes + static_cast<int64_t>(a.where[w]) * a.m * a.width +
              it.c0;
    it.stride = a.width;
  }
  const int64_t rest = len - it.c0;
  it.n = rest <= 0 ? 0 : static_cast<int>(rest < it.cw ? rest : it.cw);
  return it;
}

// Issue the item's code copies into `dst` (row stride `row_bytes`).
__device__ __forceinline__ void stage_codes(const Item& it, uint8_t* dst,
                                            int m, int row_bytes) {
  // 16-byte chunks a row needs: at most (n + 30) / 16 (15 bytes in front,
  // up to 15 behind)
  const int kmax = (it.n + 30) >> 4;
  for (int i = threadIdx.x; i < m * kmax; i += kThreads) {
    const int j = i / kmax;
    const int k = i - j * kmax;
    const uintptr_t p = reinterpret_cast<uintptr_t>(it.addr + j * it.stride);
    const uintptr_t lo = p & ~uintptr_t(15);
    const uintptr_t hi = (p + it.n + 15) & ~uintptr_t(15);
    if (lo + 16 * k < hi) {
      cp_async16(dst + j * row_bytes + 16 * k,
                 reinterpret_cast<const void*>(lo + 16 * k));
    }
  }
}

__device__ __forceinline__ void stage_lut(uint8_t* dst, const uint32_t* luts,
                                          int64_t row, int row_bytes) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(luts) + row * row_bytes;
  for (int i = threadIdx.x; i < row_bytes / 16; i += kThreads) {
    cp_async16(dst + 16 * i, src + 16 * i);
  }
}

template <bool kPacked, int kOut, int kBody, bool kFlat>
__global__ void __launch_bounds__(kThreads, kMinCtas)
adc_scan_staged_kernel(const StageArgs a) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  const int t = threadIdx.x;
  const int m = a.m;
  const int lut_bytes = m * (kPacked ? 128 : 256) * 4;
  const int row_bytes = code_row_bytes(a.chunk);
  // Slots, in order: the LUT row, one or two code slots, lane_l1's
  // distances.  Code slot s starts s * (its size, or 0 where there is one)
  // past the first.
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem);
  uint8_t* code0 = smem + lut_bytes;
  const int code_step = (a.code_slots - 1) * m * row_bytes;
  float* dist_s = reinterpret_cast<float*>(code0 + code_step + m * row_bytes);

  const int64_t w = blockIdx.x;
  const int n_items = (a.width + a.chunk - 1) / a.chunk;
  const float inf = __int_as_float(0x7f800000);

  // The first item brings the window's LUT row; an item with no valid row
  // copies nothing (nor do the items after it: n falls with c0).  The LUT
  // row's index is loaded with the window's start and length, before any
  // copy is issued: the copies clobber memory, so a load written after
  // them is issued after them, and the LUT copies would wait one more
  // memory latency (5-13% of the scan on an H100).
  const int64_t lut_row = a.lut_idx ? static_cast<int64_t>(a.lut_idx[w]) : w;
  Item cur = describe<kFlat, kBody>(a, w, 0);
  if (cur.n > 0) {
    stage_codes(cur, code0, m, row_bytes);
    stage_lut(smem, a.luts, lut_row, lut_bytes);
  }
  cp_async_commit();

  float best = inf;   // lane_l1: thread t holds lane t
  int best_g = 0;
  for (int i = 0; i < n_items; ++i) {
    Item nxt = cur;
    if (i + 1 < n_items) {
      nxt = describe<kFlat, kBody>(a, w, i + 1);
      if (nxt.n > 0) {
        stage_codes(nxt, code0 + ((i + 1) & 1) * code_step, m, row_bytes);
      }
    }
    cp_async_commit();
    cp_async_wait_prior();   // every group but the one just committed
    __syncthreads();

    const uint8_t* codes_s = code0 + (i & 1) * code_step;
    // misalignment of code row j in its staged slot: (addr + j*stride) % 16
    const int off0 = static_cast<int>(reinterpret_cast<uintptr_t>(cur.addr) &
                                      15);
    const int step = static_cast<int>(cur.stride & 15);
    for (int q = t; 4 * q < cur.cw; q += kThreads) {
      const int r = 4 * q;     // first of this thread's 4 rows in the chunk
      float acc[4] = {inf, inf, inf, inf};
      if (r < cur.n) {
        uint32_t isum[4] = {0, 0, 0, 0};
        acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
        int off = off0;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const uint32_t* row =
              reinterpret_cast<const uint32_t*>(codes_s + j * row_bytes);
          const int wi = (off >> 2) + q;
          uint32_t v = row[wi];
          if (off & 3) v = __funnelshift_r(v, row[wi + 1], 8 * (off & 3));
          off = (off + step) & 15;
          if constexpr (kBody == kBodyAdc) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[k] += lut_entry<kPacked>(lut, j, (v >> (8 * k)) & 0xFFu);
            }
          } else if constexpr (kBody == kBodyCopy) {
            if (j == 0) {
#pragma unroll
              for (int k = 0; k < 4; ++k) isum[k] = (v >> (8 * k)) & 0xFFu;
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) isum[k] += (v >> (8 * k)) & 0xFFu;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (kBody != kBodyAdc) acc[k] = static_cast<float>(isum[k]);
          if (r + k >= cur.n) acc[k] = inf;
        }
      }
      const int64_t o = w * a.width + cur.c0 + r;
      if constexpr (kOut == kOutLaneL1) {
        *reinterpret_cast<float4*>(dist_s + r) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else if constexpr (kOut == kOutBF16) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc[0], acc[1]);
        __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[2], acc[3]);
        uint2 v2;
        v2.x = *reinterpret_cast<uint32_t*>(&lo2);
        v2.y = *reinterpret_cast<uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) = v2;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    if constexpr (kOut == kOutLaneL1) {
      if (cur.n > 0) {
        __syncthreads();
        const int groups = t < kLanes ? cur.cw / kLanes : 0;
        for (int g = 0; g < groups; ++g) {
          const float v = dist_s[g * kLanes + t];
          if (v < best) {   // strict: the first group wins ties
            best = v;
            best_g = cur.c0 / kLanes + g;
          }
        }
      }
      if (i + 1 == n_items && t < kLanes) {
        float* o = static_cast<float*>(a.out) + w * 2 * kLanes;
        o[t] = best;
        o[kLanes + t] = __int_as_float(best_g);
      }
    }
    __syncthreads();   // item i's slots are free from here on
    cur = nxt;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Launch one CTA a window over a.bw windows.  A CTA gets only the code
// slots it can use (one where the window is one work item), so more CTAs
// fit on an SM.  Picks the widest chunk up to kChunk whose slots fit the
// card's shared memory, opts in above 48 KB, and returns the launch's
// error.
template <bool kPacked, int kOut, int kBody, bool kFlat>
cudaError_t launch_staged(StageArgs a, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t lut_bytes = static_cast<size_t>(a.m) * (kPacked ? 128 : 256) * 4;
  size_t smem = 0;
  a.chunk = 0;
  for (int chunk = kChunk < a.width ? kChunk : a.width; chunk >= kLanes;
       chunk -= kLanes) {
    const int code_slots = a.width > chunk ? 2 : 1;
    const size_t need =
        lut_bytes +
        code_slots * static_cast<size_t>(a.m) * code_row_bytes(chunk) +
        (kOut == kOutLaneL1 ? 4 * static_cast<size_t>(chunk) : 0);
    if (need <= static_cast<size_t>(limit)) {
      a.chunk = chunk;
      a.code_slots = code_slots;
      smem = need;
      break;
    }
  }
  if (!a.chunk) return cudaErrorInvalidValue;   // one LUT row does not fit
  auto kernel = adc_scan_staged_kernel<kPacked, kOut, kBody, kFlat>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(a.bw), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace chamjax_stage
