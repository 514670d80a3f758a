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
// - The kernel study's bodies (adc_scan_variants.cu; kLens = false: lens
//   is not read, every window is `width` rows).  Each changes one step of
//   the above and keeps the rest: the entry decode (kBodyDecode4,
//   kBodyNoDecode), the sum (kBodyNoSum), the code copy (kBodyNoDma: none;
//   kBodyContig: the whole (m, width) tile in one bulk copy completed on an
//   mbarrier; kBodyDmaOnly: copied, one row read), the code width
//   (kBodyI32: int32 codes, the chunk a quarter as wide so a slot keeps its
//   bytes), rows a thread (kBodyW4: four row quads kThreads quads apart,
//   its own register bound), a two-pass decode and reduce (kBodyMxu), the
//   output (kOutMin: lane_l1's pass, min only; kOutPermuted: out[w,
//   b*(width/4) + f] = dist(row 4f + b)).  The hooks are compile-time
//   branches: the production instantiations (kLens, kBodyAdc/Copy/
//   NoGather, kOutF32/BF16/LaneL1) must compile as if they were not there
//   (check sass_report.py and -Xptxas -v against the parent's build).
//
// No read outside the data: every 16-byte chunk copied is aligned and holds
// at least one byte of [base + j*stride + c0, ... + n), which lies inside
// the codes tensor (n is cut at len(w), at the window's width and, for the
// flat layout, at n_cols - start).  An aligned 16-byte chunk that holds one
// byte of an allocation lies inside that allocation's (512-byte aligned)
// block.  A LUT row is copied whole: it is m*1 KB (f32) or m*512 B
// (packed), 16-byte aligned (the wrappers check luts' alignment).
// kBodyContig copies one whole tile, m * width bytes from a 16-byte aligned
// tile start (width is a multiple of 128), inside codes_tiled (its wrapper
// checks the tile).  Offsets are 64-bit (m * n_cols passes 2^31).

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
constexpr int kMinCtasW4 = 8;   // kBodyW4's 16 sums: 64 registers

enum OutMode {
  kOutF32 = 0, kOutBF16 = 1, kOutLaneL1 = 2,
  kOutMin = 3, kOutPermuted = 4,             // the kernel study's
};
enum Body {
  kBodyAdc = 0, kBodyCopy = 1, kBodyNoGather = 2,
  // the kernel study's (the note above)
  kBodyDecode4 = 3, kBodyNoDecode = 4, kBodyNoSum = 5, kBodyDmaOnly = 6,
  kBodyNoDma = 7, kBodyI32 = 8, kBodyW4 = 9, kBodyMxu = 10, kBodyContig = 11,
};

// bodies that sum LUT entries over j, each with its entry decode
__host__ __device__ constexpr bool sums_entries(int body) {
  return body == kBodyAdc || body == kBodyDecode4 || body == kBodyNoDecode ||
         body == kBodyNoDma || body == kBodyI32 || body == kBodyContig;
}
// bytes a code takes in device and shared memory
__host__ __device__ constexpr int code_elem(int body) {
  return body == kBodyI32 ? 4 : 1;
}
// most columns a work item covers
__host__ __device__ constexpr int max_chunk(int body) {
  return body == kBodyW4 ? 2 * kChunk
         : body == kBodyMxu ? kChunk / 2
                            : kChunk / code_elem(body);
}
__host__ __device__ constexpr bool lane_pass(int out) {
  return out == kOutLaneL1 || out == kOutMin;
}

struct StageArgs {
  const uint8_t* codes;     // tiled (n_tiles, m, width) | flat (m, n_cols)
  int64_t n_cols;           // flat: code row stride (codes); tiled: unused
  const int32_t* where;     // tiled: tile_idx (!kLens: row starts, tile =
                            // start / width); flat: starts
  const int32_t* lens;
  const int32_t* lut_idx;   // null: window w reads LUT row w
  const uint32_t* luts;
  void* out;
  int bw, m, width;
  int chunk, code_slots;    // set by launch_staged
  int never;                // the study's sinks store only if non-zero: 0
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

// The entry a summing body adds: the scan's, or the study's 4-op decode
// (select the half, mask, shift) or raw packed word (no decode).
template <bool kPacked, int kBody>
__device__ __forceinline__ float body_entry(const uint32_t* __restrict__ lut,
                                            int j, uint32_t c) {
  if constexpr (kBody == kBodyDecode4) {
    const uint32_t v = lut[j * 128 + (c >> 1)];
    return __uint_as_float((((c & 1u) ? (v >> 16) : v) & 0xFFFFu) << 16);
  } else if constexpr (kBody == kBodyNoDecode) {
    return __uint_as_float(lut[j * 128 + (c >> 1)]);
  } else {
    return lut_entry<kPacked>(lut, j, c);
  }
}

// Codes of rows 4q..4q+3 of a staged row: one 32-bit word, four bytes (a
// funnel shift joins two words where the row is not 4-byte aligned).
__device__ __forceinline__ uint32_t quad_word(const uint8_t* row_s, int off,
                                              int q) {
  const uint32_t* row = reinterpret_cast<const uint32_t*>(row_s);
  const int wi = (off >> 2) + q;
  uint32_t v = row[wi];
  if (off & 3) v = __funnelshift_r(v, row[wi + 1], 8 * (off & 3));
  return v;
}

// kBodyI32: rows 4q..4q+3 of a staged int32 row (off is a multiple of 4):
// one 16-byte read where the row is 16-byte aligned, else four.
__device__ __forceinline__ uint4 quad_i32(const uint8_t* row_s, int off,
                                          int q) {
  if (!(off & 15)) return reinterpret_cast<const uint4*>(row_s)[q];
  const uint32_t* row = reinterpret_cast<const uint32_t*>(row_s + off);
  return make_uint4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                    row[4 * q + 3]);
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

// kBodyContig: one bulk copy (the TMA's non-tensor form) completed on an
// mbarrier.  A CTA launched alone is a cluster of one, so its shared
// addresses are shared::cluster addresses.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(bar), "r"(1)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* smem_dst,
                                          const void* gmem_src,
                                          unsigned bytes, unsigned bar) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n" ::"r"(bar),
      "r"(bytes), "r"(dst), "l"(gmem_src)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Shared memory row stride of a staged code row: the chunk plus the up to
// 15 bytes of misalignment in front of it, rounded to 16.
__host__ __device__ __forceinline__ int code_row_bytes(int chunk) {
  return chunk + 16;
}

template <bool kFlat, int kBody, bool kLens = true>
__device__ __forceinline__ Item describe(const StageArgs& a, int64_t w,
                                         int c) {
  constexpr int kElem = code_elem(kBody);
  Item it;
  it.c0 = c * a.chunk;
  it.cw = min(a.chunk, a.width - it.c0);
  int64_t len;
  if constexpr (kFlat) {
    const int64_t start = a.where[w];
    int64_t n;
    if constexpr (kLens) {
      n = a.lens[w];
    } else {
      n = a.width;
    }
    n = n < a.width ? n : a.width;
    n = n < a.n_cols - start ? n : a.n_cols - start;   // never past codes_t
    len = (start < 0 || n < 0) ? 0 : n;
    if constexpr (kElem == 1) {
      it.addr = len > 0 ? a.codes + start + it.c0 : a.codes;
    } else {
      it.addr = len > 0 ? a.codes + (start + it.c0) * kElem : a.codes;
    }
    it.stride = a.n_cols * kElem;
  } else {
    // the measurement bodies ignore lens: every row is read and written
    len = (kLens && kBody == kBodyAdc) ? a.lens[w] : a.width;
    len = len < a.width ? len : a.width;
    const int64_t tile = kLens ? static_cast<int64_t>(a.where[w])
                               : a.where[w] / a.width;
    it.addr = a.codes + tile * a.m * a.width + it.c0;
    it.stride = a.width;
  }
  const int64_t rest = len - it.c0;
  it.n = rest <= 0 ? 0 : static_cast<int>(rest < it.cw ? rest : it.cw);
  return it;
}

// Issue the item's code copies into `dst` (row stride `row_bytes`);
// kElem bytes a code.
template <int kElem = 1>
__device__ __forceinline__ void stage_codes(const Item& it, uint8_t* dst,
                                            int m, int row_bytes) {
  // 16-byte chunks a row needs: at most (n + 30) / 16 (15 bytes in front,
  // up to 15 behind)
  const int kmax = (it.n * kElem + 30) >> 4;
  for (int i = threadIdx.x; i < m * kmax; i += kThreads) {
    const int j = i / kmax;
    const int k = i - j * kmax;
    const uintptr_t p = reinterpret_cast<uintptr_t>(it.addr + j * it.stride);
    const uintptr_t lo = p & ~uintptr_t(15);
    const uintptr_t hi = (p + it.n * kElem + 15) & ~uintptr_t(15);
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

template <bool kPacked, int kOut, int kBody, bool kFlat, bool kLens = true>
__global__ void __launch_bounds__(kThreads,
                                  kBody == kBodyW4 ? kMinCtasW4 : kMinCtas)
adc_scan_staged_kernel(const StageArgs a) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  const int t = threadIdx.x;
  const int m = a.m;
  const int lut_bytes = m * (kPacked ? 128 : 256) * 4;
  // kBodyContig's tile lands as it lies in device memory, rows `width`
  // apart
  const int row_bytes = kBody == kBodyContig
                            ? a.width
                            : code_row_bytes(a.chunk * code_elem(kBody));
  // Slots, in order: the LUT row, one or two code slots, lane_l1's
  // distances (kBodyMxu: its decoded entries; kBodyContig: its mbarrier).
  // Code slot s starts s * (its size, or 0 where there is one) past the
  // first.
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
  Item cur = describe<kFlat, kBody, kLens>(a, w, 0);
  unsigned bar = 0;   // kBodyContig
  if constexpr (kBody == kBodyContig) {
    // one bulk copy of the whole tile; the barrier is set up before any
    // thread can wait on it
    bar = static_cast<unsigned>(__cvta_generic_to_shared(dist_s));
    if (t == 0) mbar_init(bar);
    __syncthreads();
    if (t == 0) bulk_copy(code0, cur.addr, m * a.width, bar);
    stage_lut(smem, a.luts, lut_row, lut_bytes);
  } else if (cur.n > 0) {
    if constexpr (kBody != kBodyNoDma) {
      stage_codes<code_elem(kBody)>(cur, code0, m, row_bytes);
    }
    stage_lut(smem, a.luts, lut_row, lut_bytes);
  }
  cp_async_commit();

  float best = inf;   // lane_l1: thread t holds lane t
  int best_g = 0;
  uint32_t lane_word = 0;   // kBodyDmaOnly: codes 4(t%32).. of code row 0
  uint32_t sink = 0;        // kBodyNoSum: the entries it does not sum
  for (int i = 0; i < n_items; ++i) {
    Item nxt = cur;
    if (i + 1 < n_items) {
      nxt = describe<kFlat, kBody, kLens>(a, w, i + 1);
      if (kBody != kBodyNoDma && nxt.n > 0) {
        stage_codes<code_elem(kBody)>(
            nxt, code0 + ((i + 1) & 1) * code_step, m, row_bytes);
      }
    }
    cp_async_commit();
    cp_async_wait_prior();   // every group but the one just committed
    __syncthreads();
    if constexpr (kBody == kBodyContig) mbar_wait(bar, 0);

    const uint8_t* codes_s = code0 + (i & 1) * code_step;
    // misalignment of code row j in its staged slot: (addr + j*stride) % 16
    const int off0 = static_cast<int>(reinterpret_cast<uintptr_t>(cur.addr) &
                                      15);
    const int step = static_cast<int>(cur.stride & 15);
    if constexpr (kBody == kBodyW4) {
      // four row quads a thread, kThreads quads apart: 16 sums at once
      const int nq = cur.cw >> 2;
      for (int q0 = t; q0 < nq; q0 += 4 * kThreads) {
        float acc[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = 0.f;
        int off = off0;
#pragma unroll 2
        for (int j = 0; j < m; ++j) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if (q0 + g * kThreads < nq) {
              const uint32_t v =
                  quad_word(codes_s + j * row_bytes, off, q0 + g * kThreads);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                acc[4 * g + k] +=
                    lut_entry<kPacked>(lut, j, (v >> (8 * k)) & 0xFFu);
              }
            }
          }
          off = (off + step) & 15;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int q = q0 + g * kThreads;
          if (q < nq) {
            *reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                       w * a.width + cur.c0 + 4 * q) =
                make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2],
                            acc[4 * g + 3]);
          }
        }
      }
    } else if constexpr (kBody == kBodyMxu) {
      // pass 1 decodes the item's entries into dist_s, (m, cw) f32; pass 2
      // sums them over m in order
      for (int q = t; 4 * q < cur.cw; q += kThreads) {
        int off = off0;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const uint32_t v = quad_word(codes_s + j * row_bytes, off, q);
          off = (off + step) & 15;
          *reinterpret_cast<float4*>(dist_s + j * cur.cw + 4 * q) =
              make_float4(lut_entry<kPacked>(lut, j, v & 0xFFu),
                          lut_entry<kPacked>(lut, j, (v >> 8) & 0xFFu),
                          lut_entry<kPacked>(lut, j, (v >> 16) & 0xFFu),
                          lut_entry<kPacked>(lut, j, v >> 24));
        }
      }
      __syncthreads();
      for (int q = t; 4 * q < cur.cw; q += kThreads) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const float4 e =
              *reinterpret_cast<const float4*>(dist_s + j * cur.cw + 4 * q);
          s4.x += e.x;
          s4.y += e.y;
          s4.z += e.z;
          s4.w += e.w;
        }
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                   w * a.width + cur.c0 + 4 * q) = s4;
      }
    } else {
      if constexpr (kBody == kBodyDmaOnly) {
        // out[w, r] = code[0, r % 128]: item 0 holds columns 0..127
        if (i == 0) lane_word = quad_word(codes_s, off0, t & 31);
      }
      for (int q = t; 4 * q < cur.cw; q += kThreads) {
        const int r = 4 * q;     // first of this thread's 4 rows in the chunk
        float acc[4] = {inf, inf, inf, inf};
        // dma_only's rows hold code[0, r % 128] whatever the window's length
        if (kBody == kBodyDmaOnly || r < cur.n) {
          uint32_t isum[4] = {0, 0, 0, 0};
          acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
          int off = off0;
#pragma unroll 4
          for (int j = 0; kBody != kBodyDmaOnly && j < m; ++j) {
            if constexpr (kBody == kBodyI32) {
              const uint4 c = quad_i32(codes_s + j * row_bytes, off, q);
              off = (off + step) & 15;
              acc[0] += lut_entry<false>(lut, j, c.x);
              acc[1] += lut_entry<false>(lut, j, c.y);
              acc[2] += lut_entry<false>(lut, j, c.z);
              acc[3] += lut_entry<false>(lut, j, c.w);
              continue;
            }
            uint32_t v;
            if constexpr (kBody == kBodyNoDma) {
              v = static_cast<uint32_t>(q * a.never);   // code 0, not folded
            } else {
              v = quad_word(codes_s + j * row_bytes, off, q);
            }
            off = (off + step) & 15;
            if constexpr (sums_entries(kBody)) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                acc[k] += body_entry<kPacked, kBody>(lut, j,
                                                     (v >> (8 * k)) & 0xFFu);
              }
            } else if constexpr (kBody == kBodyCopy) {
              if (j == 0) {
#pragma unroll
                for (int k = 0; k < 4; ++k) isum[k] = (v >> (8 * k)) & 0xFFu;
              }
            } else if constexpr (kBody == kBodyNoSum) {
              // L[0][c & 127] only; the other rows' entries feed the sink
              uint32_t e[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                e[k] = lut[j * 256 + ((v >> (8 * k)) & 127u)];
              }
              if (j == 0) {
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[k] = __uint_as_float(e[k]);
              } else {
                sink ^= e[0] ^ e[1] ^ e[2] ^ e[3];
              }
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) isum[k] += (v >> (8 * k)) & 0xFFu;
            }
          }
          if constexpr (kBody == kBodyDmaOnly) {
#pragma unroll
            for (int k = 0; k < 4; ++k) isum[k] = (lane_word >> (8 * k)) & 0xFFu;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (kBody == kBodyCopy || kBody == kBodyNoGather ||
                kBody == kBodyDmaOnly) {
              acc[k] = static_cast<float>(isum[k]);
            }
            if (kBody != kBodyDmaOnly && r + k >= cur.n) acc[k] = inf;
          }
        }
        const int64_t o = w * a.width + cur.c0 + r;
        if constexpr (lane_pass(kOut)) {
          *reinterpret_cast<float4*>(dist_s + r) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else if constexpr (kOut == kOutBF16) {
          __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc[0], acc[1]);
          __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc[2], acc[3]);
          uint2 v2;
          v2.x = *reinterpret_cast<uint32_t*>(&lo2);
          v2.y = *reinterpret_cast<uint32_t*>(&hi2);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) =
              v2;
        } else if constexpr (kOut == kOutPermuted) {
          // out[w, b*(width/4) + f] = dist(row 4f + b): four stores, each
          // coalesced over the threads' f
          float* po = static_cast<float*>(a.out) + w * a.width +
                      (cur.c0 + r) / 4;
#pragma unroll
          for (int b = 0; b < 4; ++b) po[b * (a.width / 4)] = acc[b];
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
      }
    }
    if constexpr (lane_pass(kOut)) {
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
        if constexpr (kOut == kOutMin) {
          static_cast<float*>(a.out)[w * kLanes + t] = best;
        } else {
          float* o = static_cast<float*>(a.out) + w * 2 * kLanes;
          o[t] = best;
          o[kLanes + t] = __int_as_float(best_g);
        }
      }
    }
    __syncthreads();   // item i's slots are free from here on
    cur = nxt;
  }
  if constexpr (kBody == kBodyNoSum) {
    if (a.never) {
      static_cast<float*>(a.out)[w * a.width + t] = __uint_as_float(sink);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Launch one CTA a window over a.bw windows.  A CTA gets only the code
// slots it can use (one where the window is one work item), so more CTAs
// fit on an SM.  Picks the widest chunk up to max_chunk(kBody) whose slots
// fit the card's shared memory (kBodyContig: one item, the whole tile),
// opts in above 48 KB, and returns the launch's error.
template <bool kPacked, int kOut, int kBody, bool kFlat, bool kLens = true>
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
  if constexpr (kBody == kBodyContig) {
    const size_t need = lut_bytes + static_cast<size_t>(a.m) * a.width + 16;
    if (need <= static_cast<size_t>(limit)) {
      a.chunk = a.width;
      a.code_slots = 1;
      smem = need;
    }
  } else {
    constexpr int kMost = max_chunk(kBody);
    for (int chunk = kMost < a.width ? kMost : a.width; chunk >= kLanes;
         chunk -= kLanes) {
      const int code_slots = a.width > chunk ? 2 : 1;
      const size_t need =
          lut_bytes +
          code_slots * static_cast<size_t>(a.m) *
              code_row_bytes(chunk * code_elem(kBody)) +
          (lane_pass(kOut) ? 4 * static_cast<size_t>(chunk) : 0) +
          (kBody == kBodyMxu ? 4 * static_cast<size_t>(a.m) * chunk : 0);
      if (need <= static_cast<size_t>(limit)) {
        a.chunk = chunk;
        a.code_slots = code_slots;
        smem = need;
        break;
      }
    }
  }
  if (!a.chunk) return cudaErrorInvalidValue;   // one LUT row does not fit
  auto kernel = adc_scan_staged_kernel<kPacked, kOut, kBody, kFlat, kLens>;
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
