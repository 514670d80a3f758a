// Tiled ADC scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chamjax/ops/scan_seg_block.py::adc_scan_tiles
// (body _adc_block_kernel).  For every window w:
//
//   dist[w, r] = sum_j LUT[lut_idx[w]][j, codes_tiled[tile_idx[w]][j, r]]
//
// for r < lens[w], +inf beyond.  LUT rows are (m, 256) f32, or packed bf16
// pairs (m, 128) int32 (entry 2c in the low half, 2c+1 in the high half).
// Outputs: (bW, seg) f32, (bW, seg) bf16 (dist_bf16), or (bW, 2, 128) f32
// (lane_l1: per-lane min over the window's seg/128 row groups, then the
// winning group index as int32 bits).
//
// Bound on an H100 SXM (3.35 TB/s HBM; the adds are negligible next to the
// bytes): the bytes the windows need, counted once (benchmarks/bounds.py::
// tile_scan_bound).  On the flagship main path (b=128, 32 probes, lists of
// ~244 rows, packed LUTs) that is the referenced tiles' valid rows, the
// distinct LUT rows (8 KB each) and 12.6 MB of f32 output: ~0.013 ms.  It
// is bound by bytes.
//
// Design: the staged body of adc_scan_stage.cuh (read its note).  One CTA
// of 128 threads a window, cut into work items of at most 1024 columns (a
// seg 2048 or 4096 window is 2 or 4), through a two-slot ring in shared
// memory: the LUT row and the tile's code rows j = 0..m-1, columns [c0,
// round_up(len, 16)), are copied with 16-byte cp.async.cg, issued together
// before any wait, the next item's copies in flight while this one is
// summed from shared memory, 4 rows a thread, and written as one float4
// (or 4 bf16 in one 8-byte store).  Across windows, the 12 CTAs an SM
// holds overlap one window's copies with another's sums.
// Two measurement bodies (debug_ablate of the TPU kernel, used by
// chamjax_torch/benchmarks/kernel_roofline.py) stage the same LUT row and
// the whole tile (they ignore lens) and gather nothing: "copy" writes
// float(code[0, r]) and "nogather" the integer sum over j of code[j, r].
// The copies are asm volatile, so every byte is still copied without a
// sink; `never` must be 0.
//
// No read outside the data: each 16-byte copy is aligned and holds at least
// one byte of a row's [c0, c0 + n), n cut at lens[w] and at seg, so it lies
// inside codes_tiled's allocation (its blocks are 512-byte aligned); a LUT
// row is copied whole from 16-byte aligned luts (the wrapper checks it).
// Offsets are 64-bit.
//
// Tuning (NVIDIA H100 80GB HBM3, 700 W, medians of 3; PERF.md): one
// window a CTA, chunk 1024 columns, 128 threads, registers bounded to 12
// CTAs an SM (40).  At the flagship main path's shapes (packed LUTs, seg
// 512) that took 0.0232 ms; two windows a CTA 0.0252, 256 threads 0.0251,
// no register bound 0.0281, the earlier byte-load kernel 0.0289.  At seg
// 2048 (full tiles): 0.0857, 0.0915, 0.0892, 0.0849 and 0.1152 ms.  A
// second window a CTA doubles its shared memory (two LUT and two code
// slots: 33 KB instead of 16.6 KB packed at seg 512), so half as many CTAs
// fit on an SM, and more CTAs in flight hide the copies' latency better
// than a ring across windows inside one CTA.  The settings are constants
// of adc_scan_stage.cuh; benchmarks/scan_timing.py times them against an
// earlier csrc.
// SASS (chamjax_torch/benchmarks/sass_report.py --match adc_scan_tiles,
// nvcc 12.8, sm_90a): every staged body holds 17 LDGSTS.E.BYPASS.128 (the
// 16-byte copies), 3-5 LDG.E (the window's indices) and no LDG.E.U8; the
// earlier byte-load body held 15 LDG.E.U8 in its unrolled code loop and
// 29 LDG.E.128 + 29 STS.128 for the LUT row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan_stage.cuh"
#include "launch.cuh"

namespace {

using namespace chamjax_stage;

using LaunchFn = cudaError_t (*)(StageArgs, cudaStream_t);

template <bool kPacked>
LaunchFn pick(int out_mode, int body) {
  const bool bf16 = out_mode == kOutBF16;
  if (body == kBodyCopy) {
    if (bf16) return &launch_staged<kPacked, kOutBF16, kBodyCopy, false>;
    return &launch_staged<kPacked, kOutF32, kBodyCopy, false>;
  }
  if (body == kBodyNoGather) {
    if (bf16) return &launch_staged<kPacked, kOutBF16, kBodyNoGather, false>;
    return &launch_staged<kPacked, kOutF32, kBodyNoGather, false>;
  }
  if (bf16) return &launch_staged<kPacked, kOutBF16, kBodyAdc, false>;
  if (out_mode == kOutLaneL1) {
    return &launch_staged<kPacked, kOutLaneL1, kBodyAdc, false>;
  }
  return &launch_staged<kPacked, kOutF32, kBodyAdc, false>;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; the launch goes on `stream` and does not synchronise.  `body`
// is 0 (the scan), 1 (copy) or 2 (nogather); the measurement bodies take no
// lane_l1 output.  `never` must be 0.  Returns a cudaError_t (0 = success).
extern "C" int chamjax_adc_scan_tiles(const void* codes_tiled,
                                      const void* tile_idx, const void* lens,
                                      const void* lut_idx, const void* luts,
                                      void* out, int bw, int m, int seg,
                                      int lut_bf16, int out_mode, int body,
                                      int never, void* stream) {
  if (bw <= 0 || m <= 0 || seg <= 0 || seg % kLanes || body < 0 ||
      body > kBodyNoGather || (body != kBodyAdc && out_mode == kOutLaneL1) ||
      never) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StageArgs a{};
  a.codes = static_cast<const uint8_t*>(codes_tiled);
  a.where = static_cast<const int32_t*>(tile_idx);
  a.lens = static_cast<const int32_t*>(lens);
  a.lut_idx = static_cast<const int32_t*>(lut_idx);
  a.luts = static_cast<const uint32_t*>(luts);
  a.out = out;
  a.bw = bw;
  a.m = m;
  a.width = seg;
  LaunchFn go = lut_bf16 ? pick<true>(out_mode, body)
                         : pick<false>(out_mode, body);
  return static_cast<int>(go(a, static_cast<cudaStream_t>(stream)));
}
