// Flat-layout ADC scans for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels that compute one function over the
// transposed flat code layout codes_t (m, n_cols) uint8:
//
//   chamjax/ops/scan_seg_multi.py::adc_scan_segments_multi (_adc_multi_kernel)
//   chamjax/ops/scan_seg.py::adc_scan_segments             (_adc_seg_kernel)
//   chamjax/ops/scan_pallas.py::adc_scan_distances         (_adc_kernel)
//
// For every window w (a (query, probe) pair for adc_scan_distances):
//
//   dist[w, r] = sum_j LUT[row(w)][j, codes_t[j, starts[w] + r]]
//
// for r < lens[w], +inf beyond; row(w) is lut_idx[w], or w itself for
// adc_scan_distances.  The window is `width` rows wide: seg (a multiple of
// 128, at most 4096) for the two segment scans, scan_len (a multiple of
// 1024) for adc_scan_distances.  LUT rows are (m, 256) f32, or packed bf16
// pairs (m, 128) int32 (entry 2c in the low half, 2c+1 in the high half).
// Outputs: (bW, width) f32, or (bW, 2, 128) f32 with lane_l1 (per-lane min
// over the window's width/128 row groups, then the winning group index as
// int32 bits; the first group wins ties).  The TPU kernels differ only in
// how their grid steps fetch windows (G windows per step, one, or chunks of
// one probe's list); on the card all three are this one kernel.
//
// Bound on an H100 SXM (3.35 TB/s HBM; the adds are negligible next to the
// bytes): the distinct code columns the windows read x m, the distinct LUT
// rows, the index arrays and the output (benchmarks/bounds.py::
// flat_scan_bound).  adc_scan_distances at bp=4096, scan_len=4096 writes
// 67 MB of distances, most of them +inf past short lists, so its output
// bytes bound it as much as its reads.  All are bound by bytes.
//
// Design: the staged body of adc_scan_stage.cuh (read its note), the same
// as adc_scan_tiles.cu's.  One CTA of 128 threads a window, cut into work
// items of at most 1024 columns (a scan_len 4096 window is 4), through a
// two-slot ring in shared memory.  The first item copies the window's LUT
// row; every item copies, with 16-byte cp.async.cg issued before any wait,
// the 16-byte-aligned pieces of each code row j that cover columns [start
// + c0, start + c0 + n): list starts are list_pad multiples, and with
// n_cols not a multiple of 16 each row has its own misalignment, so a
// thread joins two shared-memory words with __funnelshift_r where a row is
// not 4-byte aligned.  An item past the window's length copies nothing and
// writes +inf with 16-byte stores (most of adc_scan_distances' output).
//
// No read outside the data: n is cut at lens[w], at the width and at
// n_cols - start, and each 16-byte copy is aligned and holds at least one
// byte of [start + c0, start + c0 + n) of its row, so it lies inside
// codes_t's allocation (its blocks are 512-byte aligned); a window with a
// negative start or length copies nothing.  A LUT row is copied whole from
// 16-byte aligned luts (the wrappers check it).  Offsets are 64-bit
// (m * n_cols passes 2^31).
//
// Tuning (NVIDIA H100 80GB HBM3, 700 W, medians of 3; PERF.md): one
// window a CTA, chunk 1024 columns, 128 threads, registers bounded to 12
// CTAs an SM.  At the flagship's shapes (f32 LUTs) that / two windows a
// CTA / 256 threads / no register bound / the earlier byte-load kernel:
// adc_scan_segments_multi (probe-major windows of seg 512) 0.0346 / 0.0363
// / 0.0343 / 0.0349 / 0.0401 ms; adc_scan_distances at scan_len 1024
// 0.0369 / 0.0399 / 0.0368 / 0.0372 / 0.0425 ms, at scan_len 4096 over
// IVF1024-sized lists 0.0757 / 0.0852 / 0.0737 / 0.0723 / 0.0929 ms (chunk
// 512: 0.0768).  Two windows a CTA double its shared memory and halve the
// CTAs an SM holds; more CTAs in flight hide the copies better than a ring
// across windows inside one CTA.  benchmarks/scan_timing.py times the
// chosen setting against an earlier csrc.
// SASS (chamjax_torch/benchmarks/sass_report.py --match adc_scan_flat,
// nvcc 12.8, sm_90a): 17 LDGSTS.E.BYPASS.128, 5 LDG.E (indices), no
// LDG.E.U8 in each of the four instantiations; the earlier body held 15
// LDG.E.U8 in its unrolled code loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan_stage.cuh"
#include "launch.cuh"

namespace {

using namespace chamjax_stage;

int run(const void* codes_t, long long n_cols, const void* starts,
        const void* lens, const void* lut_idx, const void* luts, void* out,
        int bw, int m, int width, int lut_bf16, int lane_l1, void* stream) {
  if (bw <= 0 || m <= 0 || n_cols <= 0 || width <= 0 || width % kLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StageArgs a{};
  a.codes = static_cast<const uint8_t*>(codes_t);
  a.n_cols = n_cols;
  a.where = static_cast<const int32_t*>(starts);
  a.lens = static_cast<const int32_t*>(lens);
  a.lut_idx = static_cast<const int32_t*>(lut_idx);
  a.luts = static_cast<const uint32_t*>(luts);
  a.out = out;
  a.bw = bw;
  a.m = m;
  a.width = width;
  auto go = lut_bf16
      ? (lane_l1 ? launch_staged<true, kOutLaneL1, kBodyAdc, true>
                 : launch_staged<true, kOutF32, kBodyAdc, true>)
      : (lane_l1 ? launch_staged<false, kOutLaneL1, kBodyAdc, true>
                 : launch_staged<false, kOutF32, kBodyAdc, true>);
  return static_cast<int>(go(a, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All pointers are device
// pointers; each launch goes on `stream` and does not synchronise.  Each
// returns a cudaError_t (0 = success).

extern "C" int chamjax_adc_scan_segments_multi(
    const void* codes_t, long long n_cols, const void* starts,
    const void* lens, const void* lut_idx, const void* luts, void* out,
    int bw, int m, int seg, int lut_bf16, int lane_l1, void* stream) {
  if (seg > 4096) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes_t, n_cols, starts, lens, lut_idx, luts, out, bw, m, seg,
             lut_bf16, lane_l1, stream);
}

extern "C" int chamjax_adc_scan_segments(
    const void* codes_t, long long n_cols, const void* starts,
    const void* lens, const void* lut_idx, const void* luts, void* out,
    int bw, int m, int seg, int lut_bf16, void* stream) {
  if (seg > 4096) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes_t, n_cols, starts, lens, lut_idx, luts, out, bw, m, seg,
             lut_bf16, 0, stream);
}

extern "C" int chamjax_adc_scan_distances(
    const void* codes_t, long long n_cols, const void* starts,
    const void* lens, const void* luts, void* out, int bp, int m,
    int scan_len, void* stream) {
  if (scan_len % 1024) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes_t, n_cols, starts, lens, nullptr, luts, out, bp, m,
             scan_len, 0, 0, stream);
}
